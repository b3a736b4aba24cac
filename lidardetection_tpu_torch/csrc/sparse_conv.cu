// K3 rulebook_conv: the gather and product of a sparse 3D convolution, for
// Hopper (sm_90a).
//
// Replaces the three TPU kernels of lidardetection_tpu/ops/sparse_conv_tpu.py
// that share one contract: rulebook_conv_pallas_v3 (_rb_kernel_v3, the
// default), rulebook_conv_pallas_v2 (_rb_kernel_v2) and rulebook_conv_pallas
// (_rb_kernel):
//
//   out[b, o, :] = sum_k W[k]^T f[b, rb[b, o, k], :]
//
// f (B, V_in, C_in) and W (K, C_in, C_out) are bf16 or f32, rb (B, V_out, K)
// is int32 and an entry outside [0, V_in) is a miss that adds nothing;
// products are summed in f32 and out (B, V_out, C_out) is f32. An output
// row whose `valid` byte is 0 is written as zeros.
//
// The TPU kernels work on a transposed (B, C, V) table and turn the gather
// into one-hot matmuls over windows of it, which needs every rulebook
// column to ascend. None of that is carried over: a block here loads its
// rulebook entries and reads the input rows they name, whatever their order.
// What is kept is the contraction _rb_kernel_v3 ends with, W^T times the
// gathered rows, as an implicit GEMM over K x C_in.
//
// What bounds it on the H100: in bf16, memory bytes (the live rulebook
// rows, the input rows they name and the weights read once, the output
// written once); the products of the hits are 2 * hits * C_in * C_out, a
// few microseconds at the tensor-core rate. The kernel sits above that
// bound: its steps are bound by the instructions of staging and
// multiplying (every 128-row tile stages W[k] again, and the narrow layers
// do little work a step), not by waiting for memory.
//
// Design of the bf16 path (conv_mma_kernel). A block of 8 warps owns 128 output
// rows (batch and row flattened) and up to 128 output columns; wider outputs
// take more blocks along grid.y. It reads its tile's rulebook rows once,
// coalesced, into shared memory as flat input rows (-1 for a miss and for every
// entry of an invalid row), and each warp builds, by ballot, a hit mask per
// offset with one bit per 16-row fragment. An offset with no hit in the tile is
// skipped whole: no weight load, no gather, no product. Each step of the
// reduction is one (offset, chunk of up to 64 input channels); a ring of 3 to 8
// stages in shared memory (as many as leave room for two blocks an SM) holds,
// per step, the gathered rows and W[k]'s chunk in bf16, filled by cp.async in
// units of 16 bytes (8 or 4 where the row width or alignment does not allow 16,
// element by element for an odd width) while the steps ahead are multiplied. A
// fragment with no hit for the offset copies nothing and its warp skips the
// products; a miss inside a hitting fragment is a zero-fill copy, which reads
// no memory. Channel counts under a multiple of 16 are padded with zeros in
// shared memory. Products are mma.sync m16n8k16 bf16 with f32 accumulators in
// registers, A from the gathered rows by ldmatrix, B = W[k] (row-major C_in x
// C_out) by ldmatrix.trans; rows are padded by 16 bytes in shared memory so
// that the 8 rows of an ldmatrix fall in different banks. The epilogue writes
// 16-byte f32 stores (lanes exchange half a fragment) where C_out is a multiple
// of 4; a tile with no valid row writes zeros and stops. The summation order is
// fixed by the shape, so a run gives the same bits every time; it differs from
// the plain version's order, and the tensor cores' internal additions need not
// round to nearest, hence the 1e-4 of max|out| tolerance in the tests.
//
// The f32 path (conv_fma_kernel) keeps the first version's arithmetic: a
// block of 64 rows stages the gathered rows and W in f32 and adds exact
// f32 products on the FMA units, in the order offset, then channel; it is
// not on the models' main path, which computes in bf16.
//
// C interface, loaded with ctypes: rulebook_conv_launch returns the CUDA
// error code of the launch (0 on success).

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_sm90;

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int MMA_ROWS = 128;     // output rows per block, 16 per warp
constexpr int MMA_THREADS = 256;
constexpr int MMA_CK = 64;        // input channels per reduction step
constexpr int MMA_KC = 64;        // offsets whose rulebook entries are staged
constexpr int MMA_SMEM = 110 * 1024;  // so that two blocks fit on an SM
constexpr int MAX_STAGES = 8;

struct ConvLayout {
    int kc, ck_max, a_stride, b_stride, stage_elems, stage_off, stages, bytes;
};

// Shared memory: s_src [kc][128] int, s_mask [kc] int, s_act [kc + 1] int,
// s_base [128] int, then a ring of `stages` x (A [128][a_stride] + B [ck_max][b_stride])
// bf16: as many stages (3 to 8) as two blocks an SM leave room for, so
// that narrow layers keep more steps in flight.
__host__ __device__ inline ConvLayout conv_layout(int n_k, int c_in, int bn) {
    ConvLayout l;
    l.kc = n_k < MMA_KC ? n_k : MMA_KC;
    const int ck16 = (c_in + 15) / 16 * 16;
    l.ck_max = ck16 < MMA_CK ? ck16 : MMA_CK;
    l.a_stride = l.ck_max + 8;  // +16 bytes: ldmatrix rows in other banks
    l.b_stride = bn + 8;
    l.stage_elems = MMA_ROWS * l.a_stride + l.ck_max * l.b_stride;
    l.stage_off =
        ((l.kc * MMA_ROWS + 2 * l.kc + 1 + MMA_ROWS) * 4 + 127) / 128 * 128;
    const int fit = (MMA_SMEM - l.stage_off) / (l.stage_elems * 2);
    l.stages = fit < 3 ? 3 : fit > MAX_STAGES ? MAX_STAGES : fit;
    l.bytes = l.stage_off + l.stages * l.stage_elems * 2;
    return l;
}

template <int BN>
__global__ void __launch_bounds__(MMA_THREADS, 2)
conv_mma_kernel(const bf16* __restrict__ feats, const int* __restrict__ rb,
                const bf16* __restrict__ w, const uint8_t* __restrict__ valid,
                float* __restrict__ out, int64_t n_rows, int v_out, int v_in,
                int n_k, int c_in, int c_out, int vec_f, int vec_w) {
    extern __shared__ __align__(128) unsigned char smem[];
    const ConvLayout L = conv_layout(n_k, c_in, BN);
    int* s_src = reinterpret_cast<int*>(smem);
    int* s_mask = s_src + L.kc * MMA_ROWS;
    int* s_act = s_mask + L.kc;
    int* s_base = s_act + L.kc + 1;  // first flat input row of a row's sample
    bf16* s_stage = reinterpret_cast<bf16*>(smem + L.stage_off);

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * MMA_ROWS;
    const int col0 = blockIdx.y * BN;
    const int width = min(BN, c_out - col0);

    bool live = false;
    if (tid < MMA_ROWS) {
        const int64_t row = row0 + tid;
        live = row < n_rows && (valid == nullptr || valid[row] != 0);
        s_base[tid] = live ? static_cast<int>(row / v_out) * v_in : -1;
    }
    const bool any_live = __syncthreads_or(live);

    float acc[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    const int n_chunks = (c_in + MMA_CK - 1) / MMA_CK;
    for (int k0 = 0; any_live && k0 < n_k; k0 += L.kc) {
        const int kb = min(L.kc, n_k - k0);
        __syncthreads();  // the previous offsets' readers are done
        // the tile's rulebook rows, read once and in order, 8 loads a
        // thread in flight at once
        const int n_e = MMA_ROWS * kb;
        for (int e0 = 0; e0 < n_e; e0 += 8 * MMA_THREADS) {
            int v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int e = e0 + i * MMA_THREADS + tid;
                v[i] = -1;
                if (e < n_e) {
                    const int r = e / kb;
                    if (s_base[r] >= 0) v[i] = rb[(row0 + r) * n_k + k0 + e - r * kb];
                }
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int e = e0 + i * MMA_THREADS + tid;
                if (e < n_e) {
                    const int r = e / kb, kk = e - r * kb;
                    s_src[kk * MMA_ROWS + r] =
                        v[i] >= 0 && v[i] < v_in ? s_base[r] + v[i] : -1;
                }
            }
        }
        __syncthreads();
        // bit f of s_mask[kk]: fragment f (rows 16f..16f+15) hits offset kk
        for (int kk = warp; kk < kb; kk += MMA_THREADS / 32) {
            int bits = 0;
#pragma unroll
            for (int q = 0; q < MMA_ROWS / 32; ++q) {
                const unsigned h = __ballot_sync(
                    0xffffffffu, s_src[kk * MMA_ROWS + q * 32 + lane] >= 0);
                bits |= ((h & 0xffffu) ? 1 : 0) << (2 * q);
                bits |= ((h >> 16) ? 1 : 0) << (2 * q + 1);
            }
            if (lane == 0) s_mask[kk] = bits;
        }
        __syncthreads();
        if (tid == 0) {  // the offsets that hit somewhere in the tile
            int n = 0;
            for (int kk = 0; kk < kb; ++kk)
                if (s_mask[kk] != 0) s_act[n++] = kk;
            s_act[L.kc] = n;
        }
        __syncthreads();
        const int n_steps = s_act[L.kc] * n_chunks;

        auto issue = [&](int step) {
            bf16* a = s_stage + (step % L.stages) * L.stage_elems;
            bf16* b = a + MMA_ROWS * L.a_stride;
            const int kk = s_act[step / n_chunks];
            const int c0 = (step % n_chunks) * MMA_CK;
            const int ck = min(MMA_CK, c_in - c0);
            const int ckp = (ck + 15) / 16 * 16;
            const int fm = s_mask[kk];
            const bf16 zero = __float2bfloat16(0.0f);
            {  // the gathered rows: two threads a row
                const int r = tid >> 1, part = tid & 1;
                if ((fm >> (r >> 4)) & 1) {
                    const int src = s_src[kk * MMA_ROWS + r];
                    bf16* dst = a + r * L.a_stride;
                    copy_row_part(dst, feats + static_cast<int64_t>(max(src, 0))
                                  * c_in + c0, ck, vec_f, src >= 0, part, 2);
                    for (int c = ck + part; c < ckp; c += 2) dst[c] = zero;
                }
            }
            {  // W[k0 + kk] rows c0 .. c0 + ck, columns col0 .. col0 + width
                const int c = tid >> 2, part = tid & 3;
                if (c < ck) {
                    copy_row_part(b + c * L.b_stride,
                                  w + (static_cast<int64_t>(k0 + kk) * c_in + c0 + c)
                                  * c_out + col0, width, vec_w, true, part, 4);
                } else if (c < ckp) {
                    for (int j = part; j < BN; j += 4) b[c * L.b_stride + j] = zero;
                }
            }
        };

        auto compute = [&](int step) {
            const int kk = s_act[step / n_chunks];
            if (!((s_mask[kk] >> warp) & 1)) return;  // no hit in my rows
            const bf16* a = s_stage + (step % L.stages) * L.stage_elems;
            const bf16* b = a + MMA_ROWS * L.a_stride;
            const int ck = min(MMA_CK, c_in - (step % n_chunks) * MMA_CK);
            for (int ks = 0; ks < ck; ks += 16) {
                uint32_t af[4];
                ldmatrix_x4(af, a + (warp * 16 + (lane & 15)) * L.a_stride
                            + ks + ((lane >> 4) << 3));
#pragma unroll
                for (int nb = 0; nb < BN / 16; ++nb) {
                    if (nb * 16 >= width) break;
                    uint32_t bfr[4];
                    ldmatrix_x4_trans(bfr, b + (ks + (lane & 15)) * L.b_stride
                                      + nb * 16 + ((lane >> 4) << 3));
                    mma_bf16(acc[2 * nb], af, bfr[0], bfr[1]);
                    mma_bf16(acc[2 * nb + 1], af, bfr[2], bfr[3]);
                }
            }
        };

        for (int s = 0; s < L.stages - 1; ++s) {
            if (s < n_steps) issue(s);
            cp_async_commit();
        }
        for (int step = 0; step < n_steps; ++step) {
            cp_async_wait_n(L.stages - 2);
            __syncthreads();  // step's stage is in; step - 1's is free
            if (step + L.stages - 1 < n_steps) issue(step + L.stages - 1);
            cp_async_commit();
            compute(step);
        }
        cp_async_wait<0>();
    }

    // epilogue: rows g and g + 8 of my fragment, columns 2t, 2t + 1 of
    // each 8-column tile
    const int g = lane >> 2, t = lane & 3;
    const int64_t r_lo = row0 + warp * 16 + g;
    if (c_out % 4 == 0) {
        // lanes 2i and 2i + 1 swap halves: the even lane stores 4 columns
        // of row g, the odd lane 4 columns of row g + 8
        const bool odd = t & 1;
        const int64_t row = odd ? r_lo + 8 : r_lo;
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
            const float s0 = odd ? acc[nt][0] : acc[nt][2];
            const float s1 = odd ? acc[nt][1] : acc[nt][3];
            const float x0 = __shfl_xor_sync(0xffffffffu, s0, 1);
            const float x1 = __shfl_xor_sync(0xffffffffu, s1, 1);
            const int col = col0 + nt * 8 + 2 * (t & ~1);
            if (row < n_rows && col < c_out) {
                const float4 v = odd ? make_float4(x0, x1, acc[nt][2], acc[nt][3])
                                     : make_float4(acc[nt][0], acc[nt][1], x0, x1);
                *reinterpret_cast<float4*>(out + row * c_out + col) = v;
            }
        }
    } else {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int64_t row = r_lo + (j >> 1) * 8;
                const int col = col0 + nt * 8 + 2 * t + (j & 1);
                if (row < n_rows && col < c_out) out[row * c_out + col] = acc[nt][j];
            }
        }
    }
}

template <int BN>
cudaError_t launch_mma(const void* feats, const void* rb, const void* w,
                       const void* valid, void* out, int64_t n_rows, int v_out,
                       int v_in, int n_k, int c_in, int c_out,
                       cudaStream_t stream) {
    static int set_bytes[64] = {};
    const ConvLayout l = conv_layout(n_k, c_in, BN);
    const cudaError_t err =
        allow_dynamic_smem(conv_mma_kernel<BN>, l.bytes, set_bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>((n_rows + MMA_ROWS - 1) / MMA_ROWS),
                    static_cast<unsigned>((c_out + BN - 1) / BN));
    conv_mma_kernel<BN><<<grid, MMA_THREADS, l.bytes, stream>>>(
        static_cast<const bf16*>(feats), static_cast<const int*>(rb),
        static_cast<const bf16*>(w), static_cast<const uint8_t*>(valid),
        static_cast<float*>(out), n_rows, v_out, v_in, n_k, c_in, c_out,
        copy_unit(feats, c_in, 0), copy_unit(w, c_out, 0));
    return cudaGetLastError();
}

// ---- f32: FMA units ---------------------------------------------------------

constexpr int TILE_M = 64;    // output rows per block
constexpr int THREADS = 256;  // 16 column groups (tx) x 16 row groups (ty)
constexpr int TM = 4;         // output rows per thread
constexpr int CK = 32;        // input channels staged per step
constexpr int KB = 32;        // kernel offsets whose entries are staged at once

template <int TN>
__global__ void __launch_bounds__(THREADS)
conv_fma_kernel(const float* __restrict__ feats, const int* __restrict__ rb,
                const float* __restrict__ w,
                const uint8_t* __restrict__ valid,
                float* __restrict__ out, int64_t n_rows, int v_out,
                int v_in, int n_k, int c_in, int c_out) {
    constexpr int CO = 16 * TN;  // output channels per block
    __shared__ float s_f[TILE_M][CK + 1];  // +1: rows ty, ty+1 in other banks
    __shared__ float s_w[CK][CO];
    __shared__ int s_src[TILE_M][KB];

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TILE_M;
    const int col0 = blockIdx.y * CO;

    bool live = false;
    if (tid < TILE_M) {
        const int64_t row = row0 + tid;
        live = row < n_rows && (valid == nullptr || valid[row] != 0);
    }
    const bool any_live = __syncthreads_or(live);

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; any_live && k0 < n_k; k0 += KB) {
        const int kb = min(KB, n_k - k0);
        __syncthreads();  // the previous chunk's readers of s_src are done
        for (int e = tid; e < TILE_M * kb; e += THREADS) {
            const int r = e / kb, kk = e - r * kb;
            const int64_t row = row0 + r;
            int src = -1;
            if (row < n_rows && (valid == nullptr || valid[row] != 0)) {
                const int v = rb[row * n_k + k0 + kk];
                if (v >= 0 && v < v_in)
                    src = static_cast<int>(row / v_out) * v_in + v;
            }
            s_src[r][kk] = src;
        }
        for (int kk = 0; kk < kb; ++kk) {
            const float* wk = w + static_cast<int64_t>(k0 + kk) * c_in * c_out;
            for (int c0 = 0; c0 < c_in; c0 += CK) {
                const int ck = min(CK, c_in - c0);
                __syncthreads();  // s_src is written; s_f, s_w are free
                for (int e = tid; e < TILE_M * ck; e += THREADS) {
                    const int r = e / ck, c = e - r * ck;
                    const int src = s_src[r][kk];
                    s_f[r][c] = src < 0 ? 0.0f
                        : feats[static_cast<int64_t>(src) * c_in + c0 + c];
                }
                for (int e = tid; e < ck * CO; e += THREADS) {
                    const int c = e / CO, j = e - c * CO;
                    const int col = col0 + j;
                    s_w[c][j] = col < c_out
                        ? wk[static_cast<int64_t>(c0 + c) * c_out + col] : 0.0f;
                }
                __syncthreads();
                for (int c = 0; c < ck; ++c) {
                    float a[TM], b[TN];
#pragma unroll
                    for (int i = 0; i < TM; ++i) a[i] = s_f[ty + 16 * i][c];
#pragma unroll
                    for (int j = 0; j < TN; ++j) b[j] = s_w[c][tx + 16 * j];
#pragma unroll
                    for (int i = 0; i < TM; ++i)
#pragma unroll
                        for (int j = 0; j < TN; ++j)
                            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int64_t row = row0 + ty + 16 * i;
        if (row >= n_rows) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = col0 + tx + 16 * j;
            if (col < c_out) out[row * c_out + col] = acc[i][j];
        }
    }
}

template <int TN>
cudaError_t launch_fma(const void* feats, const void* rb, const void* w,
                       const void* valid, void* out, int64_t n_rows, int v_out,
                       int v_in, int n_k, int c_in, int c_out,
                       cudaStream_t stream) {
    const dim3 grid(static_cast<unsigned>((n_rows + TILE_M - 1) / TILE_M),
                    static_cast<unsigned>((c_out + 16 * TN - 1) / (16 * TN)));
    conv_fma_kernel<TN><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(feats), static_cast<const int*>(rb),
        static_cast<const float*>(w), static_cast<const uint8_t*>(valid),
        static_cast<float*>(out), n_rows, v_out, v_in, n_k, c_in, c_out);
    return cudaGetLastError();
}

}  // namespace

extern "C" int rulebook_conv_launch(const void* feats, const void* rb,
                                    const void* w, const void* valid,
                                    void* out, long long n_rows, int v_out,
                                    int v_in, int n_k, int c_in, int c_out,
                                    int is_bf16, void* stream) {
    if (n_rows < 1 || v_out < 1 || v_in < 1 || n_k < 1 || c_in < 1 ||
        c_out < 1 || (n_rows + TILE_M - 1) / TILE_M > 2147483647LL ||
        (n_rows / v_out + 1) * static_cast<long long>(v_in) > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    // output columns per block: the least of 16, 32, 64, 128 that covers
    // C_out (bf16) or of 16 column groups x 1, 2, 4, 8 (f32); wider outputs
    // take more blocks along grid.y
    if (is_bf16) {
        if (c_out <= 16)
            err = launch_mma<16>(feats, rb, w, valid, out, n_rows, v_out, v_in,
                                 n_k, c_in, c_out, s);
        else if (c_out <= 32)
            err = launch_mma<32>(feats, rb, w, valid, out, n_rows, v_out, v_in,
                                 n_k, c_in, c_out, s);
        else if (c_out <= 64)
            err = launch_mma<64>(feats, rb, w, valid, out, n_rows, v_out, v_in,
                                 n_k, c_in, c_out, s);
        else
            err = launch_mma<128>(feats, rb, w, valid, out, n_rows, v_out,
                                  v_in, n_k, c_in, c_out, s);
    } else {
        if (c_out <= 16)
            err = launch_fma<1>(feats, rb, w, valid, out, n_rows, v_out, v_in,
                                n_k, c_in, c_out, s);
        else if (c_out <= 32)
            err = launch_fma<2>(feats, rb, w, valid, out, n_rows, v_out, v_in,
                                n_k, c_in, c_out, s);
        else if (c_out <= 64)
            err = launch_fma<4>(feats, rb, w, valid, out, n_rows, v_out, v_in,
                                n_k, c_in, c_out, s);
        else
            err = launch_fma<8>(feats, rb, w, valid, out, n_rows, v_out, v_in,
                                n_k, c_in, c_out, s);
    }
    return static_cast<int>(err);
}
