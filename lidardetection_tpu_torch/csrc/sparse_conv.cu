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
//
// Design. One block owns 64 output rows (batch and row flattened) and up to
// 128 output channels; a tile with no valid row writes zeros and stops, so
// the padded tail of a fixed-capacity table costs a store and no product.
// The block stages its rulebook entries in shared memory as flat input rows
// (-1 for a miss, and for every entry of an invalid row). Then, for each
// kernel offset k and each chunk of 32 input channels, it stages the 64
// gathered input rows (zeros for a miss) and the chunk of W[k] in shared
// memory as f32 and every thread adds the products into its 4 x TN
// register tile (rows ty + 16 i, columns tx + 16 j). bf16 products are
// exact in f32, so the result is the exact products summed in f32, in the
// order k, then channel.
//
// What bounds it on the H100: by the roofline the f32 form is bound by
// its operations (2 * hits * C_in * C_out on the f32 units) and the bf16
// form by memory bytes (rulebook, input rows and weights read once, output
// written once). This version is far from either: it multiplies on the f32
// FMA units out of shared memory, stages the misses as zeros and multiplies
// them too. Tensor-core products, asynchronous staging and skipping
// offsets that miss for a whole tile are left for later.
//
// C interface, loaded with ctypes: rulebook_conv_launch returns the CUDA
// error code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_M = 64;    // output rows per block
constexpr int THREADS = 256;  // 16 column groups (tx) x 16 row groups (ty)
constexpr int TM = 4;         // output rows per thread
constexpr int CK = 32;        // input channels staged per step
constexpr int KB = 32;        // kernel offsets whose entries are staged at once

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T, int TN>
__global__ void __launch_bounds__(THREADS)
rulebook_conv_kernel(const T* __restrict__ feats, const int* __restrict__ rb,
                     const T* __restrict__ w,
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
            const T* wk = w + static_cast<int64_t>(k0 + kk) * c_in * c_out;
            for (int c0 = 0; c0 < c_in; c0 += CK) {
                const int ck = min(CK, c_in - c0);
                __syncthreads();  // s_src is written; s_f, s_w are free
                for (int e = tid; e < TILE_M * ck; e += THREADS) {
                    const int r = e / ck, c = e - r * ck;
                    const int src = s_src[r][kk];
                    s_f[r][c] = src < 0 ? 0.0f : to_float(
                        feats[static_cast<int64_t>(src) * c_in + c0 + c]);
                }
                for (int e = tid; e < ck * CO; e += THREADS) {
                    const int c = e / CO, j = e - c * CO;
                    const int col = col0 + j;
                    s_w[c][j] = col < c_out ? to_float(
                        wk[static_cast<int64_t>(c0 + c) * c_out + col]) : 0.0f;
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

template <typename T, int TN>
cudaError_t launch(const void* feats, const void* rb, const void* w,
                   const void* valid, void* out, int64_t n_rows, int v_out,
                   int v_in, int n_k, int c_in, int c_out,
                   cudaStream_t stream) {
    const dim3 grid(static_cast<unsigned>((n_rows + TILE_M - 1) / TILE_M),
                    static_cast<unsigned>((c_out + 16 * TN - 1) / (16 * TN)));
    rulebook_conv_kernel<T, TN><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(feats), static_cast<const int*>(rb),
        static_cast<const T*>(w), static_cast<const uint8_t*>(valid),
        static_cast<float*>(out), n_rows, v_out, v_in, n_k, c_in, c_out);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_width(const void* feats, const void* rb, const void* w,
                             const void* valid, void* out, int64_t n_rows,
                             int v_out, int v_in, int n_k, int c_in, int c_out,
                             cudaStream_t stream) {
    // columns per thread: the least of 1, 2, 4, 8 that covers C_out with
    // 16 column groups; wider outputs take more blocks along grid.y
    if (c_out <= 16)
        return launch<T, 1>(feats, rb, w, valid, out, n_rows, v_out, v_in,
                            n_k, c_in, c_out, stream);
    if (c_out <= 32)
        return launch<T, 2>(feats, rb, w, valid, out, n_rows, v_out, v_in,
                            n_k, c_in, c_out, stream);
    if (c_out <= 64)
        return launch<T, 4>(feats, rb, w, valid, out, n_rows, v_out, v_in,
                            n_k, c_in, c_out, stream);
    return launch<T, 8>(feats, rb, w, valid, out, n_rows, v_out, v_in, n_k,
                        c_in, c_out, stream);
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
    const cudaError_t err = is_bf16
        ? launch_for_width<__nv_bfloat16>(feats, rb, w, valid, out, n_rows,
                                          v_out, v_in, n_k, c_in, c_out, s)
        : launch_for_width<float>(feats, rb, w, valid, out, n_rows, v_out,
                                  v_in, n_k, c_in, c_out, s);
    return static_cast<int>(err);
}
