// K4 rulebook_conv_dw: the weight gradient of the sparse 3D convolution, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel rulebook_conv_dw_pallas (_dw_kernel) of
// lidardetection_tpu/ops/sparse_conv_tpu.py:
//
//   dW[k, c, d] = sum_{b, o} f[b, rb[b, o, k], c] * g[b, o, d]
//
// f (B, V_in, C) and g (B, V_out, Co) are bf16 or f32 (one type for both),
// rb (B, V_out, K) is int32 and an entry outside [0, V_in) is a miss that
// adds nothing; an output row whose `valid` byte is 0 adds nothing either.
// Products are summed in f32 and dW (K, C, Co) is f32.
//
// The TPU kernel reuses the forward kernel's z-grouped windows over a
// transposed table, builds a one-hot matrix per window to gather with the
// MXU, routes the window DMAs, and accumulates dW across a sequential grid;
// all of that exists because XLA:TPU cannot gather rows, and it needs every
// rulebook column to ascend. None of it is carried over: a block here reads
// f[rb[o, k]] by index, whatever the rulebook's order.
//
// What bounds it on the H100: in bf16, memory bytes (the rulebook, the live
// rows of f and g read once, dW written once); the products of the hits,
// 2 * hits * C * Co, take a few microseconds at the tensor-core rate. The
// kernel sits well above that bound, and neither its products nor its row
// copies set its time: a build without either ran about as long. What does
// is what every block pays whatever its hits: walking its split's column of
// the rulebook, starting its pipeline, writing its partial tile, and the
// second kernel that adds the partials.
//
// Design. The grid is (row split s, kernel offset k, C x Co tile). The host
// picks the number of splits S from the shape alone (ops/sparse_conv_cuda.py
// dw_split_plan): as many as a workspace of at most 16 MB and 512 rows a
// split allow, up to eight blocks an SM. So the workspace no longer grows
// with the row count, the block that holds the centre offset of a
// submanifold layer (a hit on every live row of its split) stays short, and
// K = 3 (conv_out) gets its row split. Split s takes the groups of 4
// consecutive rows s, s + S, s + 2S, ..., so that the padding rows at the end
// of each sample (a quarter to two thirds of a layer's table) spread evenly
// over the splits. A block of 4 warps walks its split in windows of 512
// rows, 4 consecutive rows a thread, each thread reading rb[o, k] of its rows:
// one 32-byte sector a row and offset, so the K blocks of a split read the
// rulebook K times from L2 (a block that took the three offsets of one (kz,
// ky) kernel row read about 1.4 sectors for three entries, but ran slower:
// PERF.md). One block-wide scan a window lists the hits in row order into a
// ring in shared memory, the next window's entries being loaded meanwhile,
// and the block takes them from the ring in batches of 64, so a batch spans
// windows and only the split's last is short. The hit rows of f (C values)
// and g (Co values) are gathered by cp.async 16-byte copies (8, 4 or element
// by element where the row width or alignment does not allow 16; rows as
// wide as the tile in 16-byte units take fixed trip counts) into a ring of 2
// to 5 stages (as many as leave room for three blocks an SM), so that the
// next batches are in flight while one is multiplied; rows past the batch's
// last hit are zeros up to the next multiple of 16. A miss or an invalid row
// is never read or multiplied. Each batch adds F^T G into the block's C x Co
// accumulators with mma.sync m16n8k16 bf16 -> f32 (M = C padded to 16, N =
// Co, reduction over the hit rows), both operands read by ldmatrix.trans
// from the row-major hit tiles, rows padded by 16 bytes against bank
// conflicts. Small tiles split the reduction between the warps and add the
// warps' partials in warp order at the end. Each block writes its partial
// tile to an f32 workspace (S, K, C, Co) and a second kernel adds the S
// partials in split order. Every order is fixed by the shape (no atomics),
// so the result has the same bits from run to run; Adam divides the
// gradient by the root of its running square and rewards that.
//
// The f32 path (dw_fma_kernel) keeps the first version's FMA products over
// the same splits and workspace: a block compacts its split's hits for one
// offset by ballot, stages the hit rows in f32 and adds exact products into
// a register tile, rows in ascending order.
//
// C interface, loaded with ctypes: rulebook_conv_dw_launch returns the CUDA
// error code of the launches (0 on success).

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_sm90;

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int DW_THREADS = 128;   // 4 warps
constexpr int DW_RPT = 4;         // consecutive rows a thread looks up
constexpr int DW_WINDOW = DW_THREADS * DW_RPT;
constexpr int DW_BATCH = 64;      // hit rows a stage holds
constexpr int DW_LIST = 1024;     // ring of listed hits: a window and a batch
static_assert(DW_LIST >= DW_WINDOW + DW_BATCH, "the ring holds a window more");

// The C x Co tile of a block is CT x COT; each warp owns MT x NT mma tiles
// (16 x 8 each) of it, WM x WN warps cover it, and WK groups of warps split
// the reduction over the hit rows.
template <int CT, int COT>
struct DwTile {
    static constexpr int MT = CT == 16 ? 1 : 2;
    static constexpr int WM = CT / (16 * MT);
    static constexpr int NT = (CT == 64 && COT == 128) ? 8
        : (COT / 8 < 8 / MT ? COT / 8 : 8 / MT);
    static constexpr int WN = COT / (8 * NT);
    static constexpr int WK = 4 / (WM * WN);
    static constexpr int F_STRIDE = CT + 8;   // +16 bytes a row: other banks
    static constexpr int G_STRIDE = COT + 8;
    static constexpr int STAGE = DW_BATCH * (F_STRIDE + G_STRIDE);
    static_assert(WM * WN * WK == 4, "4 warps");
};

// Shared memory: the ring of listed hits, the scan's warp counts and the
// stages' row counts, then the ring of stages.
constexpr int DW_STAGE_OFF = ((2 * DW_LIST + 4 + 8) * 4 + 127) / 128 * 128;

// The ring of stages: as many as leave room for three blocks on an SM (228
// KB, 1 KB of it reserved a block), from 2 (one batch in flight) to 5.
template <int CT, int COT>
__host__ __device__ constexpr int dw_stages() {
    constexpr int n = ((228 / 3 - 1) * 1024 - DW_STAGE_OFF)
        / (DwTile<CT, COT>::STAGE * 2);
    return n > 5 ? 5 : n < 2 ? 2 : n;
}

template <int CT, int COT>
constexpr int dw_smem_bytes() {
    return DW_STAGE_OFF + dw_stages<CT, COT>() * DwTile<CT, COT>::STAGE * 2;
}

// Rows of a split: split s of S = gridDim.x takes the groups of DW_RPT
// consecutive rows s, s + S, s + 2S, ... in ascending order, so that the
// padding rows at the end of each sample spread over all splits; a window
// holds `per_window` of its groups. The windows of this block's split:
__device__ __forceinline__ int64_t split_windows(int64_t n_rows,
                                                 int per_window) {
    const int64_t n_groups = (n_rows + DW_RPT - 1) / DW_RPT;
    const int64_t mine = (n_groups - blockIdx.x + gridDim.x - 1) / gridDim.x;
    return (mine + per_window - 1) / per_window;
}

// Row i of group g of window w of this block's split (maybe >= n_rows).
__device__ __forceinline__ int64_t split_row(int64_t w, int per_window, int g,
                                             int i) {
    return (blockIdx.x + static_cast<int64_t>(gridDim.x) * (w * per_window + g))
        * DW_RPT + i;
}

template <int CT, int COT>
__global__ void __launch_bounds__(DW_THREADS)
dw_mma_kernel(const bf16* __restrict__ feats, const int* __restrict__ rb,
              const bf16* __restrict__ grad, const uint8_t* __restrict__ valid,
              float* __restrict__ ws, int64_t n_rows, int v_out, int v_in,
              int n_k, int c_in, int c_out, int vec_f, int vec_g) {
    using T = DwTile<CT, COT>;
    constexpr int STAGES = dw_stages<CT, COT>();
    extern __shared__ __align__(128) unsigned char smem[];
    int* s_src = reinterpret_cast<int*>(smem);   // [DW_LIST] input row of a hit
    int* s_row = s_src + DW_LIST;                // [DW_LIST] its output row
    int* s_wsum = s_row + DW_LIST;               // [4] warp hit counts
    int* s_cnt = s_wsum + 4;                     // [STAGES] rows of a batch
    bf16* s_stage = reinterpret_cast<bf16*>(smem + DW_STAGE_OFF);

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int wk = warp / (T::WM * T::WN);
    const int wm = (warp % (T::WM * T::WN)) / T::WN;
    const int wn = warp % T::WN;
    const int k = blockIdx.y;
    const int co_tiles = (c_out + COT - 1) / COT;
    const int c0 = (blockIdx.z / co_tiles) * CT;
    const int d0 = (blockIdx.z % co_tiles) * COT;
    const int fw = min(CT, c_in - c0), gw = min(COT, c_out - d0);
    // whole tile rows in 16-byte units: the copies take fixed trip counts
    const bool full_rows = fw == CT && gw == COT && vec_f == 16 && vec_g == 16;
    const int64_t n_windows = split_windows(n_rows, DW_THREADS);

    float acc[T::MT][T::NT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

    // the rulebook entries of offset k for DW_RPT consecutive rows a thread
    // (-1 for a row past the split or not valid), loaded a window ahead
    int v_next[DW_RPT];
    auto load_window = [&](int64_t w) {
#pragma unroll
        for (int i = 0; i < DW_RPT; ++i) {
            const int64_t row = split_row(w, DW_THREADS, tid, i);
            const bool ok = row < n_rows && (valid == nullptr || valid[row] != 0);
            v_next[i] = ok ? rb[row * n_k + k] : -1;
        }
    };

    // The hits of the split's windows are listed in row order into a ring
    // (one block-wide scan of the hit counts a window) and taken from it in
    // batches, so a batch spans windows and only the split's last is short.
    // `listed` and `taken` count hits since the start (the same in every
    // thread); the ring holds at most a batch not yet taken when a window
    // is listed, so it never overwrites one.
    int listed = 0, taken = 0;
    int64_t w_next = 0;
    auto list_window = [&]() {
        const int64_t w = w_next++;
        int src[DW_RPT], n = 0;
#pragma unroll
        for (int i = 0; i < DW_RPT; ++i) {
            const int base =
                static_cast<int>(split_row(w, DW_THREADS, tid, i) / v_out) * v_in;
            const int v = v_next[i];
            src[i] = (v >= 0 && v < v_in) ? base + v : -1;
            n += src[i] >= 0;
        }
        if (w_next < n_windows) load_window(w_next);
        int incl = n;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
            const int x = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += x;
        }
        if (lane == 31) s_wsum[warp] = incl;
        __syncthreads();  // warp counts written; earlier batches' lists read
        int before = 0, total = 0;
#pragma unroll
        for (int ww = 0; ww < DW_THREADS / 32; ++ww) {
            const int x = s_wsum[ww];
            if (ww < warp) before += x;
            total += x;
        }
        int pos = listed + before + incl - n;
#pragma unroll
        for (int i = 0; i < DW_RPT; ++i) {
            if (src[i] >= 0) {
                s_src[pos % DW_LIST] = src[i];
                s_row[pos % DW_LIST] =
                    static_cast<int>(split_row(w, DW_THREADS, tid, i));
                ++pos;
            }
        }
        listed += total;
        __syncthreads();  // the window's hits are listed; s_wsum is free
    };

    // issues the next batch of listed hits into `stage` (the hit rows of f
    // and g; rows past the last hit are zeros up to a multiple of 16) and
    // records its row count; returns false, issuing nothing, past the last
    auto issue_next = [&](int stage) {
        while (listed - taken < DW_BATCH && w_next < n_windows) list_window();
        const int cnt = min(DW_BATCH, listed - taken);
        if (cnt == 0) return false;
        const int h0 = taken;
        taken += cnt;
        const int rows16 = (cnt + 15) / 16 * 16;
        bf16* f = s_stage + stage * T::STAGE;
        bf16* g = f + DW_BATCH * T::F_STRIDE;
        const int r = tid >> 1, part = tid & 1;  // two threads a row
        if (full_rows && r < rows16) {
            // rows cnt .. rows16 - 1 are zero-fills (nothing is read)
            const bool fill = r < cnt;
            const int h = (h0 + (fill ? r : 0)) % DW_LIST;
            const bf16* fs = feats + static_cast<int64_t>(s_src[h]) * c_in + c0;
            const bf16* gs = grad + static_cast<int64_t>(s_row[h]) * c_out + d0;
#pragma unroll
            for (int q = 0; q < CT / 16; ++q)
                cp_async<16>(f + r * T::F_STRIDE + (2 * q + part) * 8,
                             fs + (2 * q + part) * 8, fill);
#pragma unroll
            for (int q = 0; q < COT / 16; ++q)
                cp_async<16>(g + r * T::G_STRIDE + (2 * q + part) * 8,
                             gs + (2 * q + part) * 8, fill);
        } else if (r < cnt) {
            const int h = (h0 + r) % DW_LIST;
            copy_row_part(f + r * T::F_STRIDE, feats
                          + static_cast<int64_t>(s_src[h]) * c_in + c0,
                          fw, vec_f, true, part, 2);
            copy_row_part(g + r * T::G_STRIDE, grad
                          + static_cast<int64_t>(s_row[h]) * c_out + d0,
                          gw, vec_g, true, part, 2);
        } else if (r < rows16) {  // a zero row pads the reduction
            const uint4 z = make_uint4(0, 0, 0, 0);
            for (int c = part; c < CT / 8; c += 2)
                reinterpret_cast<uint4*>(f + r * T::F_STRIDE)[c] = z;
            for (int c = part; c < COT / 8; c += 2)
                reinterpret_cast<uint4*>(g + r * T::G_STRIDE)[c] = z;
        }
        if (tid == 0) s_cnt[stage] = cnt;
        return true;
    };

    // adds the batch in `stage` into the accumulators
    auto compute = [&](int stage) {
        const int cnt = s_cnt[stage];
        const bf16* f = s_stage + stage * T::STAGE;
        const bf16* g = f + DW_BATCH * T::F_STRIDE;
        for (int ks = wk * 16; ks < cnt; ks += T::WK * 16) {
            uint32_t af[T::MT][4];
#pragma unroll
            for (int mt = 0; mt < T::MT; ++mt)
                ldmatrix_x4_trans(af[mt], f
                    + (ks + (lane & 7) + ((lane >> 4) << 3)) * T::F_STRIDE
                    + (wm * T::MT + mt) * 16 + (((lane >> 3) & 1) << 3));
#pragma unroll
            for (int np = 0; np < T::NT / 2; ++np) {
                uint32_t bfr[4];
                ldmatrix_x4_trans(bfr, g + (ks + (lane & 15)) * T::G_STRIDE
                                  + wn * T::NT * 8 + np * 16
                                  + ((lane >> 4) << 3));
#pragma unroll
                for (int mt = 0; mt < T::MT; ++mt) {
                    mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
                    mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
                }
            }
        }
    };

    int issued = 0;
    if (n_windows > 0) load_window(0);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (issue_next(s)) ++issued;
        cp_async_commit();
    }
    for (int item = 0; item < issued; ++item) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // item's stage is in; item - 1's is free
        if (issue_next((item + STAGES - 1) % STAGES)) ++issued;
        cp_async_commit();
        compute(item % STAGES);
    }
    cp_async_wait<0>();

    // warps that split the reduction add their partials in warp order,
    // through the (now idle) stage memory
    const int g8 = lane >> 2, t = lane & 3;
    float* red = reinterpret_cast<float*>(s_stage);
    if constexpr (T::WK > 1) {
        __syncthreads();
        for (int q = 1; q < T::WK; ++q) {
#pragma unroll
            for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int m = (wm * T::MT + mt) * 16 + g8 + (e >> 1) * 8;
                        const int n = (wn * T::NT + nt) * 8 + 2 * t + (e & 1);
                        if (wk == q) red[m * COT + n] = acc[mt][nt][e];
                    }
            __syncthreads();
#pragma unroll
            for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int m = (wm * T::MT + mt) * 16 + g8 + (e >> 1) * 8;
                        const int n = (wn * T::NT + nt) * 8 + 2 * t + (e & 1);
                        if (wk == 0) acc[mt][nt][e] += red[m * COT + n];
                    }
            __syncthreads();
        }
    }
    if (wk != 0) return;
    float* tile = ws + (static_cast<int64_t>(blockIdx.x) * n_k + k) * c_in * c_out;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int m = (wm * T::MT + mt) * 16 + g8 + (e >> 1) * 8;
                const int n = (wn * T::NT + nt) * 8 + 2 * t + (e & 1);
                if (m < fw && n < gw)
                    tile[static_cast<int64_t>(c0 + m) * c_out + d0 + n] =
                        acc[mt][nt][e];
            }
}

// ---- f32: FMA units ---------------------------------------------------------

constexpr int THREADS = 256;  // 16 column groups (tx) x 16 row groups (ty)
constexpr int WINDOW = 256;   // output rows looked up at once, one a thread
constexpr int BATCH = 32;     // hit rows staged at once
constexpr int WARPS = THREADS / 32;

template <int TM, int TN>
__global__ void __launch_bounds__(THREADS)
dw_fma_kernel(const float* __restrict__ feats, const int* __restrict__ rb,
              const float* __restrict__ grad,
              const uint8_t* __restrict__ valid, float* __restrict__ ws,
              int64_t n_rows, int v_out, int v_in, int n_k, int c_in,
              int c_out) {
    constexpr int CT = 16 * TM;   // rows of the dW tile (input channels)
    constexpr int COT = 16 * TN;  // columns of the dW tile (output channels)
    __shared__ float s_f[BATCH][CT];
    __shared__ float s_g[BATCH][COT];
    __shared__ int s_src[WINDOW];  // flat input row of each hit, in row order
    __shared__ int s_row[WINDOW];  // flat output row of each hit
    __shared__ int s_count[WARPS];

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int tx = tid % 16, ty = tid / 16;
    const int k = blockIdx.y;
    const int co_tiles = (c_out + COT - 1) / COT;
    const int c0 = (blockIdx.z / co_tiles) * CT;
    const int d0 = (blockIdx.z % co_tiles) * COT;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    // the rows of split blockIdx.x as in dw_mma_kernel, a window of
    // WINDOW rows (WINDOW / DW_RPT groups) at a time, one row a thread
    const int64_t n_windows = split_windows(n_rows, WINDOW / DW_RPT);
    for (int64_t w = 0; w < n_windows; ++w) {
        const int64_t row = split_row(w, WINDOW / DW_RPT, tid / DW_RPT,
                                      tid % DW_RPT);
        int src = -1;
        if (row < n_rows && (valid == nullptr || valid[row] != 0)) {
            const int v = rb[row * n_k + k];
            if (v >= 0 && v < v_in)
                src = static_cast<int>(row / v_out) * v_in + v;
        }
        const unsigned hits = __ballot_sync(0xffffffffu, src >= 0);
        if (lane == 0) s_count[warp] = __popc(hits);
        __syncthreads();  // counts written; the last window's readers are done
        int base = 0, total = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const int n = s_count[w];
            if (w < warp) base += n;
            total += n;
        }
        if (src >= 0) {
            const int pos = base + __popc(hits & ((1u << lane) - 1u));
            s_src[pos] = src;
            s_row[pos] = static_cast<int>(row);
        }
        __syncthreads();  // the window's hits are listed

        for (int h0 = 0; h0 < total; h0 += BATCH) {
            const int n = min(BATCH, total - h0);
            for (int e = tid; e < n * CT; e += THREADS) {
                const int j = e / CT, c = e - j * CT;
                s_f[j][c] = c0 + c < c_in
                    ? feats[static_cast<int64_t>(s_src[h0 + j]) * c_in + c0 + c]
                    : 0.0f;
            }
            for (int e = tid; e < n * COT; e += THREADS) {
                const int j = e / COT, d = e - j * COT;
                s_g[j][d] = d0 + d < c_out
                    ? grad[static_cast<int64_t>(s_row[h0 + j]) * c_out + d0 + d]
                    : 0.0f;
            }
            __syncthreads();
            for (int j = 0; j < n; ++j) {
                float a[TM], b[TN];
#pragma unroll
                for (int i = 0; i < TM; ++i) a[i] = s_f[j][ty + 16 * i];
#pragma unroll
                for (int i = 0; i < TN; ++i) b[i] = s_g[j][tx + 16 * i];
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int jj = 0; jj < TN; ++jj)
                        acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
            }
            __syncthreads();  // s_f, s_g, and at the end s_src, are free
        }
    }

    float* tile = ws + (static_cast<int64_t>(blockIdx.x) * n_k + k)
        * c_in * c_out;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int c = c0 + ty + 16 * i;
        if (c >= c_in) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int d = d0 + tx + 16 * j;
            if (d < c_out) tile[static_cast<int64_t>(c) * c_out + d] = acc[i][j];
        }
    }
}

// out[e] = ws[0][e] + ws[1][e] + ... in split order, e over K * C * Co;
// the loads of 16 splits are issued before they are added, so that the
// latency is paid once per 16 splits
__global__ void __launch_bounds__(THREADS)
dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                 int n_splits, int64_t n_elems) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (e >= n_elems) return;
    float sum = 0.0f;
    for (int s0 = 0; s0 < n_splits; s0 += 16) {
        float v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
            v[i] = s0 + i < n_splits ? ws[(s0 + i) * n_elems + e] : 0.0f;
#pragma unroll
        for (int i = 0; i < 16; ++i) sum += v[i];
    }
    out[e] = sum;
}

struct Args {
    const void *feats, *rb, *grad, *valid;
    void *ws, *out;
    int64_t n_rows;
    int v_out, v_in, n_k, c_in, c_out, n_splits;
    cudaStream_t stream;
};

template <int CT, int COT>
cudaError_t launch_mma(const Args& a) {
    static int set_bytes[64] = {};
    constexpr int bytes = dw_smem_bytes<CT, COT>();
    const cudaError_t err =
        allow_dynamic_smem(dw_mma_kernel<CT, COT>, bytes, set_bytes);
    if (err != cudaSuccess) return err;
    const int tiles = ((a.c_in + CT - 1) / CT) * ((a.c_out + COT - 1) / COT);
    const dim3 grid(static_cast<unsigned>(a.n_splits),
                    static_cast<unsigned>(a.n_k), static_cast<unsigned>(tiles));
    dw_mma_kernel<CT, COT><<<grid, DW_THREADS, bytes, a.stream>>>(
        static_cast<const bf16*>(a.feats), static_cast<const int*>(a.rb),
        static_cast<const bf16*>(a.grad), static_cast<const uint8_t*>(a.valid),
        static_cast<float*>(a.ws), a.n_rows, a.v_out, a.v_in, a.n_k, a.c_in,
        a.c_out, copy_unit(a.feats, a.c_in, 0),
        copy_unit(a.grad, a.c_out, 0));
    return cudaGetLastError();
}

template <int TM, int TN>
cudaError_t launch_fma(const Args& a) {
    const int tiles = ((a.c_in + 16 * TM - 1) / (16 * TM))
        * ((a.c_out + 16 * TN - 1) / (16 * TN));
    const dim3 grid(static_cast<unsigned>(a.n_splits),
                    static_cast<unsigned>(a.n_k),
                    static_cast<unsigned>(tiles));
    dw_fma_kernel<TM, TN><<<grid, THREADS, 0, a.stream>>>(
        static_cast<const float*>(a.feats), static_cast<const int*>(a.rb),
        static_cast<const float*>(a.grad), static_cast<const uint8_t*>(a.valid),
        static_cast<float*>(a.ws), a.n_rows, a.v_out, a.v_in, a.n_k, a.c_in,
        a.c_out);
    return cudaGetLastError();
}

// The tile of dW a block takes: 16, 32 or 64 rows, the least that covers C
// (a larger C takes more tiles along grid.z), and as many columns or twice
// as many where Co is wider than that (a wider Co takes more tiles, a
// narrower one leaves columns unused). Six tiles, one for each shape of the
// SECOND backbone (ops/sparse_conv_cuda.py _dw_tile).
cudaError_t launch_partials(const Args& a, bool is_bf16) {
    const int ct = a.c_in <= 16 ? 16 : a.c_in <= 32 ? 32 : 64;
    const bool wide = a.c_out > ct;
    if (is_bf16) {
        if (ct == 16) return wide ? launch_mma<16, 32>(a) : launch_mma<16, 16>(a);
        if (ct == 32) return wide ? launch_mma<32, 64>(a) : launch_mma<32, 32>(a);
        return wide ? launch_mma<64, 128>(a) : launch_mma<64, 64>(a);
    }
    if (ct == 16) return wide ? launch_fma<1, 2>(a) : launch_fma<1, 1>(a);
    if (ct == 32) return wide ? launch_fma<2, 4>(a) : launch_fma<2, 2>(a);
    return wide ? launch_fma<4, 8>(a) : launch_fma<4, 4>(a);
}

}  // namespace

// ws holds n_splits * n_k * c_in * c_out floats; split s takes the groups
// of 4 rows s, s + n_splits, s + 2 n_splits, ... (split_row).
extern "C" int rulebook_conv_dw_launch(
        const void* feats, const void* rb, const void* grad, const void* valid,
        void* ws, void* out, long long n_rows, int v_out, int v_in, int n_k,
        int c_in, int c_out, int n_splits, int is_bf16, void* stream) {
    if (n_rows < 1 || v_out < 1 || v_in < 1 || n_k < 1 || c_in < 1 ||
        c_out < 1 || n_splits < 1 || n_rows > 2147483647LL || n_k > 65535 ||
        n_splits > (n_rows + DW_WINDOW - 1) / DW_WINDOW ||  // >= 1 window
        (n_rows / v_out + 1) * static_cast<long long>(v_in) > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{feats, rb, grad, valid, ws, out, n_rows, v_out, v_in, n_k,
                 c_in, c_out, n_splits, static_cast<cudaStream_t>(stream)};
    cudaError_t err = launch_partials(a, is_bf16 != 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t n_elems = static_cast<int64_t>(n_k) * c_in * c_out;
    dw_reduce_kernel<<<static_cast<unsigned>((n_elems + THREADS - 1) / THREADS),
                       THREADS, 0, a.stream>>>(
        static_cast<const float*>(ws), static_cast<float*>(out), n_splits,
        n_elems);
    return static_cast<int>(cudaGetLastError());
}
