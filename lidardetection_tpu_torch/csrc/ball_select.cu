// K5 ball_select: first-nsample-by-index selection of a grid ball query,
// for Hopper (sm_90a).
//
// Replaces lidardetection_tpu/ops/select_tpu.py::ball_select (Pallas
// kernel _select_kernel). For every center r and every radius i of an MSG
// group it returns the TPU kernel's output:
//
//   out_i[r, s] = -orig of the s-th in-radius candidate by ascending orig,
//                 -inf where the center has fewer than s + 1 such hits
//
// over the candidates of its row runs: rows [start[r, j], end[r, j]) of
// its sample's cell-sorted source table, j < n_row, each run cut to
// max_run rows (the caller's prep has already cut them, and emptied the
// runs of invalid centers). A candidate is in radius i when
//
//   d2 = ((x - cx)^2 + (y - cy)^2) + (z - cz)^2 < r2[i]
//
// in float32 with every product and sum rounded on its own (__fmul_rn,
// __fsub_rn, __fadd_rn: no fused multiply-add), the order of
// ball_select_plain in ops/select_cuda.py, so the two agree bit for bit;
// a flipped boundary pair would change a max-pooled feature. The runs of
// one center are disjoint, so its candidates' orig values are unique,
// which the selection below relies on as the TPU kernel does.
//
// The TPU kernel streams packed field-major candidate windows
// (ops/pointnet2.py::_candidate_windows) because XLA:TPU bills gathers per
// index; Hopper loads rows natively, so this kernel reads the sorted table
// directly and the packed table does not exist.
//
// What bounds it on the H100: not bytes (16 bytes a candidate row) nor
// FLOP (9 a live pair): at one request's shapes (2048 centers, a few
// hundred candidates each, up to n_row * max_run = 1728) it is latency,
// the chain of dependent steps one center takes. The design keeps that
// chain short:
//
// 1. A block of two warps takes one center, so the 2048 centers of a
//    request are all in flight at once (about 16 blocks an SM) and each
//    center's rows and hits are spread over 64 threads. (Blocks of one and
//    of four warps were slower on the H100.)
// 2. Gather over the concatenated runs. One warp scan of the run lengths
//    gives each run's offset in the concatenation; then thread t takes row
//    t of it, so a step covers 64 live rows whatever the runs' lengths,
//    and a center of 9 short runs does not pay 9 steps.
// 3. A 4-byte hit. A hit is packed as orig << 4 | (bit i set when d2 <
//    r2[i]): d2 only serves the radius tests. Hits go into a buffer in
//    shared memory (one shared add a warp for the slots; the slot order
//    shows nowhere below) of `cap` entries, sized by the host plan from
//    the shape (ops/select_cuda.py::select_launch_plan), not for the worst
//    case of n_row * max_run hits. A center with more hits than that reads
//    its runs again for every pass below instead of the buffer: slower,
//    the same bits.
// 4. A selection whose depth does not grow with nsample. For radius i the
//    block counts its hits while gathering. If there are at most nsample,
//    all are taken. Otherwise a radix select finds the threshold: a
//    256-bin shared-memory histogram of the next 8 bits of (orig - the
//    center's least orig), one warp scan to find the bin that holds the
//    nsample-th hit, and a descent into that bin only while the bin is not
//    taken whole; at most four levels for 28-bit indices, usually one or
//    two. The taken hits (nsample of them, or fewer) are then compacted
//    into a list and each is put at its rank, the count of taken hits
//    below it. The histogram's adds are shared-memory atomics of counts,
//    and the list's order decides no output, so the outputs repeat bit for
//    bit.
//
// Per-radius values are read from shared memory, not indexed in the
// kernel's parameters: a run-time index there copies the parameters to a
// per-thread stack, which was measurably slower on the H100.
//
// C interface, loaded with ctypes: ball_select_launch returns the CUDA
// error code of the launch (0 on success).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int MAX_RADII = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 2;  // warps a center: a block is one center
constexpr int THREADS = 32 * WARPS;
constexpr int HIST_BINS = 256;  // 8 bits of orig a level
constexpr int MAX_SMEM = 227 * 1024;
static_assert(HIST_BINS == 8 * 32, "a warp scans the histogram");

struct Radii {
    int n;
    float r2[MAX_RADII];
    int nsample[MAX_RADII];
    float* out[MAX_RADII];
};

// What a block knows of its center.
struct Center {
    const float* xyz;  // its sample's table
    const int* orig;
    const int* run_start;  // shared: n_row run starts
    const int* run_off;    // shared: n_row + 1 offsets in the concatenation
    int total;             // rows over all runs
    float cx, cy, cz;
};

// Block-wide values, in shared memory.
struct Shared {
    int count;                  // hits (may exceed the buffer)
    int per_radius[MAX_RADII];  // hits of each radius
    unsigned least, most;       // least and most orig of the hits
    int taken;                  // entries of the taken list
    int bin, below, in_bin;     // the radix select's chosen bin
    int nsample[MAX_RADII];     // the radii's nsample and outputs, read by
    float* out[MAX_RADII];      // a run-time index (from the parameters
                                // they would be copied to the stack)
};

__device__ __forceinline__ unsigned lanes_below(int lane) {
    return (1u << lane) - 1u;
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
    for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += u;
    }
    return v;
}

// Appends `hit` where `take` holds, one shared add a warp. The slot order
// is the order of arrival, and nothing below depends on it.
__device__ __forceinline__ void append(unsigned* list, int cap, int* count,
                                       bool take, unsigned hit, int lane) {
    const unsigned m = __ballot_sync(FULL, take);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(count, __popc(m));
    base = __shfl_sync(FULL, base, 0);
    const int at = base + __popc(m & lanes_below(lane));
    if (take && at < cap) list[at] = hit;
}

// f(valid, hit) for the rows of the concatenated runs, THREADS a step, every
// thread the same number of times: valid where the thread's row is in some
// radius, hit its packed word.
template <class F>
__device__ __forceinline__ void walk_runs(const Center& c, const Radii& radii,
                                          F f) {
    int j = 0;
    for (int t0 = 0; t0 < c.total; t0 += THREADS) {
        const int t = t0 + static_cast<int>(threadIdx.x);
        unsigned hit = 0;
        if (t < c.total) {
            while (c.run_off[j + 1] <= t) ++j;
            const int64_t row = c.run_start[j] + (t - c.run_off[j]);
            const float dx = __fsub_rn(c.xyz[3 * row], c.cx);
            const float dy = __fsub_rn(c.xyz[3 * row + 1], c.cy);
            const float dz = __fsub_rn(c.xyz[3 * row + 2], c.cz);
            const float d2 = __fadd_rn(
                __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                __fmul_rn(dz, dz));
            unsigned mask = 0;
#pragma unroll
            for (int i = 0; i < MAX_RADII; ++i)
                if (i < radii.n && d2 < radii.r2[i]) mask |= 1u << i;
            hit = (static_cast<unsigned>(c.orig[row]) << 4) | mask;
        }
        f((hit & 0xfu) != 0, hit);
    }
}

// The same walk over the hits, from the buffer when they fit in it.
template <class F>
__device__ __forceinline__ void walk_hits(const unsigned* buf, int count,
                                          int cap, const Center& c,
                                          const Radii& radii, F f) {
    if (count > cap) {
        walk_runs(c, radii, f);
        return;
    }
    for (int t0 = 0; t0 < count; t0 += THREADS) {
        const int t = t0 + static_cast<int>(threadIdx.x);
        f(t < count, t < count ? buf[t] : 0u);
    }
}

__global__ void __launch_bounds__(THREADS)
ball_select_kernel(const float* __restrict__ xyz, const int* __restrict__ orig,
                   const int* __restrict__ start, const int* __restrict__ end,
                   const float* __restrict__ centers, int centers_per_sample,
                   int rows_per_sample, int n_row, int max_run, int cap,
                   int list_cap, Radii radii) {
    extern __shared__ unsigned smem[];
    __shared__ Shared sh;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r = blockIdx.x;

    // hits[cap] | histogram[HIST_BINS] | taken list[list_cap] | runs
    unsigned* buf = smem;
    unsigned* hist = buf + cap;
    unsigned* list = hist + HIST_BINS;
    int* run_start = reinterpret_cast<int*>(list + list_cap);
    int* run_off = run_start + n_row;

    // run lengths -> offsets in the concatenation, by the first warp
    if (warp == 0) {
        int carry = 0;
        for (int j0 = 0; j0 < n_row; j0 += 32) {
            const int j = j0 + lane;
            int len = 0;
            if (j < n_row) {
                const int s = start[static_cast<int64_t>(r) * n_row + j];
                len = max(min(end[static_cast<int64_t>(r) * n_row + j] - s,
                              max_run), 0);
                run_start[j] = s;
            }
            const int inc = warp_inclusive_sum(len, lane);
            if (j < n_row) run_off[j] = carry + inc - len;
            carry += __shfl_sync(FULL, inc, 31);
        }
        if (lane == 0) {
            run_off[n_row] = carry;
            sh.count = 0;
            sh.least = UINT_MAX;
            sh.most = 0;
#pragma unroll
            for (int i = 0; i < MAX_RADII; ++i) {
                sh.per_radius[i] = 0;
                sh.nsample[i] = radii.nsample[i];
                sh.out[i] = radii.out[i];
            }
        }
    }
    // zero once: each level's readers zero the bins they read
    for (int q = tid; q < HIST_BINS; q += THREADS) hist[q] = 0;
    __syncthreads();

    const int64_t base_row =
        static_cast<int64_t>(r / centers_per_sample) * rows_per_sample;
    const Center c{xyz + 3 * base_row, orig + base_row, run_start, run_off,
                   run_off[n_row], centers[3 * r], centers[3 * r + 1],
                   centers[3 * r + 2]};

    // gather: hits into the buffer, per-radius counts, least and most orig
    int per_radius[MAX_RADII] = {0, 0, 0, 0};
    unsigned least = UINT_MAX, most = 0;
    walk_runs(c, radii, [&](bool valid, unsigned hit) {
        append(buf, cap, &sh.count, valid, hit, lane);
        if (valid) {
            least = min(least, hit >> 4);
            most = max(most, hit >> 4);
        }
#pragma unroll
        for (int i = 0; i < MAX_RADII; ++i)
            per_radius[i] +=
                __popc(__ballot_sync(FULL, valid && ((hit >> i) & 1u)));
    });
    least = __reduce_min_sync(FULL, least);
    most = __reduce_max_sync(FULL, most);
    if (lane == 0) {
        atomicMin(&sh.least, least);
        atomicMax(&sh.most, most);
#pragma unroll
        for (int i = 0; i < MAX_RADII; ++i)
            atomicAdd(&sh.per_radius[i], per_radius[i]);
    }
    __syncthreads();
    const int count = sh.count;
    least = sh.least;
    // bits of (orig - least) over this center's hits
    const int bits = count > 0 ? 32 - __clz(static_cast<int>(sh.most - least))
                               : 0;

#pragma unroll 1
    for (int i = 0; i < radii.n; ++i) {
        const int ns = sh.nsample[i];
        float* out = sh.out[i] + static_cast<int64_t>(r) * ns;
        const unsigned bit = 1u << i;
        const int have = sh.per_radius[i];
        // take the hits of radius i with orig - least <= thresh
        unsigned thresh = UINT_MAX;
        if (have > ns) {
            // radix select of the ns-th smallest (orig - least), 8 bits a
            // level, descending into the bin that holds it
            unsigned prefix = 0;  // the bits above `hi` already chosen
            int hi = bits, need = ns;
            while (true) {
                const int lo = max(hi - 8, 0);
                walk_hits(buf, count, cap, c, radii,
                          [&](bool valid, unsigned hit) {
                              const unsigned v = (hit >> 4) - least;
                              if (valid && (hit & bit) && (v >> hi) == prefix)
                                  atomicAdd(&hist[(v >> lo) & 0xffu], 1u);
                          });
                __syncthreads();
                // the first warp scans the histogram, 8 bins a lane, and
                // zeroes it for the next level
                if (warp == 0) {
                    unsigned own[8];
                    int sum = 0;
#pragma unroll
                    for (int k = 0; k < 8; ++k) {
                        own[k] = hist[8 * lane + k];
                        hist[8 * lane + k] = 0;
                        sum += own[k];
                    }
                    const int inc = warp_inclusive_sum(sum, lane);
                    int below = inc - sum;
                    if (below < need && need <= inc) {
#pragma unroll
                        for (int k = 0; k < 8; ++k) {
                            if (below + static_cast<int>(own[k]) >= need) {
                                sh.bin = 8 * lane + k;
                                sh.below = below;
                                sh.in_bin = own[k];
                                break;
                            }
                            below += own[k];
                        }
                    }
                }
                __syncthreads();
                const int below = sh.below, in_bin = sh.in_bin;
                prefix = (prefix << (hi - lo)) | static_cast<unsigned>(sh.bin);
                if (below + in_bin == need || lo == 0) {
                    thresh = (prefix << lo) | ((1u << lo) - 1u);
                    break;
                }
                need -= below;
                hi = lo;
            }
        }
        // compact the taken hits, then put each at its rank
        const int taken = min(have, ns);
        if (tid == 0) sh.taken = 0;
        __syncthreads();
        walk_hits(buf, count, cap, c, radii, [&](bool valid, unsigned hit) {
            append(list, taken, &sh.taken,
                   valid && (hit & bit) && (hit >> 4) - least <= thresh,
                   hit >> 4, lane);
        });
        __syncthreads();
        for (int k = tid; k < taken; k += THREADS) {
            const unsigned o = list[k];
            int rank = 0;
            for (int q = 0; q < taken; ++q) rank += list[q] < o;
            out[rank] = -static_cast<float>(o);
        }
        for (int q = taken + tid; q < ns; q += THREADS) out[q] = -CUDART_INF_F;
        __syncthreads();  // the next radius reuses the list and sh
    }
}

}  // namespace

extern "C" int ball_select_launch(const void* xyz, const void* orig,
                                  const void* start, const void* end,
                                  const void* centers, int n_centers,
                                  int centers_per_sample, int rows_per_sample,
                                  int n_row, int max_run, int n_radii,
                                  const float* r2, const int* nsample,
                                  void* const* outs, int cap, int list_cap,
                                  void* stream) {
    if (n_radii < 1 || n_radii > MAX_RADII || n_row < 1 || max_run < 1 ||
        centers_per_sample < 1 || rows_per_sample < 1 ||
        rows_per_sample > (1 << 28) || cap < 0 || list_cap < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Radii radii;
    radii.n = n_radii;
    for (int i = 0; i < MAX_RADII; ++i) {
        const bool used = i < n_radii;
        radii.r2[i] = used ? r2[i] : 0.f;
        radii.nsample[i] = used ? nsample[i] : 0;
        radii.out[i] = used ? static_cast<float*>(outs[i]) : nullptr;
        if (used && (radii.nsample[i] < 1 || radii.nsample[i] > list_cap))
            return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t smem = (static_cast<int64_t>(cap) + HIST_BINS + list_cap +
                          2 * n_row + 1) * 4;
    if (smem + static_cast<int64_t>(sizeof(Shared)) > MAX_SMEM)
        return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            ball_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (n_centers > 0) {
        ball_select_kernel<<<n_centers, THREADS, static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(xyz), static_cast<const int*>(orig),
            static_cast<const int*>(start), static_cast<const int*>(end),
            static_cast<const float*>(centers), centers_per_sample,
            rows_per_sample, n_row, max_run, cap, list_cap, radii);
    }
    return static_cast<int>(cudaGetLastError());
}
