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
// Design (simple first): one warp per center. Lanes stride over each run,
// 32 rows at a time; a lane's row is a hit of the largest radius or not,
// and the warp compacts its hits by ballot into shared memory (orig and
// d2, at most n_row * max_run of them). Then each radius takes its nsample
// smallest orig by rounds of a warp-wide minimum over the hits within that
// radius and above the previous round's pick; a round that finds none
// ends the radius with -inf. No atomics: the output bits repeat.
//
// What bounds it on the H100: the work is data-dependent (a few hundred
// candidates per center on a real scan), a few FLOP per candidate and 16
// bytes read per candidate row; at one request's shapes it is far from
// both roofs and is latency-bound (dependent loads, then the selection
// rounds). Making it fast is later work.
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
constexpr int SMEM_BUDGET = 40 * 1024;  // bytes of shared memory per block

struct Radii {
    int n;
    float r2[MAX_RADII];
    int nsample[MAX_RADII];
    float* out[MAX_RADII];
};

__global__ void ball_select_kernel(const float* __restrict__ xyz,
                                   const int* __restrict__ orig,
                                   const int* __restrict__ start,
                                   const int* __restrict__ end,
                                   const float* __restrict__ centers,
                                   int n_centers, int centers_per_sample,
                                   int rows_per_sample, int n_row,
                                   int max_run, Radii radii) {
    extern __shared__ int smem[];
    const int lane = threadIdx.x & 31;
    const int warp_in_block = threadIdx.x >> 5;
    const int r = blockIdx.x * (blockDim.x >> 5) + warp_in_block;
    if (r >= n_centers) return;  // the whole warp leaves together

    const int cap = n_row * max_run;
    int* s_orig = smem + warp_in_block * 2 * cap;
    float* s_d2 = reinterpret_cast<float*>(s_orig + cap);

    float r2max = radii.r2[0];
    for (int i = 1; i < radii.n; ++i) r2max = fmaxf(r2max, radii.r2[i]);
    const float cx = centers[3 * r], cy = centers[3 * r + 1],
                cz = centers[3 * r + 2];
    const int64_t base_row =
        static_cast<int64_t>(r / centers_per_sample) * rows_per_sample;

    int count = 0;
    for (int j = 0; j < n_row; ++j) {
        const int s = start[r * n_row + j];
        const int e = min(end[r * n_row + j], s + max_run);
        for (int p0 = s; p0 < e; p0 += 32) {
            const int p = p0 + lane;
            bool hit = false;
            int o = 0;
            float d2 = 0.f;
            if (p < e) {
                const int64_t row = base_row + p;
                const float dx = __fsub_rn(xyz[3 * row], cx);
                const float dy = __fsub_rn(xyz[3 * row + 1], cy);
                const float dz = __fsub_rn(xyz[3 * row + 2], cz);
                d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
                hit = d2 < r2max;
                o = orig[row];
            }
            const unsigned m = __ballot_sync(FULL, hit);
            if (hit) {
                const int at = count + __popc(m & ((1u << lane) - 1u));
                s_orig[at] = o;
                s_d2[at] = d2;
            }
            count += __popc(m);
        }
    }
    __syncwarp();

    for (int i = 0; i < radii.n; ++i) {
        const float r2 = radii.r2[i];
        const int ns = radii.nsample[i];
        float* out = radii.out[i] + static_cast<int64_t>(r) * ns;
        int prev = -1;  // orig >= 0: every round takes the next larger one
        int k = 0;
        for (; k < ns; ++k) {
            int best = INT_MAX;
            for (int t = lane; t < count; t += 32) {
                const int o = s_orig[t];
                if (s_d2[t] < r2 && o > prev && o < best) best = o;
            }
            best = __reduce_min_sync(FULL, best);
            if (best == INT_MAX) break;
            if (lane == 0) out[k] = -static_cast<float>(best);
            prev = best;
        }
        for (int q = k + lane; q < ns; q += 32) out[q] = -CUDART_INF_F;
    }
}

}  // namespace

extern "C" int ball_select_launch(const void* xyz, const void* orig,
                                  const void* start, const void* end,
                                  const void* centers, int n_centers,
                                  int centers_per_sample, int rows_per_sample,
                                  int n_row, int max_run, int n_radii,
                                  const float* r2, const int* nsample,
                                  void* const* outs, void* stream) {
    if (n_radii < 1 || n_radii > MAX_RADII || n_row < 1 || max_run < 1 ||
        centers_per_sample < 1 || rows_per_sample < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Radii radii;
    radii.n = n_radii;
    for (int i = 0; i < MAX_RADII; ++i) {
        const bool used = i < n_radii;
        radii.r2[i] = used ? r2[i] : 0.f;
        radii.nsample[i] = used ? nsample[i] : 0;
        radii.out[i] = used ? static_cast<float*>(outs[i]) : nullptr;
        if (used && radii.nsample[i] < 1)
            return static_cast<int>(cudaErrorInvalidValue);
    }
    // one warp per center; as many warps per block as the hit buffers fit
    const int per_warp = 2 * n_row * max_run * static_cast<int>(sizeof(int));
    int warps = SMEM_BUDGET / per_warp;
    if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (warps > 8) warps = 8;
    const int blocks = (n_centers + warps - 1) / warps;
    if (blocks > 0) {
        ball_select_kernel<<<blocks, warps * 32, warps * per_warp,
                             static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(xyz), static_cast<const int*>(orig),
            static_cast<const int*>(start), static_cast<const int*>(end),
            static_cast<const float*>(centers), n_centers, centers_per_sample,
            rows_per_sample, n_row, max_run, radii);
    }
    return static_cast<int>(cudaGetLastError());
}
