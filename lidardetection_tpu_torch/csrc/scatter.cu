// K2 scatter_rows: key-sorted rows into a dense BEV canvas, for Hopper
// (sm_90a).
//
// Replaces lidardetection_tpu/ops/scatter_tpu.py::_scatter_pallas (Pallas
// kernel _tile_kernel), the forward of scatter_rows_sorted:
//
//   canvas[b, s, :] = feats[b, v, :]  where keys[b, v] == s, else 0,
//                                     for 0 <= s < n_slots
//
// under the TPU kernel's contract: in each sample the keys ascend, the
// kept keys (those in [0, n_slots)) are unique, and the rows keyed outside
// [0, n_slots) are dropped (the padding rows, keyed n_slots, at the tail).
// The TPU kernel turns the sorted keys into tile windows (a host tile
// histogram, bev_tile_starts) and one-hot matmuls because XLA:TPU
// serialises row scatters; Hopper stores rows natively, and the on-device
// counterpart of the histogram (_tile_starts) is a search below.
//
// What bounds it on the H100: memory. The canvas, 27.4 MB for one 496 x 432
// x 64 bf16 sample, has to be written once; the kept rows and keys are
// read once. So one launch writes every canvas byte exactly once, the
// zeros included: the wrapper takes the canvas from torch.empty, with no
// zero fill and no memset. Each block owns a run of consecutive slots of
// one sample. A zero can be stored only once the block knows that no row
// lands in its slot, so the chain before the first store is kept to two
// dependent loads: the block's 256 threads read 256 evenly spaced keys of
// the sample's sorted keys (the on-device counterpart of the TPU's tile
// histogram, the same keys for every block), which bound the rows landing
// in its run to a window of at most (slots + 2 * V / 256) keys; the block
// reads that window once into a slot -> row map in shared memory, then
// writes its slots' words in order, a row's word where a row lands and
// zero elsewhere, neighbouring threads on neighbouring 16-byte words. A
// row whose size or address is not a multiple of 16 bytes takes 4-, 2- or
// 1-byte words. A block writes 8 KB (3348 blocks at C 64), more than the
// card holds at once, so later blocks' key loads overlap earlier blocks'
// writes; 8 KB blocks were faster on the H100 than 16 or 32 KB ones, and
// 2 or 4 KB ones no faster, and loading a thread's words before storing
// them did not help. Beside a bare fill of the canvas (chip_smoke.py's
// fill_ms), the writes alone take most of the time.
//
// C interface, loaded with ctypes: scatter_rows_launch returns the CUDA
// error code of the launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK_BYTES = 8 * 1024;  // canvas bytes a block writes

template <typename W>
__global__ void __launch_bounds__(THREADS)
scatter_rows_kernel(const W* __restrict__ feats, const int* __restrict__ keys,
                    W* __restrict__ canvas, int v, int words, int n_slots,
                    int slots_per_block) {
    extern __shared__ int row_of[];  // slot - slot0 -> row, or -1
    const int b = blockIdx.y;
    const int slot0 = blockIdx.x * slots_per_block;
    const int n_here = min(slots_per_block, n_slots - slot0);
    const int* k = keys + static_cast<int64_t>(b) * v;

    // Every thread probes one key, THREADS evenly spaced ones (the same for
    // every block of the sample, so L2 serves most blocks); the counts of
    // probes below the run's first and past-the-end slots bound the rows
    // that land in the run to a window of at most n_here + 2 * spacing.
    const int spacing = (v + THREADS - 1) / THREADS;
    const int probe = threadIdx.x * spacing;
    const int probe_key = probe < v ? k[probe] : 0;
    for (int s = threadIdx.x; s < n_here; s += blockDim.x) row_of[s] = -1;
    const int first = __syncthreads_count(probe < v && probe_key < slot0);
    const int last =
        __syncthreads_count(probe < v && probe_key < slot0 + n_here);
    const int w0 = first == 0 ? 0 : (first - 1) * spacing + 1;
    const int w1 = min(last * spacing, v);
#pragma unroll 4
    for (int q = w0 + threadIdx.x; q < w1; q += blockDim.x) {
        const int s = k[q] - slot0;
        if (s >= 0 && s < n_here) row_of[s] = q;
    }
    __syncthreads();

    const W* in = feats + static_cast<int64_t>(b) * v * words;
    W* out = canvas + (static_cast<int64_t>(b) * n_slots + slot0) * words;
    const int total = n_here * words;
    // t = s * words + w, advanced by blockDim.x without a division
    const int step_s = blockDim.x / words, step_w = blockDim.x % words;
    int s = threadIdx.x / words, w = threadIdx.x % words;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
        const int row = row_of[s];
        W val{};
        if (row >= 0) val = in[static_cast<int64_t>(row) * words + w];
        out[t] = val;
        s += step_s;
        w += step_w;
        if (w >= words) {
            w -= words;
            ++s;
        }
    }
}

template <typename W>
cudaError_t launch(const void* feats, const void* keys, void* canvas, int b,
                   int v, int row_bytes, int n_slots, cudaStream_t stream) {
    const int words = row_bytes / static_cast<int>(sizeof(W));
    int slots_per_block = BLOCK_BYTES / row_bytes;
    slots_per_block = slots_per_block < 32 ? 32
                      : slots_per_block > 1024 ? 1024 : slots_per_block;
    const int blocks = (n_slots + slots_per_block - 1) / slots_per_block;
    if (blocks > 0 && b > 0) {
        scatter_rows_kernel<W><<<dim3(blocks, b), THREADS,
                                 slots_per_block * sizeof(int), stream>>>(
            static_cast<const W*>(feats), static_cast<const int*>(keys),
            static_cast<W*>(canvas), v, words, n_slots, slots_per_block);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" int scatter_rows_launch(const void* feats, const void* keys,
                                   void* canvas, int b, int v, int row_bytes,
                                   int n_slots, void* stream) {
    // a block's words (at least 32 slots of a row) must count in an int
    if (row_bytes < 1 || row_bytes > (1 << 26) || b < 0 || b > 65535 ||
        v < 0 || n_slots < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    const uintptr_t addr = reinterpret_cast<uintptr_t>(feats)
                           | reinterpret_cast<uintptr_t>(canvas)
                           | static_cast<uintptr_t>(row_bytes);
    cudaError_t err;
    if (addr % 16 == 0) {
        err = launch<uint4>(feats, keys, canvas, b, v, row_bytes, n_slots, s);
    } else if (addr % 4 == 0) {
        err = launch<uint32_t>(feats, keys, canvas, b, v, row_bytes, n_slots, s);
    } else if (addr % 2 == 0) {
        err = launch<uint16_t>(feats, keys, canvas, b, v, row_bytes, n_slots, s);
    } else {
        err = launch<uint8_t>(feats, keys, canvas, b, v, row_bytes, n_slots, s);
    }
    return static_cast<int>(err);
}
