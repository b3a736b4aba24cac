// K2 scatter_rows: key-addressed row scatter into a zeroed BEV canvas, for
// Hopper (sm_90a).
//
// Replaces lidardetection_tpu/ops/scatter_tpu.py::_scatter_pallas (Pallas
// kernel _tile_kernel), the forward of scatter_rows_sorted:
//
//   canvas[b, keys[b, v], :] = feats[b, v, :]   for 0 <= keys[b, v] < n_slots
//
// Rows keyed outside [0, n_slots) (the padding rows, keyed n_slots) are
// dropped. Keys are unique among kept rows, so no two threads write one
// slot and no atomics are needed. The TPU kernel's sorted-key tile windows
// and one-hot matmuls exist because XLA:TPU serialises row scatters;
// Hopper stores rows natively, so sortedness is the caller's contract and
// this kernel does not need it.
//
// What bounds it on the H100: memory. The canvas (zero-filled by the
// caller) is written once, 27.4 MB for one 496 x 432 x 64 bf16 sample,
// and only the kept rows are read. One thread moves one 16-byte word of
// one row (8 threads per 128-byte bf16 row), so each row is read and
// written with full 16-byte accesses; a row whose size or address is not
// a multiple of 16 bytes falls back to 4-, 2- or 1-byte words.
//
// C interface, loaded with ctypes: scatter_rows_launch returns the CUDA
// error code of the launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename W>
__global__ void scatter_rows_kernel(const W* __restrict__ feats,
                                    const int* __restrict__ keys,
                                    W* __restrict__ canvas, int64_t n_rows,
                                    int64_t rows_per_sample, int words,
                                    int n_slots) {
    const int64_t total = n_rows * words;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const int64_t row = t / words;
        const int key = keys[row];
        if (key < 0 || key >= n_slots) continue;
        const int64_t b = row / rows_per_sample;
        const int64_t w = t - row * words;
        canvas[(b * n_slots + key) * words + w] = feats[t];
    }
}

template <typename W>
cudaError_t launch(const void* feats, const void* keys, void* canvas,
                   int64_t n_rows, int64_t rows_per_sample, int row_bytes,
                   int n_slots, cudaStream_t stream) {
    const int words = row_bytes / static_cast<int>(sizeof(W));
    const int64_t total = n_rows * words;
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 65535 * 32) blocks = 65535 * 32;  // grid-stride beyond this
    if (blocks > 0) {
        scatter_rows_kernel<W><<<static_cast<unsigned>(blocks), threads, 0,
                                 stream>>>(
            static_cast<const W*>(feats), static_cast<const int*>(keys),
            static_cast<W*>(canvas), n_rows, rows_per_sample, words, n_slots);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" int scatter_rows_launch(const void* feats, const void* keys,
                                   void* canvas, long long n_rows,
                                   long long rows_per_sample, int row_bytes,
                                   int n_slots, void* stream) {
    if (row_bytes < 1 || rows_per_sample < 1 || n_slots < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    const uintptr_t addr = reinterpret_cast<uintptr_t>(feats)
                           | reinterpret_cast<uintptr_t>(canvas)
                           | static_cast<uintptr_t>(row_bytes);
    cudaError_t err;
    if (addr % 16 == 0) {
        err = launch<uint4>(feats, keys, canvas, n_rows, rows_per_sample,
                            row_bytes, n_slots, s);
    } else if (addr % 4 == 0) {
        err = launch<uint32_t>(feats, keys, canvas, n_rows, rows_per_sample,
                               row_bytes, n_slots, s);
    } else if (addr % 2 == 0) {
        err = launch<uint16_t>(feats, keys, canvas, n_rows, rows_per_sample,
                               row_bytes, n_slots, s);
    } else {
        err = launch<uint8_t>(feats, keys, canvas, n_rows, rows_per_sample,
                              row_bytes, n_slots, s);
    }
    return static_cast<int>(err);
}
