// Building blocks shared by the tensor-core paths of K3 (sparse_conv.cu) and
// K4 (sparse_conv_dw.cu), in inline PTX with no CUTLASS include:
// asynchronous row copies into shared memory (cp.async, with zero-fill for
// a miss), 8x8 matrix loads from shared memory (ldmatrix, plain and
// transposed) and the bf16 product m16n8k16 with f32 accumulators
// (mma.sync). Fragment layouts, for lane l, g = l / 4, t = l % 4:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..);
//   B (16 x 8, k x n): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C (16 x 8, f32): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (4, 8 or 16) from global to shared memory without the
// registers; with `fill` false nothing is read and the bytes are zeros
// (src must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool fill) {
    const int src_bytes = fill ? BYTES : 0;
    if constexpr (BYTES == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES),
                        "r"(src_bytes) : "memory");
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The same with N known only at run time (0 <= n <= 7).
__device__ __forceinline__ void cp_async_wait_n(int n) {
    switch (n) {
        case 0: cp_async_wait<0>(); break;
        case 1: cp_async_wait<1>(); break;
        case 2: cp_async_wait<2>(); break;
        case 3: cp_async_wait<3>(); break;
        case 4: cp_async_wait<4>(); break;
        case 5: cp_async_wait<5>(); break;
        case 6: cp_async_wait<6>(); break;
        default: cp_async_wait<7>(); break;
    }
}

// Copies `n` bf16 values from global src to shared dst in units of `vec`
// bytes (16, 8 or 4 when both addresses and n * 2 allow it), or element by
// element (vec 2, a synchronous copy) otherwise; part `u0` of `parts` of
// the units, so that several threads share one row. fill false writes
// zeros and reads nothing.
__device__ __forceinline__ void copy_row_part(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src, int n,
                                              int vec, bool fill, int u0,
                                              int parts) {
    if (vec == 16) {
        for (int u = u0; u < n / 8; u += parts)
            cp_async<16>(dst + u * 8, src + u * 8, fill);
    } else if (vec == 8) {
        for (int u = u0; u < n / 4; u += parts)
            cp_async<8>(dst + u * 4, src + u * 4, fill);
    } else if (vec == 4) {
        for (int u = u0; u < n / 2; u += parts)
            cp_async<4>(dst + u * 2, src + u * 2, fill);
    } else {
        const __nv_bfloat16 zero = __float2bfloat16(0.0f);
        for (int u = u0; u < n; u += parts) dst[u] = fill ? src[u] : zero;
    }
}

// The widest unit (16, 8, 4 or 2 bytes) that divides the row pitch, the
// column offset and the base address of a bf16 matrix.
inline int copy_unit(const void* base, int pitch_elems, int col0_elems) {
    const uintptr_t v = reinterpret_cast<uintptr_t>(base)
        | static_cast<uintptr_t>(pitch_elems) * 2
        | static_cast<uintptr_t>(col0_elems) * 2;
    return (v % 16 == 0) ? 16 : (v % 8 == 0) ? 8 : (v % 4 == 0) ? 4 : 2;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device. The attribute is set once per device and kernel (`set_bytes`
// holds what each device allows so far), not at every launch.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int bytes,
                                      int (&set_bytes)[64]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 64 && set_bytes[dev] >= bytes) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < 64) set_bytes[dev] = bytes;
    return err;
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// d += a * b for one 16 x 8 tile, reduction depth 16, bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma_sm90
