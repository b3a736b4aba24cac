// K1 pillar_vfe: the fused eval PillarVFE for Hopper (sm_90a).
//
// Replaces lidardetection_tpu/ops/vfe_tpu.py::pillar_vfe_fused (Pallas
// kernel _vfe_bd_kernel) and its any-P variant _pillar_vfe_fused_rowwise
// (_vfe_kernel). One kernel covers any P and any C <= 1024:
//
//   out[i, c] = relu(max(max_{p < cnt_i} sum_k xc[i, p, k] * W4[k, c] + pb[i, c],
//                        shift[c] if cnt_i < P))
//   xc = (vox[i, p] - ctr[i]) rounded to W4's type (bf16 or f32)
//
// What bounds it on the H100: memory. Per pillar it must read the count,
// the valid points (16 B each), the center (16 B) and the bias row
// (C * 4 B), and write the output row (C * 2 B in bf16); the products are
// ~16 kFLOP per full pillar, negligible against 3.35 TB/s. The design
// moves only those bytes: the (pillars, P, C) point activations live in
// registers, one channel per thread, and never reach memory; only points
// below the count are loaded (most pillars of a real scan hold a few
// points of the 32), and a pillar with count 0 reads nothing but its
// count. A block takes PPB pillars x C channels (4 x 64 on the PointPillar
// path); the centered points are staged in shared memory in tiles of 32
// and read back as broadcasts by the pillar's C threads.
//
// Arithmetic order matches pillar_vfe_plain in ops/vfe_cuda.py exactly:
// ((x0*w0 + x1*w1) + x2*w2) + x3*w3 with no fused multiply-add, max over
// points, then + pb. In bf16 the products are exact in f32, so the two
// agree bit for bit in either type.
//
// C interface, loaded with ctypes: pillar_vfe_launch returns the CUDA
// error code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int TILE_P = 32;   // points staged per pillar per round
constexpr int MAX_PPB = 64;  // pillars per block: bounds shared memory

template <typename T> struct Num;
template <> struct Num<float> {
    static __device__ __forceinline__ float to_f(float v) { return v; }
    static __device__ __forceinline__ float from_f(float v) { return v; }
    static __device__ __forceinline__ float round(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
    static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
        return __bfloat162float(v);
    }
    static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
        return __float2bfloat16_rn(v);
    }
    static __device__ __forceinline__ float round(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
};

__device__ __forceinline__ int clamp_count(int n, int p) {
    return n < 0 ? 0 : (n > p ? p : n);
}

template <typename WT, typename OT>
__global__ void pillar_vfe_kernel(const float4* __restrict__ vox,
                                  const float4* __restrict__ ctr,
                                  const float* __restrict__ pb,
                                  const int* __restrict__ cnt,
                                  const WT* __restrict__ w4,
                                  const float* __restrict__ shift,
                                  OT* __restrict__ out,
                                  int64_t n_pillars, int P, int C) {
    __shared__ float4 s_pts[MAX_PPB * TILE_P];
    __shared__ float4 s_ctr[MAX_PPB];
    __shared__ int s_cnt[MAX_PPB];

    const int ppb = blockDim.y;
    const int c = threadIdx.x;  // channel; blockDim.x == C
    const int j = threadIdx.y;  // pillar within the block
    const int tid = j * blockDim.x + c;
    const int nthreads = blockDim.x * blockDim.y;
    const int64_t pillar0 = static_cast<int64_t>(blockIdx.x) * ppb;
    const int64_t pillar = pillar0 + j;
    const bool live = pillar < n_pillars;

    for (int q = tid; q < ppb; q += nthreads) {
        const int64_t pq = pillar0 + q;
        const int n = pq < n_pillars ? clamp_count(cnt[pq], P) : 0;
        s_cnt[q] = n;
        s_ctr[q] = n > 0 ? ctr[pq] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    int n_max = 0;
    for (int q = 0; q < ppb; ++q) n_max = max(n_max, s_cnt[q]);
    const int n = s_cnt[j];

    const float w0 = Num<WT>::to_f(w4[c]);
    const float w1 = Num<WT>::to_f(w4[C + c]);
    const float w2 = Num<WT>::to_f(w4[2 * C + c]);
    const float w3 = Num<WT>::to_f(w4[3 * C + c]);

    float m = -CUDART_INF_F;
    for (int base = 0; base < n_max; base += TILE_P) {
        __syncthreads();  // the previous tile has been consumed
        for (int s = tid; s < ppb * TILE_P; s += nthreads) {
            const int q = s / TILE_P;
            const int p = base + s % TILE_P;
            if (p < s_cnt[q]) {
                const float4 v = vox[(pillar0 + q) * P + p];
                const float4 o = s_ctr[q];
                s_pts[s] = make_float4(Num<WT>::round(v.x - o.x),
                                       Num<WT>::round(v.y - o.y),
                                       Num<WT>::round(v.z - o.z),
                                       Num<WT>::round(v.w - o.w));
            }
        }
        __syncthreads();
        const int lim = min(TILE_P, n - base);
        for (int p = 0; p < lim; ++p) {
            const float4 x = s_pts[j * TILE_P + p];
            float z = __fmul_rn(x.x, w0);
            z = __fadd_rn(z, __fmul_rn(x.y, w1));
            z = __fadd_rn(z, __fmul_rn(x.z, w2));
            z = __fadd_rn(z, __fmul_rn(x.w, w3));
            m = fmaxf(m, z);
        }
    }
    if (!live) return;
    float r = n > 0 ? __fadd_rn(m, pb[pillar * C + c]) : -CUDART_INF_F;
    if (n < P) r = fmaxf(r, shift[c]);
    out[pillar * C + c] = Num<OT>::from_f(fmaxf(r, 0.f));
}

template <typename WT, typename OT>
cudaError_t launch(const void* vox, const void* ctr, const void* pb,
                   const void* cnt, const void* w4, const void* shift,
                   void* out, int64_t n_pillars, int P, int C,
                   cudaStream_t stream) {
    int ppb = 256 / C;
    ppb = ppb < 1 ? 1 : (ppb > MAX_PPB ? MAX_PPB : ppb);
    const dim3 block(C, ppb);
    const int64_t blocks = (n_pillars + ppb - 1) / ppb;
    if (blocks > 0) {
        pillar_vfe_kernel<WT, OT><<<static_cast<unsigned>(blocks), block, 0,
                                    stream>>>(
            static_cast<const float4*>(vox), static_cast<const float4*>(ctr),
            static_cast<const float*>(pb), static_cast<const int*>(cnt),
            static_cast<const WT*>(w4), static_cast<const float*>(shift),
            static_cast<OT*>(out), n_pillars, P, C);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" int pillar_vfe_launch(const void* vox, const void* ctr,
                                 const void* pb, const void* cnt,
                                 const void* w4, const void* shift, void* out,
                                 long long n_pillars, int P, int C,
                                 int w_bf16, int out_bf16, void* stream) {
    if (C < 1 || C > 1024 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (w_bf16 && out_bf16) {
        err = launch<__nv_bfloat16, __nv_bfloat16>(vox, ctr, pb, cnt, w4, shift,
                                                   out, n_pillars, P, C, s);
    } else if (w_bf16) {
        err = launch<__nv_bfloat16, float>(vox, ctr, pb, cnt, w4, shift, out,
                                           n_pillars, P, C, s);
    } else if (out_bf16) {
        err = launch<float, __nv_bfloat16>(vox, ctr, pb, cnt, w4, shift, out,
                                           n_pillars, P, C, s);
    } else {
        err = launch<float, float>(vox, ctr, pb, cnt, w4, shift, out,
                                   n_pillars, P, C, s);
    }
    return static_cast<int>(err);
}
