// K1 pillar_vfe: the fused eval PillarVFE for Hopper (sm_90a).
//
// Replaces lidardetection_tpu/ops/vfe_tpu.py::pillar_vfe_fused (Pallas
// kernel _vfe_bd_kernel) and its any-P variant _pillar_vfe_fused_rowwise
// (_vfe_kernel). Any P >= 1 and any C <= 1024:
//
//   out[i, c] = relu(max(max_{p < cnt_i} sum_k xc[i, p, k] * W4[k, c] + pb[i, c],
//                        shift[c] if cnt_i < P))
//   xc = (vox[i, p] - ctr[i]) rounded to W4's type (bf16 or f32)
//   cnt_i clamped to [0, P]
//
// What bounds it on the H100: memory, and the latency of its loads. Per
// pillar it must read the count, and for a live pillar the center (16 B),
// the bias row (C * 4 B) and the points below the count (16 B each); it
// writes every output row (C * 2 B in bf16). A PointPillar scan fills about
// a quarter of the 40000 pillars, most with one or two points, and the
// voxelizer puts them first: three quarters of the rows are relu(shift),
// and the table's tail is empty.
//
// The design: a thread owns one pillar's VEC consecutive channels (VEC = 4
// where C is a multiple of 4 and the bias rows are 16-byte aligned, else 1),
// so G = C / VEC threads share a pillar and load its count, center and
// points as one broadcast each, the bias row as one float4 a thread. The
// grid is as many blocks as the SMs hold at once (fewer when the pillars
// run out), each thread striding over the pillars with its weights and
// shifts in registers for the whole kernel. An empty pillar's row is
// stored from registers with no other load; a live pillar's loads depend
// only on its count, which each thread fetches RING pillars ahead. No
// shared memory, no barrier, no warp-wide operation.
//
// Tried on the card and slower at one request and at four: a
// warp-cooperative kernel (a warp takes a tile of pillars with one count
// load and a ballot, batches the loads of its live pillars and moves the
// points to the channel lanes by shuffles), which needs about twice the
// registers and, with the live pillars packed at the table's front, walks
// them round after round in few warps; and prefetching the next pillar's
// loads as well as its count, which costs more occupancy than it gains.
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

constexpr int BLOCK = 128;  // threads a block, rounded down to whole pillars
constexpr int RING = 4;     // counts a thread loads ahead

template <typename T> struct Num;
template <> struct Num<float> {
    static __device__ __forceinline__ float to_f(float v) { return v; }
    static __device__ __forceinline__ float round(float v) { return v; }
    template <int VEC>
    static __device__ __forceinline__ void store(float* p, const float (&r)[VEC]) {
        if constexpr (VEC == 4) {
            *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
        } else {
            *p = r[0];
        }
    }
};
template <> struct Num<__nv_bfloat16> {
    static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
        return __bfloat162float(v);
    }
    static __device__ __forceinline__ float round(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
    template <int VEC>
    static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                                 const float (&r)[VEC]) {
        if constexpr (VEC == 4) {
            const __nv_bfloat162 lo = __floats2bfloat162_rn(r[0], r[1]);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(r[2], r[3]);
            *reinterpret_cast<uint2*>(p) =
                make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                           *reinterpret_cast<const unsigned*>(&hi));
        } else {
            *p = __float2bfloat16_rn(r[0]);
        }
    }
};

// ((x0*w0 + x1*w1) + x2*w2) + x3*w3, rounded after every operation
__device__ __forceinline__ float dot4(float4 x, float w0, float w1, float w2,
                                      float w3) {
    float z = __fmul_rn(x.x, w0);
    z = __fadd_rn(z, __fmul_rn(x.y, w1));
    z = __fadd_rn(z, __fmul_rn(x.z, w2));
    return __fadd_rn(z, __fmul_rn(x.w, w3));
}

template <typename WT, typename OT, int VEC>
__global__ void __launch_bounds__(VEC == 4 ? 256 : 1024)
pillar_vfe_kernel(const float4* __restrict__ vox, const float4* __restrict__ ctr,
                  const float* __restrict__ pb, const int* __restrict__ cnt,
                  const WT* __restrict__ w4, const float* __restrict__ shift,
                  OT* __restrict__ out, int64_t n_pillars, int P, int C) {
    const int g = C / VEC;  // threads a pillar
    const int per_block = blockDim.x / g;
    const int c0 = VEC * (threadIdx.x % g);  // channels c0 .. c0 + VEC - 1

    float w[4][VEC], sh[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k][e] = Num<WT>::to_f(w4[k * C + c0 + e]);
        sh[e] = shift[c0 + e];
    }

    const int64_t stride = static_cast<int64_t>(gridDim.x) * per_block;
    const int64_t first =
        static_cast<int64_t>(blockIdx.x) * per_block + threadIdx.x / g;
    const auto count = [&](int64_t i) { return i < n_pillars ? cnt[i] : 0; };
    int raw[RING];  // the counts of this thread's next RING pillars
#pragma unroll
    for (int d = 0; d < RING; ++d) raw[d] = count(first + d * stride);
    for (int64_t i0 = first; i0 < n_pillars; i0 += RING * stride) {
#pragma unroll
        for (int d = 0; d < RING; ++d) {
            const int64_t i = i0 + d * stride;
            if (i >= n_pillars) break;
            const int n = raw[d] < 0 ? 0 : (raw[d] > P ? P : raw[d]);
            raw[d] = count(i + RING * stride);
            float r[VEC];
            if (n == 0) {  // max(-inf, shift): relu(shift)
#pragma unroll
                for (int e = 0; e < VEC; ++e) r[e] = fmaxf(sh[e], 0.f);
            } else {
                const float4 o = ctr[i];
                float b[VEC];
                if constexpr (VEC == 4) {
                    const float4 b4 = *reinterpret_cast<const float4*>(pb + i * C + c0);
                    b[0] = b4.x, b[1] = b4.y, b[2] = b4.z, b[3] = b4.w;
                } else {
                    b[0] = pb[i * C + c0];
                }
                const float4* row = vox + i * P;
                float m[VEC];
#pragma unroll
                for (int e = 0; e < VEC; ++e) m[e] = -CUDART_INF_F;
#pragma unroll 4
                for (int p = 0; p < n; ++p) {
                    const float4 v = row[p];
                    const float4 x = make_float4(
                        Num<WT>::round(v.x - o.x), Num<WT>::round(v.y - o.y),
                        Num<WT>::round(v.z - o.z), Num<WT>::round(v.w - o.w));
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
                        m[e] = fmaxf(m[e], dot4(x, w[0][e], w[1][e], w[2][e], w[3][e]));
                }
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    r[e] = __fadd_rn(m[e], b[e]);
                    if (n < P) r[e] = fmaxf(r[e], sh[e]);
                    r[e] = fmaxf(r[e], 0.f);
                }
            }
            Num<OT>::template store<VEC>(out + i * C + c0, r);
        }
    }
}

// channels a thread for C and this bias pointer: 4, or 1 on the scalar path
int vec_for(int C, const void* pb) {
    return C % 4 == 0 && reinterpret_cast<uintptr_t>(pb) % 16 == 0 ? 4 : 1;
}

template <typename WT, typename OT, int VEC>
void launch_vec(const void* vox, const void* ctr, const void* pb,
                const void* cnt, const void* w4, const void* shift, void* out,
                int64_t n_pillars, int P, int C, cudaStream_t stream) {
    // the resident blocks an SM holds at this block size, and the SM count,
    // read once (a grid too small or too large is slower, never wrong)
    static int cached_threads = 0, per_sm = 0, sms = 0;
    const int g = C / VEC;
    const int per_block = g < BLOCK ? BLOCK / g : 1;
    const int threads = g * per_block;
    const auto kernel = pillar_vfe_kernel<WT, OT, VEC>;
    if (threads != cached_threads) {
        int b = 0, dev = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, threads, 0);
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        per_sm = b > 0 ? b : 1;
        cached_threads = threads;
    }
    const int64_t want = (n_pillars + per_block - 1) / per_block;
    const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * per_sm;
    kernel<<<static_cast<unsigned>(want < cap ? want : cap), threads, 0, stream>>>(
        static_cast<const float4*>(vox), static_cast<const float4*>(ctr),
        static_cast<const float*>(pb), static_cast<const int*>(cnt),
        static_cast<const WT*>(w4), static_cast<const float*>(shift),
        static_cast<OT*>(out), n_pillars, P, C);
}

template <typename WT, typename OT>
cudaError_t launch(const void* vox, const void* ctr, const void* pb,
                   const void* cnt, const void* w4, const void* shift,
                   void* out, int64_t n_pillars, int P, int C,
                   cudaStream_t stream) {
    if (n_pillars > 0) {
        if (vec_for(C, pb) == 4) {
            launch_vec<WT, OT, 4>(vox, ctr, pb, cnt, w4, shift, out, n_pillars, P, C, stream);
        } else {
            launch_vec<WT, OT, 1>(vox, ctr, pb, cnt, w4, shift, out, n_pillars, P, C, stream);
        }
    }
    return cudaGetLastError();
}

}  // namespace

// channels a thread takes for C with a 16-byte aligned bias row: 4, or 1
// where C takes the scalar path
extern "C" int pillar_vfe_channels_per_thread(int C) {
    return vec_for(C, nullptr);
}

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
