// T: the 2-D maps' tail, shared by the combine and the batched step.
//
// No TPU kernel: the port's own. It replaces what the JAX package hands to
// XLA after the column maps (gvom_tpu/models/pipeline.py:380-389 and
// :442-458, gvom_tpu/parallel/sharding.py:319-331): the torus → window
// moves of the maps, the window → torus moves of the slopes, the positive
// obstacle from the band sums, the negative obstacle and the visibility.
// The port ran them as about 40 eager PyTorch launches (index gathers,
// remainders, aranges, and the float64 fma32 / sqrt32 emulation of the
// steepness test). Plain twins: ops/maps2d.py maps_to_window_plain and
// map_products_plain.
//
// Two entries, one thread a cell of the [X, Y] map:
//   gvom_maps_to_window  window[r] = torus[(r + origin) mod size] of the
//                        height and the inferred height, in one launch;
//   gvom_map_products    the positive obstacle, the negative obstacle and the
//                        visibility in window layout. A window cell reads
//                        its band sums at its torus index and its slopes at
//                        its own: the products are elementwise, so reading
//                        at the permuted index is bitwise the old round
//                        trip. steep = sqrt(fma(sx, sx, sy·sy)) >= threshold
//                        (__fsqrt_rn, __fmaf_rn); density = num / den
//                        (__fdiv_rn) where den > 0; 100·density truncated
//                        to an int, as the twin's .to(torch.int32) does (the
//                        density lies in [0, 1], num <= den).
//
// Bound on the H100: bytes, about 41 B a cell of the maps (a 65,536-cell
// map: 0.001 ms at 3.35 TB/s). Both are short launches whose time is
// latency, like the stencils'.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// (r + o) mod n in 64 bits, as the twin's int64 index arithmetic
__device__ __forceinline__ int torus_index(int r, int o, int n) {
    int64_t t = ((int64_t)r + (int64_t)o) % n;
    return (int)(t < 0 ? t + n : t);
}

__global__ void to_window_kernel(const float* __restrict__ hm_t, const float* __restrict__ ihm_t,
                                 const int* __restrict__ origin, int X, int Y,
                                 float* __restrict__ hm, float* __restrict__ ihm)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (int64_t)X * Y) return;
    const int rx = (int)(i / Y), ry = (int)(i % Y);
    const int64_t t = (int64_t)torus_index(rx, origin[0], X) * Y + torus_index(ry, origin[1], Y);
    hm[i] = hm_t[t];
    ihm[i] = ihm_t[t];
}

__global__ void products_kernel(const int* __restrict__ pnum, const int* __restrict__ pden,
                                const int* __restrict__ bok,
                                const float* __restrict__ sx, const float* __restrict__ sy,
                                const float* __restrict__ ghd, const float* __restrict__ hm,
                                const int* __restrict__ origin, int X, int Y,
                                float slope_thr, float neg_thr, float unknown,
                                int* __restrict__ pos, int* __restrict__ neg, int* __restrict__ vis)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (int64_t)X * Y) return;
    const int rx = (int)(i / Y), ry = (int)(i % Y);
    const int64_t t = (int64_t)torus_index(rx, origin[0], X) * Y + torus_index(ry, origin[1], Y);
    const float a = sx[i], b = sy[i];
    const bool steep = __fsqrt_rn(__fmaf_rn(a, a, __fmul_rn(b, b))) >= slope_thr;
    const float num = __int2float_rn(pnum[t]), den = __int2float_rn(pden[t]);
    const float dens = den > 0.0f ? __fdiv_rn(num, den) : 0.0f;
    const int val = __float2int_rz(__fmul_rn(dens, 100.0f));
    pos[i] = steep ? 100 : (bok[t] > 0 ? val : 0);
    neg[i] = ghd[i] > neg_thr ? 100 : 0;
    vis[i] = hm[i] > unknown ? 1 : 0;
}

unsigned blocks_for(int64_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace

extern "C" int gvom_maps_to_window(const void* hm_t, const void* ihm_t, const void* origin, int X, int Y,
                                   void* hm, void* ihm, void* stream)
{
    to_window_kernel<<<blocks_for((int64_t)X * Y, 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)hm_t, (const float*)ihm_t, (const int*)origin, X, Y, (float*)hm, (float*)ihm);
    return (int)cudaGetLastError();
}

extern "C" int gvom_map_products(const void* pnum, const void* pden, const void* bok,
                                 const void* sx, const void* sy, const void* ghd, const void* hm,
                                 const void* origin, int X, int Y, float slope_thr, float neg_thr, float unknown,
                                 void* pos, void* neg, void* vis, void* stream)
{
    products_kernel<<<blocks_for((int64_t)X * Y, 256), 256, 0, (cudaStream_t)stream>>>(
        (const int*)pnum, (const int*)pden, (const int*)bok, (const float*)sx, (const float*)sy, (const float*)ghd,
        (const float*)hm, (const int*)origin, X, Y, slope_thr, neg_thr, unknown, (int*)pos, (int*)neg, (int*)vis);
    return (int)cudaGetLastError();
}
