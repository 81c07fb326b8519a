// The 3×3 plane fit of the 2-D maps, whole, with the maps' move to the window
// layout as its load: from the torus-layout column maps (the height and the
// inferred height that K4 or the batched merge writes) to the window-layout
// height and inferred height, roughness, slope_x and slope_y, one launch,
// one thread a map cell.
//
// No TPU kernel: the JAX package computes the fit in XLA
// (gvom_tpu/ops/maps2d.py:129-179, slope_and_roughness), after moving the
// maps to the window layout (torus_to_window, gvom_tpu/models/pipeline.py:
// 382-383). The kernel is bitwise its plain twin,
// gvom_tpu_torch/ops/maps2d.py::plane_fit_window_plain (maps_to_window_plain,
// then plane_fit_plain: plane_fit_inputs and plane_fit_tail_plain), which is
// bitwise the JAX package's compiled CPU result:
//   * the window layout: window[r] = torus[(r + origin) mod size], a copy of
//     the bits, as maps_to_window_plain's gather;
//   * the fit (plane_fit_inputs): nine shifted neighbours with zeros outside
//     the map, cnt and sz as plain adds in (di, dj) order, every other sum a
//     chain of fused multiply-adds as XLA contracts it (_fma_sum), the
//     centered moments, det, a = n/det and a/m as n/(det·m), op for op;
//   * the tail: log32 is XLA:CPU's float32 log (the Cephes logf polynomial
//     that XLA inlines, with the fused multiply-adds that LLVM makes of it);
//     atan2_32 is glibc's atan2f (fdlibm e_atan2f.c on s_atanf.c), which
//     jnp.arctan2 calls, SSE code without FMAs; both under XLA's
//     denormals-are-zero and flush-to-zero.
// Every rounding is written out: __fmaf_rn where the twin calls grid.fma32
// (Hopper's fma is the correctly rounded one that fma32 emulates in float64),
// __fsqrt_rn for grid.sqrt32, __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn
// elsewhere (and the build passes -fmad=false), so nvcc contracts nothing.
// CUDA's logf and atan2f are not used: they round otherwise.
//
// What bounds it on the H100: bytes. The two torus maps are read once and
// five maps written: 28 bytes a cell, 1.8 MB at 256×256. Its ~150 float32
// operations a cell (the fit, a log, two atan2) are far below the float32
// rate. Design: a block stages its 16×16 tile and a one-cell halo of the
// height map in shared memory, each cell read at its torus index (outside
// the window: unknown, so k = z = 0 as the twin's zero fill), writes its
// cells' window heights and inferred heights, then each thread runs the
// whole chain in registers. The window layout is this load rather than a
// launch of its own: the fit reads the window map's halo anyway, and a torus
// index costs it an add and a compare.
//
// A second entry, gvom_plane_fit_tail, is the tail alone on given fit
// outputs (the twin plane_fit_tail_plain): it is off the map path and lets a
// seeded sweep cover the tail's whole domain (subnormal, zero and negative
// residuals, coefficients over many decades).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float FLT_MIN_ = 1.17549435e-38f;   // 2^-126

__device__ __forceinline__ float bits(uint32_t b) { return __uint_as_float(b); }

// XLA:CPU's log, op for op (see grid.py::log32)
__device__ float log32(float x)
{
    if (fabsf(x) < FLT_MIN_) return -CUDART_INF_F;           // ±0 or subnormal (denormals are zero)
    if (!(x >= 0.0f)) return bits(0xFFFFFFFFu);              // negative or NaN: all-ones NaN
    if (x == CUDART_INF_F) return CUDART_INF_F;
    const uint32_t b = __float_as_uint(x);
    float e = __fadd_rn((float)((int)(b >> 23) - 127), 1.0f);
    const float m = __uint_as_float((b & 0x807FFFFFu) | 0x3F000000u);
    const bool below = m < bits(0x3F3504F3u);               // sqrt(1/2)
    e = __fsub_rn(e, below ? 1.0f : 0.0f);
    const float t = __fadd_rn(__fsub_rn(m, 1.0f), below ? m : 0.0f);
    const float t2 = __fmul_rn(t, t);
    const float t3 = __fmul_rn(t2, t);
    float a = __fmaf_rn(t, bits(0x3D9021BBu), bits(0xBDEBD1B8u));
    float p = __fmaf_rn(t, bits(0xBDFE5D4Fu), bits(0x3E11E9BFu));
    float c = __fmaf_rn(t, bits(0x3E4CCEACu), bits(0xBE7FFFFCu));
    a = __fmaf_rn(a, t, bits(0x3DEF251Au));
    p = __fmaf_rn(p, t, bits(0xBE2AAE50u));
    c = __fmaf_rn(c, t, bits(0x3EAAAAAAu));
    float y = __fmaf_rn(__fmaf_rn(a, t3, p), t3, c);
    const float r = __fmaf_rn(y, t3, __fmul_rn(e, bits(0xB95E8083u)));    // ln2 lo
    const float u = __fmaf_rn(t2, -0.5f, t);
    return __fmaf_rn(e, bits(0x3F318000u), __fadd_rn(u, r));             // ln2 hi
}

__device__ __forceinline__ float flush(float v) { return fabsf(v) < FLT_MIN_ ? __fmul_rn(v, 0.0f) : v; }

__constant__ float ATAN_HI[4] = {4.6364760399e-01f, 7.8539812565e-01f, 9.8279368877e-01f, 1.5707962513e+00f};
__constant__ float ATAN_LO[4] = {5.0121582440e-09f, 3.7748947079e-08f, 3.4473217170e-08f, 7.5497894159e-08f};

// glibc's atanf (see grid.py::_atanf)
__device__ float atanf32(float t)
{
    const int32_t hx = __float_as_int(t);
    const int32_t ix = hx & 0x7FFFFFFF;
    if (ix > 0x7F800000) return __fadd_rn(t, t);
    if (ix >= 0x4C000000) {
        const float v = __fadd_rn(ATAN_HI[3], ATAN_LO[3]);
        return hx < 0 ? -v : v;
    }
    if (ix < 0x31000000) return t;
    int id = -1;
    float r = t;
    if (ix >= 0x3EE00000) {
        const float a = fabsf(t);
        if (ix < 0x3F300000) {
            id = 0;
            r = __fdiv_rn(__fsub_rn(__fadd_rn(a, a), 1.0f), __fadd_rn(a, 2.0f));
        } else if (ix < 0x3F980000) {
            id = 1;
            r = __fdiv_rn(__fsub_rn(a, 1.0f), __fadd_rn(a, 1.0f));
        } else if (ix < 0x401C0000) {
            id = 2;
            r = __fdiv_rn(__fsub_rn(a, 1.5f), __fadd_rn(__fmul_rn(a, 1.5f), 1.0f));
        } else {
            id = 3;
            r = __fdiv_rn(-1.0f, a);
        }
    }
    const float z = __fmul_rn(r, r);
    const float w = __fmul_rn(z, z);
    float s1 = bits(0x3C8569D7u);
    s1 = __fadd_rn(__fmul_rn(s1, w), bits(0x3D4BDA59u));
    s1 = __fadd_rn(__fmul_rn(s1, w), bits(0x3D886B35u));
    s1 = __fadd_rn(__fmul_rn(s1, w), bits(0x3DBA2E6Eu));
    s1 = __fadd_rn(__fmul_rn(s1, w), bits(0x3E124925u));
    s1 = __fadd_rn(__fmul_rn(s1, w), bits(0x3EAAAAABu));
    s1 = __fmul_rn(s1, z);
    float s2 = bits(0xBD15A221u);
    s2 = __fadd_rn(__fmul_rn(s2, w), bits(0xBD6EF16Bu));
    s2 = __fadd_rn(__fmul_rn(s2, w), bits(0xBD9D8795u));
    s2 = __fadd_rn(__fmul_rn(s2, w), bits(0xBDE38E38u));
    s2 = __fadd_rn(__fmul_rn(s2, w), bits(0xBE4CCCCDu));
    s2 = __fmul_rn(s2, w);
    const float q = __fmul_rn(__fadd_rn(s1, s2), r);
    if (id < 0) return __fsub_rn(r, q);
    const float v = __fsub_rn(ATAN_HI[id], __fsub_rn(__fsub_rn(q, ATAN_LO[id]), r));
    return hx < 0 ? -v : v;
}

// glibc's atan2f (see grid.py::atan2_32)
__device__ float atan2_32(float y, float x)
{
    const float PI = bits(0x40490FDBu), PI_O_2 = bits(0x3FC90FDBu), PI_O_4 = bits(0x3F490FDBu);
    const float PI_LO = bits(0xB3BBBD2Eu);
    const int32_t hx = __float_as_int(x), hy = __float_as_int(y);
    const int32_t ix = hx & 0x7FFFFFFF, iy = hy & 0x7FFFFFFF;
    if (ix > 0x7F800000 || iy > 0x7F800000) return __fadd_rn(x, y);
    if (hx == 0x3F800000) return atanf32(y);
    const bool nx = hx < 0, ny = hy < 0;
    if (iy == 0) return nx ? (ny ? -PI : PI) : y;
    if (ix == 0) return ny ? -PI_O_2 : PI_O_2;
    if (ix == 0x7F800000) {
        if (iy == 0x7F800000) {
            const float three = __fmul_rn(3.0f, PI_O_4);
            return nx ? (ny ? -three : three) : (ny ? -PI_O_4 : PI_O_4);
        }
        return nx ? (ny ? -PI : PI) : (ny ? -0.0f : 0.0f);
    }
    if (iy == 0x7F800000) return ny ? -PI_O_2 : PI_O_2;
    const int32_t d = iy - ix;
    float z;
    if (d > 0x1E7FFFFF) z = __fsub_rn(PI_O_2, bits(0x333BBD2Eu));      // pi/2 + pi_lo/2
    else if (nx && (d >> 23) < -60) z = 0.0f;
    else z = atanf32(fabsf(flush(__fdiv_rn(flush(y), flush(x)))));
    if (!nx) return ny ? -z : z;
    return ny ? __fsub_rn(__fsub_rn(z, PI_LO), PI) : __fsub_rn(PI, __fsub_rn(z, PI_LO));
}

constexpr int TILE = 16;   // a block's cells per side, one thread each

// (rough, slope_x, slope_y) of one cell from its fit, as plane_fit_tail_plain
__device__ __forceinline__ void fit_tail(bool ok, float e, float a0n, float a1n, float im, float* rough,
                                         float* slope_x, float* slope_y)
{
    if (ok) {
        *rough = e > 0.0f ? log32(e) : e;
        *slope_x = atan2_32(a0n, im);
        *slope_y = atan2_32(a1n, im);
    } else {
        *rough = -1.0f;
        *slope_x = 0.0f;
        *slope_y = 0.0f;
    }
}

// r + om with om = origin mod n, r in [0, n): the torus index of window row r
__device__ __forceinline__ int torus(int r, int om, int n)
{
    const int t = r + om;
    return t >= n ? t - n : t;
}

__device__ __forceinline__ int pmod(int a, int n)
{
    const int r = a % n;
    return r < 0 ? r + n : r;
}

__global__ void __launch_bounds__(TILE * TILE) plane_fit_kernel(
    const float* __restrict__ hm_t, const float* __restrict__ ihm_t, const int* __restrict__ origin,
    int X, int Y, float res, float unknown,
    float* __restrict__ hm, float* __restrict__ ihm,
    float* __restrict__ rough, float* __restrict__ slope_x, float* __restrict__ slope_y)
{
    __shared__ float tile[TILE + 2][TILE + 2];
    const int x0 = blockIdx.y * TILE, y0 = blockIdx.x * TILE;
    const int ox = pmod(origin[0], X), oy = pmod(origin[1], Y);
    for (int t = threadIdx.y * TILE + threadIdx.x; t < (TILE + 2) * (TILE + 2); t += TILE * TILE) {
        const int r = t / (TILE + 2), c = t % (TILE + 2);
        const int x = x0 + r - 1, y = y0 + c - 1;
        tile[r][c] = (x >= 0 && x < X && y >= 0 && y < Y) ? hm_t[(size_t)torus(x, ox, X) * Y + torus(y, oy, Y)]
                                                          : unknown;
    }
    __syncthreads();
    const int x = x0 + threadIdx.y, y = y0 + threadIdx.x;
    if (x >= X || y >= Y) return;
    const size_t i = (size_t)x * Y + y;
    hm[i] = tile[threadIdx.y + 1][threadIdx.x + 1];
    ihm[i] = ihm_t[(size_t)torus(x, ox, X) * Y + torus(y, oy, Y)];

    // the nine offsets in the twin's order: di = -1..1, then dj = -1..1
    float cnt = 0.0f, sz = 0.0f, sx = 0.0f, sy = 0.0f, sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
    float sxz = 0.0f, syz = 0.0f, szz = 0.0f;
    float k1 = 0.0f, z1 = 0.0f, dx1 = 0.0f, dy1 = 0.0f;   // the first term, for _fma_sum's pairing
#pragma unroll
    for (int t = 0; t < 9; ++t) {
        const int di = t / 3 - 1, dj = t % 3 - 1;
        const float h = tile[threadIdx.y + 1 + di][threadIdx.x + 1 + dj];
        const bool known = h > unknown;
        const float k = known ? 1.0f : 0.0f;
        const float z = known ? h : 0.0f;
        const float dx = __fmul_rn((float)di, res), dy = __fmul_rn((float)dj, res);
        const float dxx = __fmul_rn(dx, dx), dxy = __fmul_rn(dx, dy), dyy = __fmul_rn(dy, dy);
        if (t == 0) {
            cnt = k;
            sz = z;
            k1 = k;
            z1 = z;
            dx1 = dx;
            dy1 = dy;
        } else {
            cnt = __fadd_rn(cnt, k);
            sz = __fadd_rn(sz, z);
        }
        if (t == 1) {
            // _fma_sum: fma(a0, b0, a1·b1) for the first two terms
            const float dxx1 = __fmul_rn(dx1, dx1), dxy1 = __fmul_rn(dx1, dy1), dyy1 = __fmul_rn(dy1, dy1);
            sx = __fmaf_rn(k1, dx1, __fmul_rn(k, dx));
            sy = __fmaf_rn(k1, dy1, __fmul_rn(k, dy));
            sxx = __fmaf_rn(k1, dxx1, __fmul_rn(k, dxx));
            sxy = __fmaf_rn(k1, dxy1, __fmul_rn(k, dxy));
            syy = __fmaf_rn(k1, dyy1, __fmul_rn(k, dyy));
            sxz = __fmaf_rn(z1, dx1, __fmul_rn(z, dx));
            syz = __fmaf_rn(z1, dy1, __fmul_rn(z, dy));
            szz = __fmaf_rn(z1, z1, __fmul_rn(z, z));
        } else if (t > 1) {
            sx = __fmaf_rn(k, dx, sx);
            sy = __fmaf_rn(k, dy, sy);
            sxx = __fmaf_rn(k, dxx, sxx);
            sxy = __fmaf_rn(k, dxy, sxy);
            syy = __fmaf_rn(k, dyy, syy);
            sxz = __fmaf_rn(z, dx, sxz);
            syz = __fmaf_rn(z, dy, syz);
            szz = __fmaf_rn(z, z, szz);
        }
    }

    // maps2d.plane_fit_inputs, op for op
    const bool enough = cnt >= 3.0f;
    const float c = enough ? cnt : 1.0f;
    const float mx = __fdiv_rn(sx, c), my = __fdiv_rn(sy, c), mz = __fdiv_rn(sz, c);
    const float cmx = __fmul_rn(c, mx), cmy = __fmul_rn(c, my), cmz = __fmul_rn(c, mz);
    const float xx = __fmaf_rn(-cmx, mx, sxx);
    const float xy = __fmaf_rn(-cmx, my, sxy);
    const float xz = __fmaf_rn(-cmx, mz, sxz);
    const float yy = __fmaf_rn(-cmy, my, syy);
    const float yz = __fmaf_rn(-cmy, mz, syz);
    const float zz = __fmaf_rn(-cmz, mz, szz);
    const float det = __fmaf_rn(xx, yy, -__fmul_rn(xy, xy));
    const bool ok = enough && det != 0.0f;
    const float dets = det != 0.0f ? det : 1.0f;
    const float n0 = __fmaf_rn(yy, xz, -__fmul_rn(xy, yz));
    const float n1 = __fmaf_rn(xx, yz, -__fmul_rn(xy, xz));
    const float a0 = __fdiv_rn(n0, dets), a1 = __fdiv_rn(n1, dets);
    const float m = __fsqrt_rn(__fadd_rn(__fmaf_rn(a0, a0, __fmul_rn(a1, a1)), 1.0f));
    const float dm = __fmul_rn(dets, m);
    const float a0n = __fdiv_rn(n0, dm), a1n = __fdiv_rn(n1, dm);
    float e = __fsub_rn(zz, __fmul_rn(2.0f, __fmaf_rn(a0n, xz, __fmul_rn(a1n, yz))));
    e = __fmaf_rn(__fmul_rn(a0n, a0n), xx, e);
    e = __fmaf_rn(__fmul_rn(__fmul_rn(a0n, 2.0f), a1n), xy, e);
    e = __fmaf_rn(__fmul_rn(a1n, a1n), yy, e);
    fit_tail(ok, __fdiv_rn(e, c), a0n, a1n, __fdiv_rn(1.0f, m), rough + i, slope_x + i, slope_y + i);
}

__global__ void plane_fit_tail_kernel(const float* __restrict__ err, const uint8_t* __restrict__ ok,
                                      const float* __restrict__ a0n, const float* __restrict__ a1n,
                                      const float* __restrict__ inv_m, int n,
                                      float* __restrict__ rough, float* __restrict__ slope_x,
                                      float* __restrict__ slope_y)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fit_tail(ok[i] != 0, err[i], a0n[i], a1n[i], inv_m[i], rough + i, slope_x + i, slope_y + i);
}

}  // namespace

// The window-layout maps (hm, ihm) and the fit's (rough, slope_x, slope_y),
// each [X, Y], from the torus-layout hm_t and ihm_t at the origin [3]
extern "C" int gvom_plane_fit(const void* hm_t, const void* ihm_t, const void* origin, int X, int Y, float res,
                              float unknown, void* hm, void* ihm, void* rough, void* slope_x, void* slope_y,
                              void* stream)
{
    const dim3 block(TILE, TILE), grid((Y + TILE - 1) / TILE, (X + TILE - 1) / TILE);
    plane_fit_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)hm_t, (const float*)ihm_t, (const int*)origin, X, Y, res, unknown, (float*)hm, (float*)ihm,
        (float*)rough, (float*)slope_x, (float*)slope_y);
    return (int)cudaGetLastError();
}

extern "C" int gvom_plane_fit_tail(const void* err, const void* ok, const void* a0n, const void* a1n,
                                   const void* inv_m, int n, void* rough, void* slope_x, void* slope_y,
                                   void* stream)
{
    const int threads = 256;
    plane_fit_tail_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const float*)err, (const uint8_t*)ok, (const float*)a0n, (const float*)a1n, (const float*)inv_m, n,
        (float*)rough, (float*)slope_x, (float*)slope_y);
    return (int)cudaGetLastError();
}
