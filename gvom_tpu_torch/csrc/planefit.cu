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
// cells' window heights and inferred heights (the inferred height's load
// issued before the tile's barrier), then each thread runs the chain in
// registers. The window layout is this load rather than a launch of its
// own: the fit reads the window map's halo anyway, and a torus index costs
// it an add and a compare.
//
// At the upstream 256×256 map the kernel is not bound by its bytes but by
// its launch and its instructions: an empty kernel of the same grid takes
// about 1.25 µs in a graph of ten launches, the load and the window stores
// alone about 2.3 µs, and the rest is the fit and its tail, issued by 16
// warps an SM (one wave; scripts/time_wide_forms.py times each part). So
// the design cuts instructions: a cell with fewer than three known cells
// in its window, or whose moments are singular, stops after its sums (its
// outputs are the tail's fixed ones), and the tail is straight-line code
// (log32's special inputs and atan2_32's special cases chosen by selects
// after the main path, atanf's range reduction one division whose operands
// a select picks), so that a warp whose cells take different ranges does
// not run each range's path. Tried on the card and dropped, each slower:
// two lanes a cell (the fit computed by both, a slope each), the three
// tails in three warps after the fit (a barrier and shared memory between),
// and two cells a thread.
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

// XLA:CPU's log, op for op (see grid.py::log32); the special inputs are
// chosen after the polynomial, as the twin chooses them, so that a warp
// runs one straight path
__device__ __forceinline__ float log32(float x)
{
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
    float out = __fmaf_rn(e, bits(0x3F318000u), __fadd_rn(u, r));         // ln2 hi
    if (x == CUDART_INF_F) out = CUDART_INF_F;
    if (!(x >= 0.0f)) out = bits(0xFFFFFFFFu);              // negative or NaN: all-ones NaN
    if (fabsf(x) < FLT_MIN_) out = -CUDART_INF_F;           // ±0 or subnormal (denormals are zero)
    return out;
}

__device__ __forceinline__ float flush(float v) { return fabsf(v) < FLT_MIN_ ? __fmul_rn(v, 0.0f) : v; }

// glibc's atanf (see grid.py::_atanf): the range reduction's quotient is
// one division whose operands a select picks, the reduction's constants
// are selects too (no divergent constant-bank read), and the special
// inputs are chosen at the end, as the twin chooses them
__device__ __forceinline__ float atanf32(float t)
{
    const int32_t hx = __float_as_int(t);
    const int32_t ix = hx & 0x7FFFFFFF;
    const float a = fabsf(t);
    const int id = ix < 0x3EE00000 ? -1 : ix < 0x3F300000 ? 0 : ix < 0x3F980000 ? 1 : ix < 0x401C0000 ? 2 : 3;
    float num = -1.0f, den = a;                             // id 3: -1/a
    if (id == 0) {
        num = __fsub_rn(__fadd_rn(a, a), 1.0f);
        den = __fadd_rn(a, 2.0f);
    } else if (id == 1) {
        num = __fsub_rn(a, 1.0f);
        den = __fadd_rn(a, 1.0f);
    } else if (id == 2) {
        num = __fsub_rn(a, 1.5f);
        den = __fadd_rn(__fmul_rn(a, 1.5f), 1.0f);
    }
    const float r = id < 0 ? t : __fdiv_rn(num, den);
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
    // atan(1/2), atan(1), atan(3/2), atan(inf), each as hi + lo
    const float hi = id == 0 ? bits(0x3EED6338u) : id == 1 ? bits(0x3F490FDAu) : id == 2 ? bits(0x3F7B985Eu)
                                                                                          : bits(0x3FC90FDAu);
    const float lo = id == 0 ? bits(0x31AC3769u) : id == 1 ? bits(0x33222168u) : id == 2 ? bits(0x33140FB4u)
                                                                                          : bits(0x33A22168u);
    const float v = __fsub_rn(hi, __fsub_rn(__fsub_rn(q, lo), r));
    float out = id < 0 ? __fsub_rn(r, q) : (hx < 0 ? -v : v);
    if (ix < 0x31000000) out = t;
    if (ix >= 0x4C000000) {
        const float inf = __fadd_rn(bits(0x3FC90FDAu), bits(0x33A22168u));
        out = hx < 0 ? -inf : inf;
    }
    if (ix > 0x7F800000) out = __fadd_rn(t, t);
    return out;
}

// glibc's atan2f (see grid.py::atan2_32): atan(|y/x|) computed for every
// input, then the special cases chosen over it in the twin's order
__device__ __forceinline__ float atan2_32(float y, float x)
{
    const float PI = bits(0x40490FDBu), PI_O_2 = bits(0x3FC90FDBu), PI_O_4 = bits(0x3F490FDBu);
    const float PI_LO = bits(0xB3BBBD2Eu);
    const int32_t hx = __float_as_int(x), hy = __float_as_int(y);
    const int32_t ix = hx & 0x7FFFFFFF, iy = hy & 0x7FFFFFFF;
    const bool nx = hx < 0, ny = hy < 0, one = hx == 0x3F800000;
    const float za = atanf32(one ? y : fabsf(flush(__fdiv_rn(flush(y), flush(x)))));
    const int32_t d = iy - ix;
    float z = za;
    if (d > 0x1E7FFFFF) z = __fsub_rn(PI_O_2, bits(0x333BBD2Eu));      // pi/2 + pi_lo/2
    else if (nx && (d >> 23) < -60) z = 0.0f;
    float out = nx ? (ny ? __fsub_rn(__fsub_rn(z, PI_LO), PI) : __fsub_rn(PI, __fsub_rn(z, PI_LO)))
                   : (ny ? -z : z);
    const float half_pi = ny ? -PI_O_2 : PI_O_2, pi = ny ? -PI : PI;
    if (iy == 0x7F800000) out = half_pi;
    if (ix == 0x7F800000) {
        const float three = __fmul_rn(3.0f, PI_O_4);
        const float corner = nx ? (ny ? -three : three) : (ny ? -PI_O_4 : PI_O_4);
        out = iy == 0x7F800000 ? corner : nx ? pi : (ny ? -0.0f : 0.0f);
    }
    if (ix == 0) out = half_pi;
    if (iy == 0) out = nx ? pi : y;
    if (one) out = za;
    if (ix > 0x7F800000 || iy > 0x7F800000) out = __fadd_rn(x, y);
    return out;
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

// The fit of the cell at tile[r][c], plane_fit_inputs op for op: whether it
// is ok, and then the tail's inputs, the residual over the count, a0n, a1n
// and 1/m. A cell with fewer than three known cells in its window, or whose
// moments are singular, is not ok and skips the rest, so that a warp whose
// cells are unknown does no fit (the twin computes the fit there too, but no
// output depends on it).
__device__ __forceinline__ bool fit_values(const float (&tile)[TILE + 2][TILE + 2], int r, int c, float res,
                                           float unknown, float& err, float& a0n, float& a1n, float& im)
{
    // the nine offsets in the twin's order: di = -1..1, then dj = -1..1
    float cnt = 0.0f, sz = 0.0f, sx = 0.0f, sy = 0.0f, sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
    float sxz = 0.0f, syz = 0.0f, szz = 0.0f;
    float k1 = 0.0f, z1 = 0.0f, dx1 = 0.0f, dy1 = 0.0f;   // the first term, for _fma_sum's pairing
#pragma unroll
    for (int t = 0; t < 9; ++t) {
        const int di = t / 3 - 1, dj = t % 3 - 1;
        const float h = tile[r + di][c + dj];
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

    if (!(cnt >= 3.0f)) return false;
    const float mx = __fdiv_rn(sx, cnt), my = __fdiv_rn(sy, cnt), mz = __fdiv_rn(sz, cnt);
    const float cmx = __fmul_rn(cnt, mx), cmy = __fmul_rn(cnt, my), cmz = __fmul_rn(cnt, mz);
    const float xx = __fmaf_rn(-cmx, mx, sxx);
    const float xy = __fmaf_rn(-cmx, my, sxy);
    const float xz = __fmaf_rn(-cmx, mz, sxz);
    const float yy = __fmaf_rn(-cmy, my, syy);
    const float yz = __fmaf_rn(-cmy, mz, syz);
    const float zz = __fmaf_rn(-cmz, mz, szz);
    const float det = __fmaf_rn(xx, yy, -__fmul_rn(xy, xy));
    if (det == 0.0f) return false;
    const float n0 = __fmaf_rn(yy, xz, -__fmul_rn(xy, yz));
    const float n1 = __fmaf_rn(xx, yz, -__fmul_rn(xy, xz));
    const float a0 = __fdiv_rn(n0, det), a1 = __fdiv_rn(n1, det);
    const float m = __fsqrt_rn(__fadd_rn(__fmaf_rn(a0, a0, __fmul_rn(a1, a1)), 1.0f));
    const float dm = __fmul_rn(det, m);
    a0n = __fdiv_rn(n0, dm);
    a1n = __fdiv_rn(n1, dm);
    float e = __fsub_rn(zz, __fmul_rn(2.0f, __fmaf_rn(a0n, xz, __fmul_rn(a1n, yz))));
    e = __fmaf_rn(__fmul_rn(a0n, a0n), xx, e);
    e = __fmaf_rn(__fmul_rn(__fmul_rn(a0n, 2.0f), a1n), xy, e);
    e = __fmaf_rn(__fmul_rn(a1n, a1n), yy, e);
    err = __fdiv_rn(e, cnt);
    im = __fdiv_rn(1.0f, m);
    return true;
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
    // the tile with its halo, (TILE + 2)² cells, at most two a thread: both
    // loads and the inferred height's issued before the first store
    constexpr int HALO = (TILE + 2) * (TILE + 2);
    static_assert(HALO <= 2 * TILE * TILE, "the tile's load takes two cells a thread");
    const int t = threadIdx.y * TILE + threadIdx.x;
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int q = t + j * TILE * TILE, r = q / (TILE + 2), c = q % (TILE + 2);
        const int x = x0 + r - 1, y = y0 + c - 1;
        v[j] = q < HALO && x >= 0 && x < X && y >= 0 && y < Y ? hm_t[(size_t)torus(x, ox, X) * Y + torus(y, oy, Y)]
                                                              : unknown;
    }
    const int x = x0 + threadIdx.y, y = y0 + threadIdx.x;
    const bool in = x < X && y < Y;
    const size_t i = (size_t)x * Y + y;
    const float ih = in ? ihm_t[(size_t)torus(x, ox, X) * Y + torus(y, oy, Y)] : 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int q = t + j * TILE * TILE;
        if (q < HALO) tile[q / (TILE + 2)][q % (TILE + 2)] = v[j];
    }
    __syncthreads();
    if (!in) return;
    hm[i] = tile[threadIdx.y + 1][threadIdx.x + 1];
    ihm[i] = ih;
    float err = 0.0f, a0n = 0.0f, a1n = 0.0f, im = 0.0f;
    const bool ok = fit_values(tile, threadIdx.y + 1, threadIdx.x + 1, res, unknown, err, a0n, a1n, im);
    fit_tail(ok, err, a0n, a1n, im, rough + i, slope_x + i, slope_y + i);
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
