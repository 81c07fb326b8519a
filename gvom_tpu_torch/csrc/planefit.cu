// The plane fit's tail: roughness, slope_x and slope_y of the 2-D maps from
// the fit's residual and normalized coefficients, one thread a map cell.
//
// No TPU kernel: the JAX package computes this tail in XLA
// (gvom_tpu/ops/maps2d.py:175-178, jnp.log and jnp.arctan2), and the port
// adds the kernel so that the tail on the card is one launch and is bitwise
// the JAX package's CPU result. Its plain twin is
// gvom_tpu_torch/ops/maps2d.py::plane_fit_plain, on
// gvom_tpu_torch/ops/grid.py::log32 and ::atan2_32:
//   * log32 is XLA:CPU's float32 log: the Cephes logf polynomial that XLA
//     inlines, with the fused multiply-adds that LLVM makes of it;
//   * atan2_32 is glibc's atan2f (fdlibm e_atan2f.c on s_atanf.c), which
//     jnp.arctan2 calls, SSE code without FMAs;
//   * both under XLA's denormals-are-zero and flush-to-zero.
// Every rounding is written out: __fmaf_rn where the reference fuses,
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn elsewhere (and the build
// passes -fmad=false), so nvcc contracts nothing. CUDA's logf and atan2f are
// not used: they round otherwise.
//
// What bounds it on the H100: bytes. Five 4-byte inputs (ok is one byte) and
// three 4-byte outputs a cell, 2.0 MB at 256×256; its arithmetic (a
// division and ~30 flops for each of the two atan2, ~25 for the log) is far
// below the float32 rate. One launch takes the place of the ~8 elementwise
// launches of the same tail in PyTorch and of the hundreds that the plain
// version's float64 fma emulation would make.

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

__global__ void plane_fit_kernel(const float* __restrict__ err, const uint8_t* __restrict__ ok,
                                 const float* __restrict__ a0n, const float* __restrict__ a1n,
                                 const float* __restrict__ inv_m, int n,
                                 float* __restrict__ rough, float* __restrict__ slope_x,
                                 float* __restrict__ slope_y)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (ok[i]) {
        const float e = err[i];
        const float im = inv_m[i];
        rough[i] = e > 0.0f ? log32(e) : e;
        slope_x[i] = atan2_32(a0n[i], im);
        slope_y[i] = atan2_32(a1n[i], im);
    } else {
        rough[i] = -1.0f;
        slope_x[i] = 0.0f;
        slope_y[i] = 0.0f;
    }
}

}  // namespace

extern "C" int gvom_plane_fit(const void* err, const void* ok, const void* a0n, const void* a1n,
                              const void* inv_m, int n, void* rough, void* slope_x, void* slope_y,
                              void* stream)
{
    const int threads = 256;
    plane_fit_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const float*)err, (const uint8_t*)ok, (const float*)a0n, (const float*)a1n, (const float*)inv_m, n,
        (float*)rough, (float*)slope_x, (float*)slope_y);
    return (int)cudaGetLastError();
}
