// Point preparation of S scans in one pass: the sensor→world transform, the
// min-distance filter, the grid origin and each scan's scan_ok.
//
// No TPU kernel: the JAX package computes this in XLA, inside the jit of its
// kernels: gvom_tpu/ops/binning.py:47-69 (prepare_points),
// gvom_tpu/models/pipeline.py:209-213 (the origin and scan_ok of an ingest)
// and gvom_tpu/parallel/sharding.py:193-202 (the batched step's dead scans).
// The plain twin is gvom_tpu_torch/ops/binning.py::prepare_plain, which the
// CPU tests hold bitwise against those JAX functions.
//
// The contract is bitwise, so every rounding of the JAX package's compiled
// arithmetic is written out (and the library is built with -fmad=false):
//   * the transform, row r of R: fma(p2, r2, fma(p1, r1, p0·r0)), then + t
//     (XLA:CPU's dot of [N,3] by [3,3]);
//   * the squared distance fma(v2, v2, fma(v1, v1, v0·v0)) with v = p, or
//     v = p − ego under ego_relative_min_distance; keep = valid and
//     d2 >= fl(min_distance)²;
//   * the origin floor(fma(ego, 1/res, −size/2)), computed by every thread
//     from the frame's ego unless the caller pins it;
//   * vox = floor(fma(p, 1/res, −origin)); scan_ok[s] = any(keep and vox in
//     the grid). Float to int conversion saturates and NaN gives 0, as XLA
//     converts. A point that is not kept never reaches scan_ok.
//
// What bounds it on the H100: bytes. About 16 f32 operations a point (28 with
// a transform) against 14 bytes (the point read, valid read, keep written;
// with a transform the world point is written too, 26 bytes): 4.19 M points
// are 0.018 ms at 3.35 TB/s and 0.001 ms of f32 arithmetic. Without a transform the world
// point is the input itself and is not written. scan_ok is reduced in the
// block (__syncthreads_or) and set by one atomicOr a block on the byte of
// the bool array that holds it. The dead-scan mask (keep &= scan_ok[s]) is a
// second launch, since it needs every block of the scan: its blocks read one
// byte and exit unless the scan is dead, and then zero the scan's keep row.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int floor_i32(float x) {
    const float f = floorf(x);
    if (f != f) return 0;
    if (f >= 2147483648.0f) return INT_MAX;
    if (f < -2147483648.0f) return INT_MIN;
    return (int)f;
}

__global__ void __launch_bounds__(THREADS) prepare_kernel(
    const float* __restrict__ points,      // [S, n, 3]
    const uint8_t* __restrict__ valid,     // [S, n]
    const float* __restrict__ egos,        // [S, 3]
    const float* __restrict__ frame_ego,   // [3], or null when the origin is pinned
    const int* __restrict__ origin_in,     // [3], or null
    const float* __restrict__ transform,   // [4, 4] row-major, or null
    float inv_xy, float inv_z, float md2, int ego_relative, int n, int X, int Y, int Z,
    float* __restrict__ p_out,             // [S, n, 3]; written only with a transform
    uint8_t* __restrict__ keep,            // [S, n]
    int* __restrict__ origin_out,          // [3]
    unsigned* __restrict__ scan_ok)        // the bool array [S] as words, zeroed
{
    const int s = blockIdx.y;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const float inv[3] = {inv_xy, inv_xy, inv_z};
    const int size[3] = {X, Y, Z};
    int o[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
        o[a] = origin_in ? origin_in[a] : floor_i32(__fmaf_rn(frame_ego[a], inv[a], -0.5f * (float)size[a]));
    if (blockIdx.x == 0 && s == 0 && threadIdx.x < 3) origin_out[threadIdx.x] = o[threadIdx.x];

    bool ok = false;
    if (i < n) {
        const int64_t k = (int64_t)s * n + i;
        float p[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) p[a] = points[3 * k + a];
        if (transform) {
            float q[3];
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const float* row = transform + 4 * r;
                q[r] = __fadd_rn(__fmaf_rn(p[2], row[2], __fmaf_rn(p[1], row[1], __fmul_rn(p[0], row[0]))), row[3]);
            }
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                p[a] = q[a];
                p_out[3 * k + a] = q[a];
            }
        }
        float v[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) v[a] = ego_relative ? __fsub_rn(p[a], egos[3 * s + a]) : p[a];
        const float d2 = __fmaf_rn(v[2], v[2], __fmaf_rn(v[1], v[1], __fmul_rn(v[0], v[0])));
        const bool kp = valid[k] != 0 && d2 >= md2;
        keep[k] = kp;
        if (kp) {
            ok = true;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                const int vox = floor_i32(__fmaf_rn(p[a], inv[a], -(float)o[a]));
                ok = ok && vox >= 0 && vox < size[a];
            }
        }
    }
    if (__syncthreads_or(ok) && threadIdx.x == 0) atomicOr(scan_ok + s / 4, 1u << (8 * (s % 4)));
}

// keep[s, :] = 0 where scan s is dead; a live scan's blocks exit at once
__global__ void __launch_bounds__(THREADS) drop_dead_kernel(uint8_t* __restrict__ keep,
                                                            const uint8_t* __restrict__ scan_ok, int n)
{
    const int s = blockIdx.y;
    if (scan_ok[s]) return;
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) keep[(int64_t)s * n + i] = 0;
}

}  // namespace

// The preparation of S scans of n points on `stream`, then, with drop_dead,
// the dead-scan mask. scan_ok is a bool array of S bytes whose allocation is
// a whole number of 4-byte words (ceil(S/4) of them): it is zeroed here.
extern "C" int gvom_prepare_points(
    const void* points, const void* valid, const void* egos, const void* frame_ego, const void* origin_in,
    const void* transform, float inv_xy, float inv_z, float md2, int ego_relative,
    int S, int n, int X, int Y, int Z, int drop_dead,
    void* p_out, void* keep, void* origin_out, void* scan_ok, void* stream)
{
    if (S < 1 || S > 65535 || n < 0 || (transform && !p_out) || (!frame_ego == !origin_in))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t rc = cudaMemsetAsync(scan_ok, 0, 4 * (size_t)((S + 3) / 4), st);
    if (rc != cudaSuccess) return (int)rc;
    const dim3 grid((unsigned)(n > 0 ? (n + THREADS - 1) / THREADS : 1), (unsigned)S);
    prepare_kernel<<<grid, THREADS, 0, st>>>(
        (const float*)points, (const uint8_t*)valid, (const float*)egos, (const float*)frame_ego,
        (const int*)origin_in, (const float*)transform, inv_xy, inv_z, md2, ego_relative, n, X, Y, Z,
        (float*)p_out, (uint8_t*)keep, (int*)origin_out, (unsigned*)scan_ok);
    if (drop_dead && n > 0) {
        const int blocks = (n + THREADS - 1) / THREADS;
        const dim3 dgrid((unsigned)(blocks < 64 ? blocks : 64), (unsigned)S);
        drop_dead_kernel<<<dgrid, THREADS, 0, st>>>((uint8_t*)keep, (const uint8_t*)scan_ok, n);
    }
    return (int)cudaGetLastError();
}
