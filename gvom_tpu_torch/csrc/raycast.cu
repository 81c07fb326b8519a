// K1: free-space pass counts of one scan (the reference's DDA march,
// gvom.py:1091-1150).
//
// Replaces gvom_tpu/ops/pallas_kernels.py::_run_hist (driven by
// ray_pass_counts_matmul), which recasts the march as per-(axis, sign, step)
// one-hot matmul histograms because a TPU has no scatter. On the H100 the
// march is what it is: one thread per ray walks k = 1..kmax and adds one to
// each traversed voxel with an int32 atomicAdd into the torus-placed
// [X, Y, Z] grid.
//
// Bound: atomics. A scan issues one atomic per live (ray, step) pair
// (~130 per ray at the upstream config), and rays fan out from the ego, so
// the voxels next to it take thousands of adds each. Integer adds commute,
// so the result is bitwise independent of their order. This first version
// keeps the plain global atomics; shared-memory privatisation of the
// crowded near-ego rows is later work.
//
// Exactness (the same three rules as gvom_tpu/ops/raycast.py): the
// dominant step is exactly ±1 and its row is the integer floor(start)±k;
// position and liveness round the product before the add
// (start_rel + fl(k·step), fl((k−1)·delta) < budget). __fmul_rn/__fadd_rn
// keep nvcc from contracting them into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int pmod(int a, int n) {
    int r = a % n;
    return r < 0 ? r + n : r;
}

__global__ void ray_pass_counts_kernel(
    const float* __restrict__ start_rel,  // [3]
    const int* __restrict__ start_i,      // [3]
    const float* __restrict__ step,       // [N, 3]
    const float* __restrict__ delta,      // [N]
    const float* __restrict__ budget,     // [N]
    const int* __restrict__ dom,          // [N]
    const int* __restrict__ origin,       // [3]
    int n, int ray_steps, int X, int Y, int Z,
    int* __restrict__ out)                // [X, Y, Z]
{
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float b = budget[i];
    const float d = delta[i];
    const int dm = dom[i];
    const float s[3] = {step[3 * i], step[3 * i + 1], step[3 * i + 2]};
    const float r[3] = {start_rel[0], start_rel[1], start_rel[2]};
    const int size[3] = {X, Y, Z};
    const int sgn = s[dm] < 0.0f ? -1 : 1;
    const int x0 = start_i[dm];
    const int o[3] = {origin[0], origin[1], origin[2]};
    for (int k = 1; k <= ray_steps; ++k) {
        const float kf = (float)k;
        // liveness is monotone in k, so the first dead step ends the ray
        if (!(__fmul_rn(kf - 1.0f, d) < b)) break;
        int v[3];
        bool inb = true;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            v[a] = (a == dm) ? x0 + k * sgn : (int)floorf(__fadd_rn(r[a], __fmul_rn(kf, s[a])));
            inb = inb && v[a] >= 0 && v[a] < size[a];
        }
        if (!inb) continue;
        const int t0 = pmod(v[0] + o[0], X);
        const int t1 = pmod(v[1] + o[1], Y);
        const int t2 = pmod(v[2] + o[2], Z);
        atomicAdd(out + ((int64_t)t0 * Y + t1) * Z + t2, 1);
    }
}

}  // namespace

extern "C" int gvom_ray_pass_counts(
    const void* start_rel, const void* start_i, const void* step, const void* delta,
    const void* budget, const void* dom, const void* origin,
    int n, int ray_steps, int X, int Y, int Z, void* out, void* stream)
{
    if (n > 0) {
        const int threads = 256;
        const int blocks = (n + threads - 1) / threads;
        ray_pass_counts_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)start_rel, (const int*)start_i, (const float*)step,
            (const float*)delta, (const float*)budget, (const int*)dom,
            (const int*)origin, n, ray_steps, X, Y, Z, (int*)out);
    }
    return (int)cudaGetLastError();
}
