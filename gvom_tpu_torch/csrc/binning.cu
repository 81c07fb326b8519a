// K2: point binning of one scan — endpoint hits, min sub-voxel z, and the
// ten own-voxel raw moment sums.
//
// Replaces gvom_tpu/ops/pallas_kernels.py::fused_point_moments
// (body _moment_kernel_factory), which sorts the points by voxel and turns
// each x-slice's sums into one-hot matmuls, because a TPU has no scatter.
// On the H100 each kept point is one thread that scatters straight into
// dense grids with atomics, following gvom_tpu/ops/binning.py::bin_points:
//   * hit: int atomicAdd on the point's torus voxel (in-grid points);
//   * min_height: atomicMin on the int bits of the sub-voxel z. The value is
//     a non-negative float, whose bits order like the float, so the min is
//     exact. The grid starts at the bits of 1.0f. fz = pn_z − floor(pn_z) comes
//     from the unpadded map-local coordinate, as in the JAX package;
//   * the ten own-voxel raw sums (n, S1, R2) with f32 atomicAdd into the
//     padded [10, X+2rx, Y+2ry, Z+2rz] window-layout scratch, which the
//     wrapper allocates. 10 atomics per point, not the 270 of a direct
//     27-neighbour scatter: the box is kernel K3's work.
//
// Bound: atomics — 12 per kept point, contended only where many points share
// a voxel. Float adds in atomic order differ from run to run in the last
// bits; n, hit and min_height are exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int pmod(int a, int n) {
    int r = a % n;
    return r < 0 ? r + n : r;
}

__global__ void bin_points_kernel(
    const float* __restrict__ pn,        // [N, 3] map-local voxel coordinates
    const uint8_t* __restrict__ keep,    // [N]
    const int* __restrict__ origin,      // [3]
    int n, int X, int Y, int Z, int rx, int ry, int rz,
    int* __restrict__ hit,               // [X, Y, Z] torus
    int* __restrict__ minh_bits,         // [X, Y, Z] torus, float bits
    float* __restrict__ sums)            // [10, Xp, Yp, Zp] padded window
{
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !keep[i]) return;
    float p[3], l[3];
    int v[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        p[a] = pn[3 * i + a];
        const float f = floorf(p[a]);
        v[a] = (int)f;
        l[a] = __fsub_rn(p[a], f);
    }
    if (v[0] >= 0 && v[0] < X && v[1] >= 0 && v[1] < Y && v[2] >= 0 && v[2] < Z) {
        const int64_t t = ((int64_t)pmod(v[0] + origin[0], X) * Y + pmod(v[1] + origin[1], Y)) * Z
                          + pmod(v[2] + origin[2], Z);
        atomicAdd(hit + t, 1);
        atomicMin(minh_bits + t, __float_as_int(l[2]));
    }
    const int Xp = X + 2 * rx, Yp = Y + 2 * ry, Zp = Z + 2 * rz;
    const int q0 = v[0] + rx, q1 = v[1] + ry, q2 = v[2] + rz;
    if (q0 < 0 || q0 >= Xp || q1 < 0 || q1 >= Yp || q2 < 0 || q2 >= Zp) return;
    const int64_t P = (int64_t)Xp * Yp * Zp;
    float* s = sums + ((int64_t)q0 * Yp + q1) * Zp + q2;
    atomicAdd(s, 1.0f);
    atomicAdd(s + 1 * P, l[0]);
    atomicAdd(s + 2 * P, l[1]);
    atomicAdd(s + 3 * P, l[2]);
    atomicAdd(s + 4 * P, __fmul_rn(l[0], l[0]));
    atomicAdd(s + 5 * P, __fmul_rn(l[0], l[1]));
    atomicAdd(s + 6 * P, __fmul_rn(l[0], l[2]));
    atomicAdd(s + 7 * P, __fmul_rn(l[1], l[1]));
    atomicAdd(s + 8 * P, __fmul_rn(l[1], l[2]));
    atomicAdd(s + 9 * P, __fmul_rn(l[2], l[2]));
}

}  // namespace

extern "C" int gvom_bin_points(
    const void* pn, const void* keep, const void* origin,
    int n, int X, int Y, int Z, int rx, int ry, int rz,
    void* hit, void* minh, void* sums, void* stream)
{
    if (n > 0) {
        const int threads = 256;
        const int blocks = (n + threads - 1) / threads;
        bin_points_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)pn, (const uint8_t*)keep, (const int*)origin,
            n, X, Y, Z, rx, ry, rz, (int*)hit, (int*)minh, (float*)sums);
    }
    return (int)cudaGetLastError();
}
