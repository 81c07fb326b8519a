// K3: the ingest epilogue — neighbourhood box, crop, occupancy pre-mask and
// the write of one scan's moments straight into its ring-buffer slot.
//
// Replaces gvom_tpu/ops/pallas_kernels.py::_xbox_epilogue_into (body
// _xbox_epilogue_into_factory). On the TPU the y/z box happens inside the
// sorted matmul kernel and this epilogue adds only the ±rx x-box; here K2
// leaves own-voxel sums, so this kernel does the whole ±rx/±ry/±rz box,
// with each source translated into the target voxel's frame (the
// parallel-axis update of gvom_tpu/ops/moments.py::translate_raw):
//   S1'_a  = S1_a + t_a·n
//   R2'_ab = R2_ab + t_a·S1_b + t_b·S1_a + t_a·t_b·n
// One thread per target voxel of the window, z fastest, so a warp reads and
// writes 32 neighbouring floats. The padded scratch makes every
// neighbour read in bounds (the crop is the choice of the centre).
//
// The output is a tensor the caller passes in, [S, 10, X, Y, Z], and the
// slot is read on the device (slot = scan_ok ? cursor : B), so the insert
// needs no sync with the host. A later batched path can pass a fresh
// [1, 10, X, Y, Z] tensor and slot 0.
//
// Bound: bytes. Every voxel of the slot is written (10 f32 channels,
// 168 MB at the upstream config) and hit is read once; the sums are read
// only where hit > 0, a few percent of the voxels, and those 27-point
// re-reads mostly hit L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void ingest_epilogue_kernel(
    const float* __restrict__ sums,    // [10, Xp, Yp, Zp] own-voxel sums, padded window layout
    const int* __restrict__ hit,       // [X, Y, Z] torus
    const int* __restrict__ origin,    // [3]
    const int* __restrict__ slot,      // [1]
    int X, int Y, int Z, int rx, int ry, int rz,
    float* __restrict__ out)           // [S, 10, X, Y, Z] torus
{
    const int64_t V = (int64_t)X * Y * Z;
    const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= V) return;
    const int wz = (int)(w % Z);
    const int wy = (int)((w / Z) % Y);
    const int wx = (int)(w / ((int64_t)Y * Z));
    int t0 = (wx + origin[0]) % X; if (t0 < 0) t0 += X;
    int t1 = (wy + origin[1]) % Y; if (t1 < 0) t1 += Y;
    int t2 = (wz + origin[2]) % Z; if (t2 < 0) t2 += Z;
    const int64_t t = ((int64_t)t0 * Y + t1) * Z + t2;
    float* o = out + (int64_t)slot[0] * 10 * V + t;

    float acc[10];
#pragma unroll
    for (int c = 0; c < 10; ++c) acc[c] = 0.0f;

    if (hit[t] > 0) {
        const int Yp = Y + 2 * ry, Zp = Z + 2 * rz;
        const int64_t P = (int64_t)(X + 2 * rx) * Yp * Zp;
        for (int ox = -rx; ox <= rx; ++ox) {
            for (int oy = -ry; oy <= ry; ++oy) {
                for (int oz = -rz; oz <= rz; ++oz) {
                    const float* s = sums + ((int64_t)(wx + rx + ox) * Yp + (wy + ry + oy)) * Zp
                                     + (wz + rz + oz);
                    const float n = s[0];
                    if (n == 0.0f) continue;   // an empty source voxel has all-zero sums
                    const float tv[3] = {(float)ox, (float)oy, (float)oz};
                    const float s1[3] = {s[P], s[2 * P], s[3 * P]};
                    acc[0] += n;
#pragma unroll
                    for (int a = 0; a < 3; ++a) acc[1 + a] += s1[a] + tv[a] * n;
                    // (xx, xy, xz, yy, yz, zz)
                    const int pa[6] = {0, 0, 0, 1, 1, 2};
                    const int pb[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
                    for (int q = 0; q < 6; ++q) {
                        const int a = pa[q], b = pb[q];
                        acc[4 + q] += s[(4 + q) * P] + tv[a] * s1[b] + tv[b] * s1[a] + tv[a] * tv[b] * n;
                    }
                }
            }
        }
    }
#pragma unroll
    for (int c = 0; c < 10; ++c) o[c * V] = acc[c];
}

}  // namespace

extern "C" int gvom_ingest_epilogue(
    const void* sums, const void* hit, const void* origin, const void* slot,
    int X, int Y, int Z, int rx, int ry, int rz, void* out, void* stream)
{
    const int64_t V = (int64_t)X * Y * Z;
    const int threads = 256;
    const int64_t blocks = (V + threads - 1) / threads;
    ingest_epilogue_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)sums, (const int*)hit, (const int*)origin, (const int*)slot,
        X, Y, Z, rx, ry, rz, (float*)out);
    return (int)cudaGetLastError();
}
