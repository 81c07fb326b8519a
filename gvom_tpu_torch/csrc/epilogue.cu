// K3 and K5: the moments epilogue — neighbourhood box, crop, optional
// occupancy pre-mask, and the write of the ten moment channels into a tensor
// of the caller's.
//
// K3 replaces gvom_tpu/ops/pallas_kernels.py::_xbox_epilogue_into (body
// _xbox_epilogue_into_factory): mask on, written straight into one scan's
// ring-buffer slot. K5 replaces ::_xbox_epilogue (body
// _xbox_epilogue_factory): a fresh tensor, the mask optional, the full grid
// or a y-slab. On the TPU the y/z box happens inside the sorted matmul kernel
// and the epilogue adds only the ±rx x-box and splits hit and min_height out
// of a packed slot; here K2 leaves own-voxel sums and writes hit and
// min_height dense, so this kernel does the whole ±rx/±ry/±rz box and there
// is nothing to split. Each source is translated into the target voxel's
// frame (the parallel-axis update of gvom_tpu/ops/moments.py::translate_raw):
//   S1'_a  = S1_a + t_a·n
//   R2'_ab = R2_ab + t_a·S1_b + t_b·S1_a + t_a·t_b·n
// One thread per target voxel, z fastest, so a warp reads and writes 32
// neighbouring floats. The padded scratch makes every neighbour read in
// bounds (the crop is the choice of the centre).
//
// MASK (template): with the mask on, a voxel without a hit of its own is
// written as zero and its box is skipped. With it off (the batched step,
// which masks later by the whole batch's occupancy) the box is computed at
// EVERY voxel, since a voxel with no endpoint of its own still receives its
// neighbours' sums.
//
// Slab form ((ys0, Ys) != (0, Y), the same rule as raycast.cu and
// binning.cu): the output and hit are [.., X, Ys, Z], the torus
// rows [ys0, ys0+Ys), and the sums are K2's slab scratch
// [10, Xp, Ys+4ry, Zp] (binning.cu): slab row j is window row (w0+j) mod Y
// and sits at scratch row j + ry, or j + 3ry past the window seam
// (j >= lenA). The full grid is ys0 = 0, Ys = Y with scratch row wy + ry.
//
// The output is [S, 10, X, Ys, Z] and the slot is read on the device
// (slot = scan_ok ? cursor : B), so the insert needs no sync with the host;
// a null slot pointer means slot 0 of a fresh tensor.
//
// Bound: bytes. Every voxel of the output is written (10 f32 channels,
// 168 MB at the upstream config). With the mask on, hit is read once and the
// sums only where hit > 0, a few percent of the voxels; with it off, n is
// read over the whole padded window and the nine other channels wherever
// n > 0. The 27-point re-reads mostly hit L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int pmod(int a, int n) {
    int r = a % n;
    return r < 0 ? r + n : r;
}

// The kernel is bound by its stores, and the card hides their latency only
// with enough blocks in flight. Without a bound the compiler takes 64 and 80
// registers, four and three blocks an SM: 0.152 ms masked and 0.331 ms
// unmasked on one scan's sums at 256×256×64, against 0.103 and 0.181 ms at
// five blocks (47/48 registers, no spills); six blocks spill (H100, 700 W;
// scripts/epilogue_occupancy.py measures it).
template <bool MASK>
__global__ void __launch_bounds__(256, 5) epilogue_kernel(
    const float* __restrict__ sums,    // [10, Xp, Yp | Ys+4ry, Zp] own-voxel sums, padded window layout
    const int* __restrict__ hit,       // [X, Ys, Z] torus (read only when MASK)
    const int* __restrict__ origin,    // [3]
    const int* __restrict__ slot,      // [1] or null
    int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys,
    float* __restrict__ out)           // [S, 10, X, Ys, Z] torus
{
    const int64_t V = (int64_t)X * Ys * Z;
    const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= V) return;
    // window x and z, slab row j (torus row ys0 + j)
    const int wz = (int)(w % Z);
    const int j = (int)((w / Z) % Ys);
    const int wx = (int)(w / ((int64_t)Ys * Z));
    const int t0 = pmod(wx + origin[0], X);
    const int t2 = pmod(wz + origin[2], Z);
    const int wy = pmod(ys0 + j - origin[1], Y);
    const int64_t t = ((int64_t)t0 * Ys + j) * Z + t2;
    float* o = out + (int64_t)(slot ? slot[0] : 0) * 10 * V + t;

    float acc[10];
#pragma unroll
    for (int c = 0; c < 10; ++c) acc[c] = 0.0f;

    if (!MASK || hit[t] > 0) {
        int sy, Ysc;     // scratch row of the target, scratch rows in all
        if (!(ys0 == 0 && Ys == Y)) {
            const int w0 = pmod(ys0 - origin[1], Y);
            const int lenA = min(Ys, Y - w0);
            sy = j + ry + (j >= lenA ? 2 * ry : 0);
            Ysc = Ys + 4 * ry;
        } else {
            sy = wy + ry;
            Ysc = Y + 2 * ry;
        }
        const int Zp = Z + 2 * rz;
        const int64_t P = (int64_t)(X + 2 * rx) * Ysc * Zp;
        for (int ox = -rx; ox <= rx; ++ox) {
            for (int oy = -ry; oy <= ry; ++oy) {
                for (int oz = -rz; oz <= rz; ++oz) {
                    const float* s = sums + ((int64_t)(wx + rx + ox) * Ysc + (sy + oy)) * Zp
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

extern "C" int gvom_moments_epilogue(
    const void* sums, const void* hit, const void* origin, const void* slot,
    int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys, int mask,
    void* out, void* stream)
{
    const int64_t V = (int64_t)X * Ys * Z;
    const int threads = 256;
    const unsigned blocks = (unsigned)((V + threads - 1) / threads);
    if (mask) {
        epilogue_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)sums, (const int*)hit, (const int*)origin, (const int*)slot,
            X, Y, Z, rx, ry, rz, ys0, Ys, (float*)out);
    } else {
        epilogue_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)sums, (const int*)hit, (const int*)origin, (const int*)slot,
            X, Y, Z, rx, ry, rz, ys0, Ys, (float*)out);
    }
    return (int)cudaGetLastError();
}
