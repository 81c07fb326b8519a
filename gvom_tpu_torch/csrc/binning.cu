// K2: point binning of one point set — endpoint hits, min sub-voxel z, and
// the ten own-voxel raw moment sums.
//
// Replaces gvom_tpu/ops/pallas_kernels.py:1510 fused_point_moments (body
// _moment_kernel_factory :1000; its slab prefilter :1559-1566), which sorts
// the points by voxel and turns each x-slice's sums into one-hot matmuls,
// because a TPU has no scatter. On the H100 the points scatter straight into
// dense grids with atomics, following gvom_tpu/ops/binning.py::bin_points:
//   * hit: int atomicAdd on the point's torus voxel (in-grid points);
//   * min_height: atomicMin on the int bits of the sub-voxel z. The value is
//     a non-negative float, whose bits order like the float, so the min is
//     exact. The grid starts at the bits of 1.0f. fz = pn_z − floor(pn_z) comes
//     from the unpadded map-local coordinate, as in the JAX package;
//   * the ten own-voxel raw sums (n, S1, R2) with f32 atomicAdd into the
//     padded [10, X+2rx, Y+2ry, Z+2rz] window-layout scratch; the box over
//     them is kernel K3's and K5's work (epilogue.cu).
//
// Contract of the scratch: n (channel 0) is defined everywhere; channels 1–9
// are defined only where n > 0. Every consumer (the epilogue, its plain twins)
// reads them only there.
//
// What bounds it on the H100. Not arithmetic (~30 f32 operations a point).
// Its bytes are the points and the outputs; its first version also filled all
// ten channels of the scratch (211 MB with hit and min_height at 256×256×64,
// 0.063 ms at 3.35 TB/s, more than the kernel proper), although nothing reads
// nine of them where n is 0. Its atomics: twelve a point, which on a batched
// step's 4.19 M points ran at the card's uncontended atomic rate (0.6 ms),
// since a warp's 32 lanes held 32 beams of one azimuth column and no add was
// merged before it reached L2.
//
// The design:
//   * fill only what every consumer reads: one launch sets hit to 0,
//     min_height to 1.0f and n to 0 (16-byte stores); channels 1–9 are left
//     as the caller allocated them;
//   * pass 1 adds n, hit and min_height. The lane whose atomicAdd on n finds
//     0 (one per scratch address) writes zeros to that voxel's nine other
//     channels. Pass 2, the next launch on the stream, adds the nine
//     channels: the stream order is the barrier, so no add lands before its
//     zeroing;
//   * equal voxels are merged before the global atomic, twice: each warp's
//     (__match_any_sync: the group's lowest lane takes the group's count, its
//     min by __reduce_min_sync, and the sums of its nine values, read from
//     shared memory in lane order), then the block's, in a hash table of
//     voxels in shared memory, whose slots are flushed with one global atomic
//     each. A block's 256 points are two azimuth columns of a scan, whose
//     endpoints largely share voxels; a warp's are 32 beams of one column.
//     Tried beside it on the card (PERF.md §6): the warp merge alone, and a
//     warp across 32 scans of a batch (lane i on one point of scan s + i).
//
// Slab form (fused_point_moments(y_window=)): with (ys0, Ys) != (0, Y), the
// same rule as raycast.cu and epilogue.cu, the outputs cover only the torus
// rows [ys0, ys0+Ys) of the grid. hit and min_height are [X, Ys, Z] and a
// point outside the slab is dropped (the full grid is ys0 = 0, Ys = Y). The
// sums keep WINDOW coordinates, because the box that K3/K5 take over them is
// a window operation: the target at window row Y−1 reads the pad row Y, not
// window row 0, although the two torus rows are neighbours. The slab's torus
// rows are window rows [w0, w0+Ys) mod Y with w0 = (ys0 − origin_y) mod Y:
// one run of padded window rows, or two when the window seam falls inside the
// slab. The scratch is [10, Xp, Ys+4ry, Zp]:
//   piece A: padded window rows [w0, w0+lenA+2ry)  at scratch rows [0, lenA+2ry)
//   piece B: padded window rows [0, lenB+2ry)      at scratch rows [lenA+2ry, Ys+4ry)
// with lenA = min(Ys, Y−w0) and lenB = Ys−lenA, so every target row has its
// own ±ry source rows and the two sides of the seam never merge. A point
// whose ±ry neighbourhood misses the slab lands in neither piece (the TPU
// form's slab prefilter); a point near both ends may land in both, and each
// piece's voxel is zeroed and summed on its own. The scratch scales with Ys.
//
// Float adds in atomic order differ from run to run in the last bits; n, hit
// and min_height are exact.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int pmod(int a, int n) {
    int r = a % n;
    return r < 0 ? r + n : r;
}

// One point: its sub-voxel coordinates, its torus voxel for hit and
// min_height (or −1), and its voxel in each piece of the sums scratch (or −1).
struct Point {
    float l[3];
    int t;
    int s[2];
};

template <bool SLAB>
__device__ __forceinline__ Point locate(
    const float* __restrict__ pn, const uint8_t* __restrict__ keep, const int* __restrict__ origin,
    int i, int n, int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys)
{
    Point q;
    q.l[0] = q.l[1] = q.l[2] = 0.0f;
    q.t = q.s[0] = q.s[1] = -1;
    if (i >= n || !keep[i]) return q;
    int v[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float p = pn[3 * i + a];
        const float f = floorf(p);
        v[a] = (int)f;
        q.l[a] = __fsub_rn(p, f);
    }
    if (v[0] >= 0 && v[0] < X && v[1] >= 0 && v[1] < Y && v[2] >= 0 && v[2] < Z) {
        const int row = pmod(v[1] + origin[1], Y) - ys0;   // slab row
        if (row >= 0 && row < Ys)
            q.t = (pmod(v[0] + origin[0], X) * Ys + row) * Z + pmod(v[2] + origin[2], Z);
    }
    const int Xp = X + 2 * rx, Yp = Y + 2 * ry, Zp = Z + 2 * rz;
    const int q0 = v[0] + rx, q1 = v[1] + ry, q2 = v[2] + rz;
    if (q0 < 0 || q0 >= Xp || q1 < 0 || q1 >= Yp || q2 < 0 || q2 >= Zp) return q;
    if (!SLAB) {
        q.s[0] = (q0 * Yp + q1) * Zp + q2;
    } else {
        const int w0 = pmod(ys0 - origin[1], Y);
        const int lenA = min(Ys, Y - w0), lenB = Ys - lenA;
        const int Ysc = Ys + 4 * ry;
        if (q1 >= w0 && q1 < w0 + lenA + 2 * ry) q.s[0] = (q0 * Ysc + q1 - w0) * Zp + q2;
        if (lenB > 0 && q1 < lenB + 2 * ry) q.s[1] = (q0 * Ysc + lenA + 2 * ry + q1) * Zp + q2;
    }
    return q;
}

__device__ __forceinline__ bool leads(unsigned grp) {
    return __ffs(grp) - 1 == (int)(threadIdx.x & 31);
}

// hit = 0, min_height = 1.0f (as int bits), n = 0
__global__ void __launch_bounds__(THREADS) fill_kernel(int* __restrict__ hit, int* __restrict__ minh_bits,
                                                       float* __restrict__ n, int V, int P, bool vec4)
{
    const int stride = gridDim.x * THREADS;
    const int one = __float_as_int(1.0f);
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (vec4) {
        for (int k = i; k < V / 4; k += stride) {
            reinterpret_cast<int4*>(hit)[k] = make_int4(0, 0, 0, 0);
            reinterpret_cast<int4*>(minh_bits)[k] = make_int4(one, one, one, one);
        }
        for (int k = i; k < P / 4; k += stride) reinterpret_cast<float4*>(n)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        // the tails past the last multiple of 4
        for (int k = V / 4 * 4 + i; k < V; k += stride) {
            hit[k] = 0;
            minh_bits[k] = one;
        }
        for (int k = P / 4 * 4 + i; k < P; k += stride) n[k] = 0.0f;
    } else {
        for (int k = i; k < V; k += stride) {
            hit[k] = 0;
            minh_bits[k] = one;
        }
        for (int k = i; k < P; k += stride) n[k] = 0.0f;
    }
}

constexpr int H = 2 * THREADS;          // slots of the block's table of torus voxels

template <int N>
__device__ __forceinline__ int insert(int* keys, int key) {
    int h = (int)(((unsigned)key * 2654435761u) % N);
    while (true) {
        const int prev = atomicCAS(keys + h, -1, key);
        if (prev == -1 || prev == key) return h;
        h = h + 1 == N ? 0 : h + 1;
    }
}

template <bool SLAB>
__global__ void __launch_bounds__(THREADS) bin_count_kernel(
    const float* __restrict__ pn, const uint8_t* __restrict__ keep, const int* __restrict__ origin,
    int n, int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys, int P,
    int* __restrict__ hit, int* __restrict__ minh_bits, float* __restrict__ sums)
{
    constexpr int HS = SLAB ? 3 * H / 2 : H;
    __shared__ int tkeys[H], tcnt[H], tmin[H], skeys[HS], scnt[HS];
    for (int i = threadIdx.x; i < HS; i += THREADS) {
        if (i < H) { tkeys[i] = -1; tcnt[i] = 0; tmin[i] = INT_MAX; }
        skeys[i] = -1; scnt[i] = 0;
    }
    __syncthreads();
    const Point q = locate<SLAB>(pn, keep, origin, blockIdx.x * THREADS + threadIdx.x, n, X, Y, Z,
                                 rx, ry, rz, ys0, Ys);
    // the warp's equal voxels first, then the block's table
    {
        const unsigned grp = __match_any_sync(FULL, q.t);
        const int m = __reduce_min_sync(grp, q.t >= 0 ? __float_as_int(q.l[2]) : INT_MAX);
        if (q.t >= 0 && leads(grp)) {
            const int h = insert<H>(tkeys, q.t);
            atomicAdd(tcnt + h, __popc(grp));
            atomicMin(tmin + h, m);
        }
    }
#pragma unroll
    for (int piece = 0; piece < (SLAB ? 2 : 1); ++piece) {
        const int s = q.s[piece];
        const unsigned grp = __match_any_sync(FULL, s);
        if (s >= 0 && leads(grp)) atomicAdd(scnt + insert<HS>(skeys, s), __popc(grp));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < HS; i += THREADS) {
        if (i < H && tkeys[i] >= 0) {
            atomicAdd(hit + tkeys[i], tcnt[i]);
            atomicMin(minh_bits + tkeys[i], tmin[i]);
        }
        const int s = skeys[i];
        if (s >= 0 && atomicAdd(sums + s, (float)scnt[i]) == 0.0f) {
#pragma unroll
            for (int c = 1; c < 10; ++c) sums[(int64_t)c * P + s] = 0.0f;
        }
    }
}

template <bool SLAB>
__global__ void __launch_bounds__(THREADS) bin_sums_kernel(
    const float* __restrict__ pn, const uint8_t* __restrict__ keep, const int* __restrict__ origin,
    int n, int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys, int P,
    float* __restrict__ sums)
{
    constexpr int HS = SLAB ? 3 * H / 2 : H;
    __shared__ int skeys[HS];
    __shared__ float svals[9][HS];
    __shared__ float vals[9][THREADS];
    for (int i = threadIdx.x; i < HS; i += THREADS) {
        skeys[i] = -1;
#pragma unroll
        for (int c = 0; c < 9; ++c) svals[c][i] = 0.0f;
    }
    __syncthreads();
    const Point q = locate<SLAB>(pn, keep, origin, blockIdx.x * THREADS + threadIdx.x, n, X, Y, Z,
                                 rx, ry, rz, ys0, Ys);
    const float* l = q.l;
    const float v[9] = {l[0], l[1], l[2],
                        __fmul_rn(l[0], l[0]), __fmul_rn(l[0], l[1]), __fmul_rn(l[0], l[2]),
                        __fmul_rn(l[1], l[1]), __fmul_rn(l[1], l[2]), __fmul_rn(l[2], l[2])};
#pragma unroll
    for (int c = 0; c < 9; ++c) vals[c][threadIdx.x] = v[c];
    __syncwarp();
    const int base = threadIdx.x & ~31;
#pragma unroll
    for (int piece = 0; piece < (SLAB ? 2 : 1); ++piece) {
        const int s = q.s[piece];
        const unsigned grp = __match_any_sync(FULL, s);
        if (s >= 0 && leads(grp)) {
            float acc[9];
#pragma unroll
            for (int c = 0; c < 9; ++c) acc[c] = v[c];
            for (unsigned rest = grp & (grp - 1); rest; rest &= rest - 1) {
                const int j = base + __ffs(rest) - 1;
#pragma unroll
                for (int c = 0; c < 9; ++c) acc[c] = __fadd_rn(acc[c], vals[c][j]);
            }
            const int h = insert<HS>(skeys, s);
#pragma unroll
            for (int c = 0; c < 9; ++c) atomicAdd(&svals[c][h], acc[c]);
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < HS; i += THREADS) {
        const int s = skeys[i];
        if (s < 0) continue;
#pragma unroll
        for (int c = 0; c < 9; ++c) atomicAdd(sums + (int64_t)(c + 1) * P + s, svals[c][i]);
    }
}

template <bool SLAB>
void launch_passes(const float* pn, const uint8_t* keep, const int* origin, int n,
                   int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys, int P,
                   int* hit, int* minh, float* sums, cudaStream_t st)
{
    const int blocks = (n + THREADS - 1) / THREADS;
    bin_count_kernel<SLAB><<<blocks, THREADS, 0, st>>>(pn, keep, origin, n, X, Y, Z, rx, ry, rz, ys0, Ys, P,
                                                       hit, minh, sums);
    bin_sums_kernel<SLAB><<<blocks, THREADS, 0, st>>>(pn, keep, origin, n, X, Y, Z, rx, ry, rz, ys0, Ys, P,
                                                      sums);
}

}  // namespace

// The fill, then the two passes, on `stream`.
extern "C" int gvom_bin_points(
    const void* pn, const void* keep, const void* origin,
    int n, int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys,
    void* hit, void* minh, void* sums, void* stream)
{
    const bool slab = !(ys0 == 0 && Ys == Y);
    const int64_t V = (int64_t)X * Ys * Z;
    const int64_t P = (int64_t)(X + 2 * rx) * (slab ? Ys + 4 * ry : Y + 2 * ry) * (Z + 2 * rz);
    if (V >= INT_MAX || P >= INT_MAX) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const bool vec4 = ((uintptr_t)hit | (uintptr_t)minh | (uintptr_t)sums) % 16 == 0;
    fill_kernel<<<132 * 8, THREADS, 0, st>>>((int*)hit, (int*)minh, (float*)sums, (int)V, (int)P, vec4);
    if (n > 0) {
        if (slab)
            launch_passes<true>((const float*)pn, (const uint8_t*)keep, (const int*)origin, n, X, Y, Z,
                                rx, ry, rz, ys0, Ys, (int)P, (int*)hit, (int*)minh, (float*)sums, st);
        else
            launch_passes<false>((const float*)pn, (const uint8_t*)keep, (const int*)origin, n, X, Y, Z,
                                 rx, ry, rz, ys0, Ys, (int)P, (int*)hit, (int*)minh, (float*)sums, st);
    }
    return (int)cudaGetLastError();
}
