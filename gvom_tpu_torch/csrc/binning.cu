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
//   * the map-local coordinate pn = fma(p, 1/res, −origin) of each world
//     point is computed here, rounded once as the JAX kernel's
//     (pallas_kernels.py:1540) and as K1 computes its ray starts, so no
//     caller writes an [N, 3] array of them;
//   * the ten own-voxel raw sums (n, S1, R2) with f32 atomicAdd on the
//     padded X+2rx, Y+2ry, Z+2rz window layout; the box over them is kernel
//     K3's and K5's work (epilogue.cu).
//
// Contract of the sums: n [P] is the call's own. Channels 1–9 live in
// `rest`, which the caller keeps across calls (made once with zeros), beside
// `touched`, a byte a voxel of rest. Its layout: channels 1–8 voxel-major,
// [P][8], 32 bytes a voxel (one sector), then channel 9 [P]. Between calls
// rest is zero wherever touched is 0; a call's fill puts rest back to zero
// wherever touched is set and clears touched, and the call sets touched at
// every voxel it adds to, so after the call rest holds the call's sums where
// n > 0 and zero elsewhere. Every consumer (the epilogue, its plain twins) reads
// channels 1–9 only where n > 0.
//
// What bounds it on the H100. Not arithmetic (~30 f32 operations a point).
// Its bytes are the points and the outputs; its first version also filled all
// ten channels of the scratch (211 MB with hit and min_height at 256×256×64,
// 0.063 ms at 3.35 TB/s, more than the kernel proper), although nothing reads
// nine of them where n is 0. Its atomics: twelve a point, which on a batched
// step's 4.19 M points ran at the card's uncontended atomic rate (0.6 ms),
// since a warp's 32 lanes held 32 beams of one azimuth column and no add was
// merged before it reached L2. Past that, what a block does for each point
// and for itself (load and locate each point, match it in its warp, set up
// and scan its table) costs more than the merged atomics, so the count and
// the sums share one pass over the points (PERF.md §6).
//
// The design:
//   * fill only what every consumer reads: one launch sets hit to 0,
//     min_height to 1.0f and n to 0 (16-byte stores), and clears rest
//     where touched is set (a read of P bytes, eight at a time; each touched
//     voxel's row of channels 1–8 with two 16-byte stores, and channel 9's
//     32-byte sector of the eight voxels: the last call's ~43 k voxels,
//     cleared one float at a time, took 0.033 ms, PERF.md §6);
//   * a block whose points all fall outside the padded window (the
//     padding of a batch's ragged scans: every slot past a scan's returns)
//     leaves before it sets up a table;
//   * one pass loads and locates each point once and merges it into one
//     table of window voxels, which counts n and, where the voxel
//     is in the grid (its targets), also counts hit and takes min_height:
//     an in-grid point's torus voxel and its window voxel are one voxel.
//     Each table slot is flushed once. The lane that flushes a voxel marks
//     it in touched (a plain byte store, not an atomic whose old value the
//     lane would wait for). No add can land before a zeroing, since the
//     zeroing was the fill's, one launch before;
//   * equal voxels are merged before the global atomic, twice: each warp's
//     (__match_any_sync: the group's lowest lane takes the group's count, its
//     min by __reduce_min_sync, and the sums of its nine values in lane
//     order, from the lanes' coordinates in shared memory), then the
//     block's, in a hash table of window voxels in shared memory, whose
//     slots are flushed with four global reductions: n, channels 1–8 as two
//     16-byte vector adds (sm_90's atomicAdd(float4*), RED.E.ADD.F32x4 in
//     the SASS, at the scalar add's rate, PERF.md §6) and channel 9. A block's
//     256 points are two azimuth columns of a scan, whose endpoints largely
//     share voxels; a warp's are 32 beams of one column.
//     Tried beside it on the card (PERF.md §6): the warp merge alone, a warp
//     across 32 scans of a batch (lane i on one point of scan s + i), and
//     blocks of 1,024 to 4,096 points (slots of consecutive scans) taken in
//     rounds through one table: fewer flushes, but slower, since each block
//     then waits through its rounds one after another.
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
// slab. The scratch is [Xp, Ys+4ry, Zp] voxels:
//   piece A: padded window rows [w0, w0+lenA+2ry)  at scratch rows [0, lenA+2ry)
//   piece B: padded window rows [0, lenB+2ry)      at scratch rows [lenA+2ry, Ys+4ry)
// with lenA = min(Ys, Y−w0) and lenB = Ys−lenA, so every target row has its
// own ±ry source rows and the two sides of the seam never merge. A point
// whose ±ry neighbourhood misses the slab lands in neither piece (the TPU
// form's slab prefilter); a point near both ends may land in both, and each
// piece's voxel is summed on its own. The scratch scales with Ys (its rest
// holds channels 1–8 of its P voxels voxel-major, then channel 9, as above).
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
// min_height (or −1), its voxel in each piece of the sums scratch (or −1),
// and the piece in which its torus voxel is a target, not a pad or halo
// voxel (or −1): in-grid points and a piece's targets are one set.
struct Point {
    float l[3];
    int t;
    int s[2];
    int tp;
};

template <bool SLAB>
__device__ __forceinline__ Point locate(
    const float* __restrict__ points, const uint8_t* __restrict__ keep, const int* __restrict__ origin,
    float inv_xy, float inv_z, int i, int n, int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys)
{
    Point q;
    q.l[0] = q.l[1] = q.l[2] = 0.0f;
    q.t = q.s[0] = q.s[1] = q.tp = -1;
    if (i >= n || !keep[i]) return q;
    const float inv[3] = {inv_xy, inv_xy, inv_z};
    int v[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float p = __fmaf_rn(points[3 * i + a], inv[a], -(float)origin[a]);
        const float f = floorf(p);
        v[a] = (int)f;
        q.l[a] = __fsub_rn(p, f);
    }
    const int w0 = SLAB ? pmod(ys0 - origin[1], Y) : 0;
    const int lenA = SLAB ? min(Ys, Y - w0) : Ys, lenB = Ys - lenA;
    if (v[0] >= 0 && v[0] < X && v[1] >= 0 && v[1] < Y && v[2] >= 0 && v[2] < Z) {
        const int row = pmod(v[1] + origin[1], Y) - ys0;   // slab row
        if (row >= 0 && row < Ys) {
            q.t = (pmod(v[0] + origin[0], X) * Ys + row) * Z + pmod(v[2] + origin[2], Z);
            q.tp = row < lenA ? 0 : 1;
        }
    }
    const int Xp = X + 2 * rx, Yp = Y + 2 * ry, Zp = Z + 2 * rz;
    const int q0 = v[0] + rx, q1 = v[1] + ry, q2 = v[2] + rz;
    if (q0 < 0 || q0 >= Xp || q1 < 0 || q1 >= Yp || q2 < 0 || q2 >= Zp) return q;
    if (!SLAB) {
        q.s[0] = (q0 * Yp + q1) * Zp + q2;
    } else {
        const int Ysc = Ys + 4 * ry;
        if (q1 >= w0 && q1 < w0 + lenA + 2 * ry) q.s[0] = (q0 * Ysc + q1 - w0) * Zp + q2;
        if (lenB > 0 && q1 < lenB + 2 * ry) q.s[1] = (q0 * Ysc + lenA + 2 * ry + q1) * Zp + q2;
    }
    return q;
}

__device__ __forceinline__ bool leads(unsigned grp) {
    return __ffs(grp) - 1 == (int)(threadIdx.x & 31);
}

// hit = 0, min_height = 1.0f (as int bits), n = 0; rest back to 0 at every
// touched byte, and the bytes to 0
__global__ void __launch_bounds__(THREADS) fill_kernel(int* __restrict__ hit, int* __restrict__ minh_bits,
                                                       float* __restrict__ n, int V, int P, bool vec4,
                                                       float* __restrict__ rest, uint8_t* __restrict__ touched)
{
    const int stride = gridDim.x * THREADS;
    const int one = __float_as_int(1.0f);
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4* rows = reinterpret_cast<float4*>(rest);     // channels 1–8: two float4 a voxel
    float* ninth = rest + 8 * (int64_t)P;
    if (P % 8 == 0) {
        // 8 voxels a load of touched (a byte is 0 or 1); rest is zero at the
        // untouched ones already, so channel 9's 32-byte sector of them is
        // written whole
        for (int k = i; k < P / 8; k += stride) {
            const uint2 w = reinterpret_cast<const uint2*>(touched)[k];
            if (!(w.x | w.y)) continue;
            reinterpret_cast<uint2*>(touched)[k] = make_uint2(0u, 0u);
            for (uint64_t b = (uint64_t)w.y << 32 | w.x; b; b &= b - 1) {
                const int64_t s = 8 * (int64_t)k + ((__ffsll((long long)b) - 1) >> 3);
                rows[2 * s] = zero;
                rows[2 * s + 1] = zero;
            }
            float4* d = reinterpret_cast<float4*>(ninth + 8 * (int64_t)k);
            d[0] = zero;
            d[1] = zero;
        }
    } else {
        for (int s = i; s < P; s += stride) {
            if (!touched[s]) continue;
            touched[s] = 0;
            rows[2 * (int64_t)s] = zero;
            rows[2 * (int64_t)s + 1] = zero;
            ninth[s] = 0.0f;
        }
    }
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

constexpr int H = 2 * THREADS;          // slots of the block's table of window voxels

template <int N>
__device__ __forceinline__ int insert(int* keys, int key) {
    int h = (int)(((unsigned)key * 2654435761u) % N);
    while (true) {
        const int prev = atomicCAS(keys + h, -1, key);
        if (prev == -1 || prev == key) return h;
        h = h + 1 == N ? 0 : h + 1;
    }
}

// The one pass: n, the nine sums into rest (channels 1–8 [P][8], channel 9
// [P]) and, at the piece's targets (the in-grid points), hit and
// min_height; it marks each voxel it adds to in touched.
//
// The block's table of window voxels holds no sums: each warp group writes
// its own record (its nine sums in lane order, its count) and pushes it on
// its slot's list with one atomicExch; the flush adds a slot's records.
// A float atomicAdd in shared memory is a compare-and-swap loop on the H100
// (nine a group), an exchange is one instruction.
template <bool SLAB>
__global__ void __launch_bounds__(THREADS) bin_sums_kernel(
    const float* __restrict__ points, const uint8_t* __restrict__ keep, const int* __restrict__ origin,
    float inv_xy, float inv_z, int n, int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys, int P,
    int* __restrict__ hit, int* __restrict__ minh_bits, float* __restrict__ cnt, float* __restrict__ rest,
    uint8_t* __restrict__ touched)
{
    constexpr int HS = SLAB ? 3 * H / 2 : H;
    constexpr int R = (SLAB ? 2 : 1) * THREADS;   // records: one a lane and piece
    // the table: key, the head of its records' list, the min of the
    // sub-voxel z bits and the torus voxel (set where the slot is a target:
    // its min < INT_MAX); the records: nine sums, count, next; each lane's
    // sub-voxel coordinates
    __shared__ int skeys[HS], shead[HS], smin[HS], stor[HS];
    __shared__ float rvals[9][R];
    __shared__ int rcnt[R], rnext[R];
    __shared__ float ls[3][THREADS];
    const Point q = locate<SLAB>(points, keep, origin, inv_xy, inv_z, blockIdx.x * THREADS + threadIdx.x, n,
                                 X, Y, Z, rx, ry, rz, ys0, Ys);
    // a block none of whose points falls inside the padded window leaves
    // before it sets up its table
    if (!__syncthreads_or(q.s[0] >= 0 || q.s[1] >= 0)) return;
    for (int i = threadIdx.x; i < HS; i += THREADS) {
        smin[i] = INT_MAX;
        skeys[i] = shead[i] = -1;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) ls[a][threadIdx.x] = q.l[a];
    __syncthreads();
    const int base = threadIdx.x & ~31;
#pragma unroll
    for (int piece = 0; piece < (SLAB ? 2 : 1); ++piece) {
        const int s = q.s[piece];
        const unsigned grp = __match_any_sync(FULL, s);
        const int m = __reduce_min_sync(grp, q.tp == piece ? __float_as_int(q.l[2]) : INT_MAX);
        if (s >= 0 && leads(grp)) {
            // the group's nine values in lane order, each product rounded once
            float acc[9];
            for (unsigned g = grp; g; g &= g - 1) {
                const int j = base + __ffs(g) - 1;
                const float a = ls[0][j], b = ls[1][j], c = ls[2][j];
                const float v[9] = {a, b, c, __fmul_rn(a, a), __fmul_rn(a, b), __fmul_rn(a, c),
                                    __fmul_rn(b, b), __fmul_rn(b, c), __fmul_rn(c, c)};
#pragma unroll
                for (int k = 0; k < 9; ++k) acc[k] = g == grp ? v[k] : __fadd_rn(acc[k], v[k]);
            }
            const int r = piece * THREADS + threadIdx.x;
#pragma unroll
            for (int c = 0; c < 9; ++c) rvals[c][r] = acc[c];
            const int h = insert<HS>(skeys, s);
            rcnt[r] = __popc(grp);
            if (q.tp == piece) {
                stor[h] = q.t;
                atomicMin(smin + h, m);
            }
            rnext[r] = atomicExch(shead + h, r);
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < HS; i += THREADS) {
        const int s = skeys[i];
        if (s < 0) continue;
        int r = shead[i];
        float sum[9];
#pragma unroll
        for (int c = 0; c < 9; ++c) sum[c] = rvals[c][r];
        int count = rcnt[r];
        for (r = rnext[r]; r >= 0; r = rnext[r]) {
#pragma unroll
            for (int c = 0; c < 9; ++c) sum[c] = __fadd_rn(sum[c], rvals[c][r]);
            count += rcnt[r];
        }
        atomicAdd(cnt + s, (float)count);
        touched[s] = 1;
        if (smin[i] != INT_MAX) {
            atomicAdd(hit + stor[i], count);
            atomicMin(minh_bits + stor[i], smin[i]);
        }
        // channels 1–8 in two 16-byte reductions, then channel 9
        float4* row = reinterpret_cast<float4*>(rest) + 2 * (int64_t)s;
        atomicAdd(row, make_float4(sum[0], sum[1], sum[2], sum[3]));
        atomicAdd(row + 1, make_float4(sum[4], sum[5], sum[6], sum[7]));
        atomicAdd(rest + 8 * (int64_t)P + s, sum[8]);
    }
}

}  // namespace

// The fill, then the pass, on `stream`. points are world-frame [n, 3];
// inv_xy and inv_z are f32(1/res). `cnt` is n [P]; rest (9·P floats, 16-byte
// aligned) and touched [P] (bytes) are the caller's, kept across calls (the
// contract above).
extern "C" int gvom_bin_points(
    const void* points, const void* keep, const void* origin, float inv_xy, float inv_z,
    int n, int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys,
    void* hit, void* minh, void* cnt, void* rest, void* touched, void* stream)
{
    const bool slab = !(ys0 == 0 && Ys == Y);
    const int64_t V = (int64_t)X * Ys * Z;
    const int64_t P = (int64_t)(X + 2 * rx) * (slab ? Ys + 4 * ry : Y + 2 * ry) * (Z + 2 * rz);
    if (V >= INT_MAX || P >= INT_MAX) return (int)cudaErrorInvalidValue;
    if (rest == nullptr || touched == nullptr || ((uintptr_t)rest | (uintptr_t)touched) % 16)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const bool vec4 = ((uintptr_t)hit | (uintptr_t)minh | (uintptr_t)cnt) % 16 == 0;
    fill_kernel<<<132 * 8, THREADS, 0, st>>>((int*)hit, (int*)minh, (float*)cnt, (int)V, (int)P, vec4, (float*)rest,
                                             (uint8_t*)touched);
    if (n > 0) {
        const int blocks = (n + THREADS - 1) / THREADS;
        const float* p = (const float*)points;
        const uint8_t* kp = (const uint8_t*)keep;
        const int* o = (const int*)origin;
        if (slab)
            bin_sums_kernel<true><<<blocks, THREADS, 0, st>>>(p, kp, o, inv_xy, inv_z, n, X, Y, Z, rx, ry, rz, ys0, Ys,
                                                              (int)P, (int*)hit, (int*)minh, (float*)cnt, (float*)rest,
                                                              (uint8_t*)touched);
        else
            bin_sums_kernel<false><<<blocks, THREADS, 0, st>>>(p, kp, o, inv_xy, inv_z, n, X, Y, Z, rx, ry, rz, ys0, Ys,
                                                               (int)P, (int*)hit, (int*)minh, (float*)cnt, (float*)rest,
                                                               (uint8_t*)touched);
    }
    return (int)cudaGetLastError();
}
