// K1: free-space pass counts of S scans (the reference's DDA march,
// gvom.py:1091-1150), each scan's rays from its own ego, all into one grid.
//
// Replaces gvom_tpu/ops/pallas_kernels.py::_run_hist as driven by
// ray_pass_counts_matmul, which takes (points, keep, ego, origin), builds the
// ray geometry itself and recasts the march as per-(axis, sign, step) one-hot
// matmul histograms because a TPU has no scatter. It is also the counterpart
// of _run_hist_steppair (the same counts for steps 1..30, two steps per
// matmul row): a per-ray march has no matmul rows to pair. On the H100 the
// march is what it is: one thread per ray walks k = 1..kmax and adds one to
// each traversed voxel of the torus-placed [X, Y, Z] grid.
//
// The kernel ADDS into `out`, so the batched step's S scans land in one miss
// grid; the wrapper zeroes a fresh one. Slab form (y_window): with (ys0, Ys)
// the output is [X, Ys, Z], the torus rows [ys0, ys0+Ys) of the full grid;
// a step whose torus row lies outside the slab is dropped (SLAB = false
// compiles the row test away).
//
// What bounds it on the H100. Not bytes: a scan reads 1.7 MB of points and
// writes a 16.8 MB grid (5.5 µs at 3.35 TB/s). Not arithmetic: ~40 f32
// operations a ray and ~8 a step. Its first version ran at about 28 G
// int32 atomics/s against an uncontended 89 G/s, because rays fan out from
// the ego and the scan's point order is azimuth-major (a warp's 32 rays are
// one vertical fan): the voxels around the ego take thousands of adds each,
// serialised at one L2 address. It also read six march tensors that PyTorch
// built in float64 round-to-odd emulation (dozens of launches on the batched
// step's 4.19 M points), and took one launch per scan (half the card's warp
// slots for one scan's 131,072 rays).
//
// The design:
//   * the geometry in registers, rounded as the plain twin
//     (ops/raycast.py ray_geometry + march_inputs, the JAX package's compiled
//     arithmetic): start = ego·inv; slope = fma(p, inv, −start); the squared
//     length as two fma onto v0·v0; __fsqrt_rn; correctly rounded
//     __fdiv_rn for slope/length, s/smax and 1/smax; the dominant axis's tie
//     order z, then y, then x; the dominant step exactly ±1;
//     budget = length − 1; start_rel = fma(ego, inv, −origin). -fmad=false
//     keeps nvcc from contracting anything else;
//   * one launch for all S scans: a grid of (ray blocks, scan);
//   * cheap steps: the torus offsets are reduced once per ray; the dominant
//     row and its torus row are incremented; the other two axes take one
//     floor and one conditional subtract each; a ray ends at its first dead
//     step or when it leaves the grid (positions are monotone in k, so the
//     in-grid steps are one run);
//   * fewer same-address atomics: each warp's equal addresses are merged
//     with __match_any_sync, the group's lowest lane adding its size. A
//     block-private shared histogram of the cube around the scan's ego was
//     tried beside it on the card, alone and together with it (PERF.md §6):
//     warp aggregation was the fastest on a batched step's 32 scans and no
//     slower on one scan. Integer adds commute, so the counts are those of
//     one atomic a pass, bit for bit.
//
// Exactness: the dominant step is exactly ±1 and its row is the integer
// floor(start_rel) ± k (the rules of gvom_tpu/ops/raycast.py). A position is
// one fused multiply-add, fma(k, step, start_rel): gvom_tpu/ops/raycast.py
// states the rule as the product rounded before the add, but XLA:CPU
// contracts it into an FMA through its optimization_barrier, and the Pallas
// K1 in interpret mode computes the same FMA, so the port follows them.
// Liveness is fl((k−1)·delta) < budget, with no add to contract.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int pmod(int a, int n) {
    int r = a % n;
    return r < 0 ? r + n : r;
}

template <typename T>
__device__ __forceinline__ T pick(const T (&a)[3], int i) {
    return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

template <bool SLAB>
__global__ void __launch_bounds__(THREADS) ray_pass_counts_kernel(
    const float* __restrict__ points,          // [S, N, 3] world frame
    const unsigned char* __restrict__ keep,    // [S, N]
    const float* __restrict__ egos,            // [S, 3]
    const int* __restrict__ origin,            // [3]
    float inv_xy, float inv_z,
    int n, int ray_steps, int X, int Y, int Z, int ys0, int Ys,
    int* __restrict__ out)                     // [X, Ys, Z], added into
{
    const int scan = blockIdx.y;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const float inv[3] = {inv_xy, inv_xy, inv_z};
    const int size[3] = {X, Y, Z};
    const int stride[3] = {Ys * Z, Z, 1};
    float e[3], r[3];
    int om[3], si[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const int o = origin[a];
        om[a] = pmod(o, size[a]);
        e[a] = egos[3 * scan + a];
        r[a] = __fmaf_rn(e[a], inv[a], -(float)o);     // start_rel: the scan's ego in window voxels
        si[a] = (int)floorf(r[a]);
    }

    const int64_t ray = (int64_t)scan * n + i;
    if (i < n && keep[ray]) {
        // ---- the ray's geometry ----
        float sl[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) sl[a] = __fmaf_rn(points[3 * ray + a], inv[a], -__fmul_rn(e[a], inv[a]));
        const float len = __fsqrt_rn(__fmaf_rn(sl[2], sl[2], __fmaf_rn(sl[1], sl[1], __fmul_rn(sl[0], sl[0]))));
        float sv[3] = {0.0f, 0.0f, 0.0f}, ab[3] = {0.0f, 0.0f, 0.0f};
        if (len > 0.0f) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                sv[a] = __fdiv_rn(sl[a], len);
                ab[a] = fabsf(sv[a]);
            }
        }
        const float smax = fmaxf(fmaxf(ab[0], ab[1]), ab[2]);
        if (smax > 0.0f) {
            const int dm = smax == ab[2] ? 2 : (smax == ab[1] ? 1 : 0);
            const int u = dm == 0 ? 1 : 0, w = dm == 2 ? 1 : 2;    // the other two axes
            const float delta = __fdiv_rn(1.0f, smax);
            const float budget = __fsub_rn(len, 1.0f);
            const int sgn = pick(sv, dm) < 0.0f ? -1 : 1;
            const float su = __fdiv_rn(pick(sv, u), smax), sw = __fdiv_rn(pick(sv, w), smax);
            const float ru = pick(r, u), rw = pick(r, w);
            const int nd = pick(size, dm), nu = pick(size, u), nw = pick(size, w);
            const int ou = pick(om, u), ow = pick(om, w);
            const int std_ = pick(stride, dm), stu = pick(stride, u), stw = pick(stride, w);
            // the slot of the y axis among (dm, u, w), for the slab's row test
            const int yslot = dm == 1 ? 0 : (u == 1 ? 1 : 2);
            int vd = pick(si, dm);
            int td = pmod(vd + pick(om, dm), nd);
            bool entered = false;
            for (int k = 1; k <= ray_steps; ++k) {
                const float kf = (float)k;
                // liveness is monotone in k, so the first dead step ends the ray
                if (!(__fmul_rn(kf - 1.0f, delta) < budget)) break;
                vd += sgn;
                td += sgn;
                td = td == nd ? 0 : (td < 0 ? nd - 1 : td);
                const int vu = __float2int_rd(__fmaf_rn(kf, su, ru));
                const int vw = __float2int_rd(__fmaf_rn(kf, sw, rw));
                if (!((unsigned)vd < (unsigned)nd && (unsigned)vu < (unsigned)nu && (unsigned)vw < (unsigned)nw)) {
                    if (entered) break;      // the in-grid steps are one run
                    continue;
                }
                entered = true;
                int tu = vu + ou, tw = vw + ow;
                tu -= tu >= nu ? nu : 0;
                tw -= tw >= nw ? nw : 0;
                if (SLAB) {
                    const int ty = (yslot == 0 ? td : (yslot == 1 ? tu : tw)) - ys0;
                    if ((unsigned)ty >= (unsigned)Ys) continue;
                }
                const int flat = td * std_ + tu * stu + tw * stw - (SLAB ? ys0 * Z : 0);
                // the lanes that add to one voxel: the lowest adds them all
                const unsigned grp = __match_any_sync(__activemask(), flat);
                if (__ffs(grp) - 1 == (int)(threadIdx.x & 31)) atomicAdd(out + flat, __popc(grp));
            }
        }
    }
}

}  // namespace

extern "C" int gvom_ray_pass_counts(
    const void* points, const void* keep, const void* egos, const void* origin,
    float inv_xy, float inv_z, int S, int n, int ray_steps, int X, int Y, int Z, int ys0, int Ys,
    void* out, void* stream)
{
    if ((int64_t)X * Ys * Z >= (int64_t)1 << 31 || S > 65535) return (int)cudaErrorInvalidValue;
    if (n > 0 && S > 0) {
        const dim3 grid((n + THREADS - 1) / THREADS, S);
        cudaStream_t st = (cudaStream_t)stream;
        if (ys0 == 0 && Ys == Y) {
            ray_pass_counts_kernel<false><<<grid, THREADS, 0, st>>>(
                (const float*)points, (const unsigned char*)keep, (const float*)egos, (const int*)origin,
                inv_xy, inv_z, n, ray_steps, X, Y, Z, ys0, Ys, (int*)out);
        } else {
            ray_pass_counts_kernel<true><<<grid, THREADS, 0, st>>>(
                (const float*)points, (const unsigned char*)keep, (const float*)egos, (const int*)origin,
                inv_xy, inv_z, n, ray_steps, X, Y, Z, ys0, Ys, (int*)out);
        }
    }
    return (int)cudaGetLastError();
}
