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
// slots for one scan's 131,072 rays). With those fixed, idle lanes: a warp
// marches as long as its longest ray, and one vertical fan mixes downward
// beams that meet the ground within 5-12 voxels with near-horizontal ones
// that run 50-170. On the lap of benchmark/ (the OS1-128, about 66,000
// returns of 131,072 rays a scan, median 10-12 steps, p99 121-144) only
// 0.28-0.31 of the lane-steps a warp issues in launch order are a ray's.
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
//   * each ray's live steps L before the march: the k of 1..ray_steps with
//     fl((k−1)·delta) < budget are a prefix (liveness is monotone in k), so
//     L is ⌈budget/delta⌉ corrected by that very predicate, and the march
//     runs k = 1..L with no liveness test;
//   * length-coherent warps: each block sorts its rays by L (capped at
//     KEY_MAX, a stable radix sort in shared memory, cub::BlockRadixSort),
//     stages what the march needs (the two minor slopes, L, the dominant
//     axis and sign: 13 B a ray) in shared memory, and each thread marches
//     the ray at its sorted slot, so a warp's 32 lanes walk rays of near
//     equal length and a block's dead rays fill whole warps that do
//     nothing. On the lap the lane utilisation rises to 0.72-0.76 with 256
//     rays a block and to 0.92-0.93 with 1,024 (kernels.ray_march_stats and
//     its plain twin count it), and the atomics after the warp merge fall by
//     29-36 %: rays of one length in neighbouring azimuths share voxels. The
//     window follows the launch's shape (kernels.ray_window, from S·n and
//     the card's SMs): 1,024 rays a block, four a thread, where that still
//     gives every SM 8 blocks, else 256, so that one scan leaves no SM idle;
//     one body for both. A block with no live ray returns before its sort;
//   * one launch for all S scans: a grid of (ray blocks, scan);
//   * cheap steps: the torus offsets are reduced once per ray; the dominant
//     row and its torus row are incremented; the other two axes take one
//     floor and one conditional subtract each; a ray ends after its L
//     steps or when it leaves the grid (positions are monotone in k, so the
//     in-grid steps are one run);
//   * fewer same-address atomics: each warp's equal addresses are merged
//     with __match_any_sync, the group's lowest lane adding its size. A
//     block-private shared histogram of the cube around the scan's ego was
//     tried beside it on the card, alone and together with it (PERF.md §6):
//     warp aggregation was the fastest on a batched step's 32 scans and no
//     slower on one scan. Integer adds commute, so the counts are those of
//     one atomic a pass, bit for bit, in any order of the rays.
//
// ray_march_stats_kernel is the same body with STATS on, under another
// name (a trace counts K1 as ray_pass_counts_kernel alone): it also adds
// into an int64 [3] the live lane-steps (march iterations of the rays),
// the issued lane-steps (32 × each warp's iterations) and the atomics
// after the warp merge, in the sorted order or in launch order.
//
// Exactness: the dominant step is exactly ±1 and its row is the integer
// floor(start_rel) ± k (the rules of gvom_tpu/ops/raycast.py). A position is
// one fused multiply-add, fma(k, step, start_rel): gvom_tpu/ops/raycast.py
// states the rule as the product rounded before the add, but XLA:CPU
// contracts it into an FMA through its optimization_barrier, and the Pallas
// K1 in interpret mode computes the same FMA, so the port follows them.
// Liveness is fl((k−1)·delta) < budget, with no add to contract; L is taken
// from that predicate, so the march walks the same steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr int THREADS = 256;
// six blocks an SM, at most 42 registers a thread: on an H100 the 1,024-ray
// form took 48 and five blocks without it, and marched the lap's batch
// 10-12 % slower
constexpr int MIN_BLOCKS = 6;
constexpr int KEY_MAX = 511;    // the sort key's cap: nine bits

__device__ __forceinline__ int pmod(int a, int n) {
    int r = a % n;
    return r < 0 ? r + n : r;
}

template <typename T>
__device__ __forceinline__ T pick(const T (&a)[3], int i) {
    return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

// One block: RPT·THREADS rays of one scan, geometry, the sort by live
// steps, then the march at the sorted slots (round j of thread t marches
// sorted slot j·THREADS + t, so each warp's round is 32 neighbours in the
// order). STATS adds the schedule's counts into stats; `sorted` false
// marches in launch order (the stats of the old schedule).
template <bool SLAB, bool STATS, int RPT>
__device__ __forceinline__ void march_block(
    const float* __restrict__ points, const unsigned char* __restrict__ keep, const float* __restrict__ egos,
    const int* __restrict__ origin, float inv_xy, float inv_z, int n, int ray_steps, int X, int Y, int Z,
    int ys0, int Ys, bool sorted, int* __restrict__ out, unsigned long long* __restrict__ stats)
{
    constexpr int W = RPT * THREADS;
    using Sort = cub::BlockRadixSort<unsigned short, THREADS, RPT, unsigned short>;
    __shared__ typename Sort::TempStorage sort_tmp;
    __shared__ float s_su[W], s_sw[W];
    __shared__ int s_live[W];
    __shared__ unsigned char s_axis[W];        // the dominant axis, | 4 where its step is −1

    const int scan = blockIdx.y;
    const int t = threadIdx.x;
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

    // ---- each ray's geometry and live steps, staged at its slot (blocked: thread t holds t·RPT + j) ----
    unsigned short key[RPT], slot[RPT];
    bool any = false;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const int sl_ = t * RPT + j;
        const int i = blockIdx.x * W + sl_;
        const int64_t ray = (int64_t)scan * n + i;
        int live = 0;
        float su = 0.0f, sw = 0.0f;
        int axis = 0;
        if (i < n && keep[ray]) {
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
            const float budget = __fsub_rn(len, 1.0f);
            // step 1 is live iff fl(0·delta) < budget
            if (smax > 0.0f && budget > 0.0f) {
                const int dm = smax == ab[2] ? 2 : (smax == ab[1] ? 1 : 0);
                const int u = dm == 0 ? 1 : 0, w = dm == 2 ? 1 : 2;    // the other two axes
                const float delta = __fdiv_rn(1.0f, smax);
                // L from ⌈budget/delta⌉, corrected by the predicate itself
                const float q = __fmul_rn(budget, smax);
                live = q < (float)ray_steps ? (int)ceilf(q) : ray_steps;
                while (live > 0 && !(__fmul_rn((float)(live - 1), delta) < budget)) --live;
                while (live < ray_steps && __fmul_rn((float)live, delta) < budget) ++live;
                su = __fdiv_rn(pick(sv, u), smax);
                sw = __fdiv_rn(pick(sv, w), smax);
                axis = dm | (pick(sv, dm) < 0.0f ? 4 : 0);
            }
        }
        s_su[sl_] = su;
        s_sw[sl_] = sw;
        s_live[sl_] = live;
        s_axis[sl_] = (unsigned char)axis;
        key[j] = (unsigned short)min(live, KEY_MAX);
        slot[j] = (unsigned short)(sorted ? sl_ : j * THREADS + t);
        any |= live > 0;
    }
    if (!__syncthreads_or(any)) return;       // a block of dead rays: nothing to sort or march
    if (sorted) {
        const int bits = 32 - __clz(max(1, min(ray_steps, KEY_MAX)));
        Sort(sort_tmp).SortBlockedToStriped(key, slot, 0, bits);
    }

    // ---- the march, round j at sorted slot j·THREADS + t ----
    const unsigned lane = t & 31;
    unsigned iters = 0, atoms = 0;
    unsigned long long warp_steps = 0;
#pragma unroll 1
    for (int j = 0; j < RPT; ++j) {
        const int sl_ = slot[j];
        const int live = s_live[sl_];
        int k = 1;
        if (live > 0) {
            const int ax = s_axis[sl_];
            const int dm = ax & 3;
            const int sgn = ax & 4 ? -1 : 1;
            const float su = s_su[sl_], sw = s_sw[sl_];
            const int u = dm == 0 ? 1 : 0, w = dm == 2 ? 1 : 2;
            const float ru = pick(r, u), rw = pick(r, w);
            const int nd = pick(size, dm), nu = pick(size, u), nw = pick(size, w);
            const int ou = pick(om, u), ow = pick(om, w);
            const int std_ = pick(stride, dm), stu = pick(stride, u), stw = pick(stride, w);
            // the slot of the y axis among (dm, u, w), for the slab's row test
            const int yslot = dm == 1 ? 0 : (u == 1 ? 1 : 2);
            int vd = pick(si, dm);
            int td = pmod(vd + pick(om, dm), nd);
            bool entered = false;
            for (; k <= live; ++k) {
                const float kf = (float)k;
                vd += sgn;
                td += sgn;
                td = td == nd ? 0 : (td < 0 ? nd - 1 : td);
                const int vu = __float2int_rd(__fmaf_rn(kf, su, ru));
                const int vw = __float2int_rd(__fmaf_rn(kf, sw, rw));
                if (!((unsigned)vd < (unsigned)nd && (unsigned)vu < (unsigned)nu && (unsigned)vw < (unsigned)nw)) {
                    if (entered) {       // the in-grid steps are one run
                        ++k;
                        break;
                    }
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
                if (__ffs(grp) - 1 == (int)lane) {
                    atomicAdd(out + flat, __popc(grp));
                    if (STATS) ++atoms;
                }
            }
        }
        if (STATS) {
            iters += k - 1;
            warp_steps += __reduce_max_sync(0xffffffffu, (unsigned)(k - 1));
        }
    }
    if (STATS) {
        iters = __reduce_add_sync(0xffffffffu, iters);
        atoms = __reduce_add_sync(0xffffffffu, atoms);
        if (lane == 0) {
            atomicAdd(stats + 0, (unsigned long long)iters);
            atomicAdd(stats + 1, 32ull * warp_steps);
            atomicAdd(stats + 2, (unsigned long long)atoms);
        }
    }
}

#define RAY_ARGS                                                                                      \
    const float *__restrict__ points, const unsigned char *__restrict__ keep,                          \
        const float *__restrict__ egos, const int *__restrict__ origin, float inv_xy, float inv_z, int n, \
        int ray_steps, int X, int Y, int Z, int ys0, int Ys, int *__restrict__ out
#define RAY_PASS points, keep, egos, origin, inv_xy, inv_z, n, ray_steps, X, Y, Z, ys0, Ys

template <bool SLAB, int RPT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ray_pass_counts_kernel(RAY_ARGS)
{
    march_block<SLAB, false, RPT>(RAY_PASS, true, out, nullptr);
}

template <bool SLAB, int RPT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ray_march_stats_kernel(RAY_ARGS, int sorted,
                                                                 unsigned long long* __restrict__ stats)
{
    march_block<SLAB, true, RPT>(RAY_PASS, sorted != 0, out, stats);
}

template <int RPT>
void launch(bool stats_on, bool sorted, const void* points, const void* keep, const void* egos, const void* origin,
            float inv_xy, float inv_z, int S, int n, int ray_steps, int X, int Y, int Z, int ys0, int Ys,
            void* out, void* stats, cudaStream_t st)
{
    const dim3 grid((n + RPT * THREADS - 1) / (RPT * THREADS), S);
    const bool slab = !(ys0 == 0 && Ys == Y);
    auto p = (const float*)points;
    auto k = (const unsigned char*)keep;
    auto e = (const float*)egos;
    auto o = (const int*)origin;
    auto g = (int*)out;
    auto c = (unsigned long long*)stats;
    if (stats_on) {
        if (slab) ray_march_stats_kernel<true, RPT><<<grid, THREADS, 0, st>>>(
            p, k, e, o, inv_xy, inv_z, n, ray_steps, X, Y, Z, ys0, Ys, g, sorted, c);
        else ray_march_stats_kernel<false, RPT><<<grid, THREADS, 0, st>>>(
            p, k, e, o, inv_xy, inv_z, n, ray_steps, X, Y, Z, ys0, Ys, g, sorted, c);
    } else {
        if (slab) ray_pass_counts_kernel<true, RPT><<<grid, THREADS, 0, st>>>(
            p, k, e, o, inv_xy, inv_z, n, ray_steps, X, Y, Z, ys0, Ys, g);
        else ray_pass_counts_kernel<false, RPT><<<grid, THREADS, 0, st>>>(
            p, k, e, o, inv_xy, inv_z, n, ray_steps, X, Y, Z, ys0, Ys, g);
    }
}

int run(bool stats_on, bool sorted, const void* points, const void* keep, const void* egos, const void* origin,
        float inv_xy, float inv_z, int S, int n, int ray_steps, int X, int Y, int Z, int ys0, int Ys, int window,
        void* out, void* stats, void* stream)
{
    if ((int64_t)X * Ys * Z >= (int64_t)1 << 31 || S > 65535 || (window != THREADS && window != 4 * THREADS))
        return (int)cudaErrorInvalidValue;
    if (n > 0 && S > 0) {
        auto st = (cudaStream_t)stream;
        if (window == THREADS)
            launch<1>(stats_on, sorted, points, keep, egos, origin, inv_xy, inv_z, S, n, ray_steps, X, Y, Z, ys0, Ys,
                      out, stats, st);
        else
            launch<4>(stats_on, sorted, points, keep, egos, origin, inv_xy, inv_z, S, n, ray_steps, X, Y, Z, ys0, Ys,
                      out, stats, st);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// window: the rays a block sorts and marches, 256 or 1,024 (kernels.ray_window)
extern "C" int gvom_ray_pass_counts(
    const void* points, const void* keep, const void* egos, const void* origin,
    float inv_xy, float inv_z, int S, int n, int ray_steps, int X, int Y, int Z, int ys0, int Ys, int window,
    void* out, void* stream)
{
    return run(false, true, points, keep, egos, origin, inv_xy, inv_z, S, n, ray_steps, X, Y, Z, ys0, Ys, window,
               out, nullptr, stream);
}

// the same march, adding its schedule's three counts into stats (int64 [3]);
// sorted = 0 marches each block's rays in launch order
extern "C" int gvom_ray_march_stats(
    const void* points, const void* keep, const void* egos, const void* origin,
    float inv_xy, float inv_z, int S, int n, int ray_steps, int X, int Y, int Z, int ys0, int Ys, int window,
    int sorted, void* out, void* stats, void* stream)
{
    return run(true, sorted != 0, points, keep, egos, origin, inv_xy, inv_z, S, n, ray_steps, X, Y, Z, ys0, Ys,
               window, out, stats, stream);
}
