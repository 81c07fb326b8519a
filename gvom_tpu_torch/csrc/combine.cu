// K4: the fused combine — ring-buffer slots + old world → new world and the
// per-column map products, in one pass.
//
// Replaces gvom_tpu/ops/pallas_kernels.py::fused_combine (body
// _combine_kernel_factory) and the XLA mom merge beside it
// (gvom_tpu/models/pipeline.py::_combine_fused). The TPU kernel left the
// mom merge to XLA only because of lane padding; here it is fused in.
//
// What it computes, per voxel, in slot order:
//   phase A: occupancy + slot-order evidence latching, then the old world's
//            decay veto (revive iff evidence <= decay_miss_limit,
//            gvom.py:992) and occupied-wins (gvom.py:947-950);
//   phase B: hit/miss sums and the min of min_height over occupied sources
//            (gvom.py:198-266), plus the ten moment channels (slot moms are
//            occupancy-pre-masked at ingest, so their mask is alignment ∧
//            valid; the old world's adds the new occupancy);
//   the any_valid latch: with no valid slot the old world passes through.
// Per column, with warp shuffles: height (first occupied voxel, bottom-up
// in window z, with the ego-disk seed), inferred height (first observed-
// empty voxel), and the positive-obstacle band sums num, den and band_ok
// (columns.cuh's column tail, which the batched merge, merge.cu, shares).
// Everything but mom is integer logic or the same f32 roundings as the XLA
// reference (explicit __fmaf_rn where XLA contracts a multiply-add), so it
// is bitwise equal to the plain version; the moments add slots 0..B−1 then
// the old world with __fadd_rn, the plain version's order, so they are too.
//
// Bound on the H100: bytes. Each voxel writes 4 + 10 channels and reads, of
// each of the B slots and the old world, the channels that the data makes
// it need (below): at most 1.34 GB at the upstream config (B = 4,
// 256×256×64), 0.40 ms at 3.35 TB/s; benchmark/roofline.py counts a run's share of
// it (combine_bound). Reaching it takes about 20 KB in flight per SM (3.35 TB/s ×
// ~0.8 µs of latency over 132 SMs), and the first version of this kernel
// kept 3–6 KB: a runtime slot loop whose every load fed a __fadd_rn chain
// before the next issued, 4-byte accesses, 72 registers.
//
// The design that follows from it:
//   * B (1..16) and the number of 64-voxel z-chunks ZC are template
//     parameters, so every slot, channel and chunk loop is unrolled and each
//     voxel's loads issue together before their first use: all B + 1
//     sources of the three scalar channels at once, then each moment
//     channel's B + 1 sources at once (the compiler hoists the next channel's
//     loads over the current adds as registers allow). One library holds one
//     B (-DGVOM_COMBINE_B): sixteen depths of fully unrolled code in one
//     build took 182 s on the H100's host, one depth takes seconds;
//   * one warp per (x, y) column, each lane two adjacent z: 8-byte int2 /
//     float2 loads and stores (PAIR) where Z <= 64 (ZC = 1: the upstream 64,
//     the 32 of small grids); any other Z up to 256, an odd Z or a pointer
//     that is not 8-byte aligned takes ZC = 4 with 4-byte accesses;
//   * streaming hints (__ldcs / __stcs) on the one-touch 3D channels; each
//     channel of a source is loaded only where the function needs it: a
//     slot's hit, miss and moments where it is aligned and valid, its
//     min_height where it is also occupied; the old world's hit and evidence
//     where it is aligned, its miss and min_height where its occupied voxel
//     stays occupied, its moments where it is aligned and the new world
//     occupied (everything when no slot is valid and it passes through);
//   * the alignment mask per source is a bit: x/y factors one source per lane
//     and a ballot per column, z windows per block in shared memory, one
//     torus reduction per thread (no % in the channel loop);
//   * __launch_bounds__(256, 4): at most 64 registers, 32 warps per SM.
//     Two, three and five blocks an SM were tried on the card and were no
//     faster (PERF.md §6): loads in flight, not occupancy, were the limit.
//
// Every depth and every Z the JAX package takes: past 16 slots or 256 z the
// unrolled kernel does not apply (its slot masks are bits of one word, its
// column lives in registers), and combine_any_kernel takes the combine. B
// is a runtime argument there; its first form looped over the slots
// one at a time, each slot's loads waiting on the previous slot's add chain,
// with 4-byte accesses and a second pass that read every scalar channel
// again: 30 % of its bound at B = 17, 42 % at Z = 320. Its design now:
//   * the slots in groups of ANY_GROUP, unrolled, a runtime loop over the
//     groups: a group's hit and miss, then its min_height, then each moment
//     channel's values issue together before the group's adds (in slot
//     order, as fuse_plain adds them);
//   * a warp takes its column's active slots (valid, the column inside
//     their window) 32 at a time, a ballot each, so any depth, and each
//     slot's z window from the lane that tested it (a shuffle). A slot left
//     out adds nothing: the unrolled kernel adds +0.0f for it, and a sum
//     that starts at +0.0f never holds -0.0f, so +0.0f added to it changes
//     no bit;
//   * a lane holds two adjacent z of each 64-z chunk (a runtime loop over
//     the chunks), with 8-byte accesses where Z is even and the pointers
//     aligned;
//   * one pass computes and stores every voxel output; what the band sums
//     read of a voxel (hit where occupied, hit + miss) stays in shared
//     memory for the column's second loop, which reads nothing else. Past
//     what 48 KB of shared memory holds for its eight columns (Z > 768) the
//     second loop computes them again from the column's scalar channels
//     (columns.cuh's band_sums, which the merge's form past 256 z shares).
// The arithmetic is the unrolled kernel's, in the same order, so its
// outputs are bitwise fuse_plain's too.

#include "columns.cuh"

#define MAX_B 16      // the unrolled kernel's depths; combine_any_kernel takes any other
#define MAX_ZC 4      // the unrolled kernel's 64-z chunks a column
#ifndef GVOM_COMBINE_B
#error "build with -DGVOM_COMBINE_B=<ring-buffer depth>, 1..16"
#endif

namespace {

struct CombineConsts : ColumnConsts {
    int decay;
};

// B ring-buffer slots, ZC chunks of 64 z per column (lane l holds z = 64c +
// 2l and 64c + 2l + 1), PAIR: 8-byte accesses (Z even, pointers aligned)
template <int B, int ZC, bool PAIR>
__global__ void __launch_bounds__(256, 4) combine_kernel(
    const int* __restrict__ meta,      // org [(B+2)*3] (slots, old, target), ival [B+2] (slot_valid×B, old valid, any_valid)
    const float* __restrict__ ego,     // [3]
    const int* __restrict__ bhit, const int* __restrict__ bmiss,
    const float* __restrict__ bminh, const float* __restrict__ bmom,   // [B+1, ...] buffer
    const int* __restrict__ ohit, const int* __restrict__ omiss,
    const float* __restrict__ ominh, const int* __restrict__ oev, const float* __restrict__ omom,
    int X, int Y, int Z, CombineConsts k,
    int* __restrict__ hit_o, int* __restrict__ miss_o, float* __restrict__ minh_o,
    int* __restrict__ ev_o, float* __restrict__ mom_o,
    float* __restrict__ hm_o, float* __restrict__ ihm_o,
    int* __restrict__ pnum_o, int* __restrict__ pden_o, int* __restrict__ bok_o)
{
    constexpr int NS = B + 1;             // sources: the B slots, then the old world (bit B)
    __shared__ int s_org[(B + 2) * 3];
    __shared__ int s_ival[B + 2];
    __shared__ int s_zlo[NS], s_zhi[NS];  // each source's z window, in window-relative z
    for (int i = threadIdx.x; i < (B + 2) * 3; i += blockDim.x) s_org[i] = meta[i];
    for (int i = threadIdx.x; i < B + 2; i += blockDim.x) s_ival[i] = meta[(B + 2) * 3 + i];
    __syncthreads();
    if (threadIdx.x < NS) {
        const int d = s_org[NS * 3 + 2] - s_org[3 * threadIdx.x + 2];
        s_zlo[threadIdx.x] = -min(d, 0);
        s_zhi[threadIdx.x] = Z - max(d, 0);
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int64_t col = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (col >= (int64_t)X * Y) return;
    const int x = (int)(col / Y), y = (int)(col % Y);
    const int64_t V = (int64_t)X * Y * Z;
    const int ot0 = s_org[NS * 3], ot1 = s_org[NS * 3 + 1], ot2 = s_org[NS * 3 + 2];
    const int ot2m = pmod(ot2, Z);
    const bool anyv = s_ival[B + 1] > 0;

    // x/y factors of the alignment mask (with validity), one source per lane
    const bool okl = lane < NS && s_ival[lane] > 0 && axis_ok(x, ot0, s_org[3 * lane], X) &&
                     axis_ok(y, ot1, s_org[3 * lane + 1], Y);
    const unsigned okxy = __ballot_sync(0xffffffffu, okl);

    int best_sc = Z, best_sc2 = Z;
    float best_mh = 0.0f;
    int hit_r[ZC][2], tot_r[ZC][2], pz_r[ZC][2];
    bool occ_r[ZC][2];

#pragma unroll
    for (int c = 0; c < ZC; ++c) {
        const int z0 = c * 64 + 2 * lane;
        const bool in[2] = {z0 < Z, z0 + 1 < Z};
        const int64_t v = col * Z + z0;
        int pz[2];
        unsigned am[2];     // bit s: source s is aligned and valid here
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            int r = z0 + e - ot2m;
            if (r < 0) r += Z;
            pz[e] = r;
            unsigned bits = 0;
#pragma unroll
            for (int s = 0; s < NS; ++s)
                bits |= (r >= s_zlo[s] && r < s_zhi[s]) ? (1u << s) : 0u;
            am[e] = in[e] ? (bits & okxy) : 0u;
        }

        // ---- all scalar channels of every source, issued together ----
        int h[B][2], m[B][2];
#pragma unroll
        for (int s = 0; s < B; ++s) {
            const bool r0 = (am[0] >> s) & 1u, r1 = (am[1] >> s) & 1u;
            ld2<PAIR>(bhit + s * V, v, r0, r1, h[s][0], h[s][1]);
            ld2<PAIR>(bmiss + s * V, v, r0, r1, m[s][0], m[s][1]);
        }
        // the old world: with no valid slot every channel passes through;
        // else hit and evidence are read where it is aligned
        bool ol[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) ol[e] = anyv ? ((am[e] >> B) & 1u) : in[e];
        int oh[2], om[2], oe[2];
        float omh[2];
        ld2<PAIR>(ohit, v, ol[0], ol[1], oh[0], oh[1]);
        ld2<PAIR>(oev, v, ol[0], ol[1], oe[0], oe[1]);

        // ---- phase A ----
        unsigned smask[2];
        bool occ2[2], mold[2];
        int ev[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            bool occ = false;
            int evv = 0;
            unsigned sm = 0;
#pragma unroll
            for (int s = 0; s < B; ++s) {
                const bool a = (am[e] >> s) & 1u;
                const bool s_occ = a && h[s][e] > 0;
                const int s_ev = (a && !s_occ) ? m[s][e] : 0;
                if (s_ev > 0 && !occ) evv += s_ev;
                occ = occ || s_occ;
                sm |= s_occ ? (1u << s) : 0u;
            }
            const bool oam = (am[e] >> B) & 1u;
            const bool old_occ = oam && oh[e] > 0;
            const bool revive = old_occ && !occ && evv <= k.decay;
            const bool o2 = occ || revive;
            const int old_ev = oam ? oe[e] : 0;
            if (!old_occ && old_ev > 0 && !o2) evv += old_ev;
            if (o2) evv = 0;
            smask[e] = sm;
            occ2[e] = o2;
            mold[e] = old_occ && o2;
            ev[e] = evv;
        }

        // ---- phase B: hit/miss sums, min of min_height ----
        int hs[2], ms[2];
        float mh[2];
        {
            // miss and min_height of the old world where it joins the sums
            const bool l0 = anyv ? mold[0] : in[0], l1 = anyv ? mold[1] : in[1];
            ld2<PAIR>(omiss, v, l0, l1, om[0], om[1]);
            ld2<PAIR>(ominh, v, l0, l1, omh[0], omh[1]);
            float mhs[B][2];
#pragma unroll
            for (int s = 0; s < B; ++s)
                ld2<PAIR>(bminh + s * V, v, (smask[0] >> s) & 1u, (smask[1] >> s) & 1u, mhs[s][0], mhs[s][1]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                int hh = 0, mm = 0;
                float mhh = 1.0f;
#pragma unroll
                for (int s = 0; s < B; ++s) {
                    if ((smask[e] >> s) & 1u) {
                        hh += h[s][e];
                        mm += m[s][e];
                        mhh = fminf(mhh, mhs[s][e]);
                    }
                }
                if (mold[e]) {
                    hh += oh[e];
                    mm += om[e];
                    mhh = fminf(mhh, omh[e]);
                }
                hs[e] = hh;
                ms[e] = mm;
                mh[e] = mhh;
            }
        }

        // ---- moments: slots 0..B-1 then the old world, the XLA add order ----
#pragma unroll
        for (int ch = 0; ch < 10; ++ch) {
            float mv[NS][2];
#pragma unroll
            for (int s = 0; s < B; ++s)
                ld2<PAIR>(bmom + ((int64_t)s * 10 + ch) * V, v, (am[0] >> s) & 1u, (am[1] >> s) & 1u,
                          mv[s][0], mv[s][1]);
            ld2<PAIR>(omom + (int64_t)ch * V, v, anyv ? ((am[0] >> B) & 1u) && occ2[0] : in[0],
                      anyv ? ((am[1] >> B) & 1u) && occ2[1] : in[1], mv[B][0], mv[B][1]);
            float out[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float acc = 0.0f;
#pragma unroll
                for (int s = 0; s < B; ++s)
                    acc = __fadd_rn(acc, ((am[e] >> s) & 1u) ? mv[s][e] : 0.0f);
                acc = __fadd_rn(acc, (((am[e] >> B) & 1u) && occ2[e]) ? mv[B][e] : 0.0f);
                out[e] = anyv ? acc : mv[B][e];
            }
            st2<PAIR>(mom_o + (int64_t)ch * V, v, in[0], in[1], out[0], out[1]);
        }

        // ---- world outputs (any_valid latch) ----
        st2<PAIR>(hit_o, v, in[0], in[1], anyv ? hs[0] : oh[0], anyv ? hs[1] : oh[1]);
        st2<PAIR>(miss_o, v, in[0], in[1], anyv ? ms[0] : om[0], anyv ? ms[1] : om[1]);
        st2<PAIR>(minh_o, v, in[0], in[1], anyv ? mh[0] : omh[0], anyv ? mh[1] : omh[1]);
        st2<PAIR>(ev_o, v, in[0], in[1], anyv ? ev[0] : oe[0], anyv ? ev[1] : oe[1]);

        // ---- column candidates ----
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            if (in[e]) {
                if (occ2[e] && pz[e] < best_sc) { best_sc = pz[e]; best_mh = mh[e]; }
                if (!occ2[e] && ev[e] > 0 && pz[e] < best_sc2) best_sc2 = pz[e];
            }
            hit_r[c][e] = hs[e];
            tot_r[c][e] = hs[e] + ms[e];
            pz_r[c][e] = pz[e];
            occ_r[c][e] = in[e] && occ2[e];
        }
    }

    column_tail<ZC>(best_sc, best_mh, best_sc2, occ_r, hit_r, tot_r, pz_r, Z, pmod(x - ot0, X), pmod(y - ot1, Y),
                    ot0, ot1, ot2, ego, k, lane, col, hm_o, ihm_o, pnum_o, pden_o, bok_o);
}

struct AnyArgs {
    const int* org; const int* ival; const float* ego;
    const int* bhit; const int* bmiss; const float* bminh; const float* bmom;
    const int* ohit; const int* omiss; const float* ominh; const int* oev; const float* omom;
    int B, X, Y, Z;
    CombineConsts k;
    int* hit_o; int* miss_o; float* minh_o; int* ev_o; float* mom_o;
    float* hm_o; float* ihm_o; int* pnum_o; int* pden_o; int* bok_o;
};

constexpr int ANY_GROUP = 4;        // slots whose loads issue together

// A warp's column: its torus x and y, the target window's origin, and
// whether the old world is valid with the column inside its window and, if
// so, its z window (window-relative z)
struct Column {
    int x, y, ot0, ot1, ot2;
    bool old_xy;
    int old_lo, old_hi;
};

// 32 slots from s0: those valid with the column inside their window (bits
// of a ballot), and the z window of this lane's slot
struct SlotChunk {
    unsigned live;
    int lo, hi;
};

__device__ __forceinline__ SlotChunk slot_chunk(const AnyArgs& a, const Column& c, int s0, int lane)
{
    const int s = s0 + lane;
    const bool ok = s < a.B && a.ival[s] > 0 && axis_ok(c.x, c.ot0, a.org[3 * s], a.X) &&
                    axis_ok(c.y, c.ot1, a.org[3 * s + 1], a.Y);
    const int d = ok ? c.ot2 - a.org[3 * s + 2] : 0;
    return SlotChunk{__ballot_sync(0xffffffffu, ok), -min(d, 0), a.Z - max(d, 0)};
}

// What a lane's two voxels of a chunk need besides their moments: phase A,
// the hit/miss sums and min of min_height, and the old world's scalars.
struct ChunkScalars {
    int hs[2], ms[2], ev[2], oh[2], om[2], oe[2];
    float mh[2], omh[2];
    bool occ2[2], oam[2];
};

// The next group of a chunk's live slots, ascending (sl[j] = -1 past the
// last), taken off ch.live, and their aligned-and-valid bits at each of the
// lane's voxels (bit j). The warp takes it together: ch.live is the same on
// every lane.
__device__ __forceinline__ void next_group(SlotChunk& ch, int s0, const bool (&in)[2], const int (&pz)[2],
                                           int (&sl)[ANY_GROUP], unsigned (&am)[2])
{
    am[0] = am[1] = 0u;
#pragma unroll
    for (int j = 0; j < ANY_GROUP; ++j) {
        sl[j] = -1;
        if (ch.live) {
            const int q = __ffs(ch.live) - 1;
            ch.live &= ch.live - 1;
            sl[j] = s0 + q;
            const int lo = __shfl_sync(0xffffffffu, ch.lo, q), hi = __shfl_sync(0xffffffffu, ch.hi, q);
#pragma unroll
            for (int e = 0; e < 2; ++e) am[e] |= (in[e] && pz[e] >= lo && pz[e] < hi) ? 1u << j : 0u;
        }
    }
}

// combine_kernel's phase A and B for one lane's two voxels, the slots in
// groups of ANY_GROUP whose loads issue together, then the old world
template <bool PAIR>
__device__ __forceinline__ void chunk_scalars(const AnyArgs& a, const Column& col, int lane, bool anyv,
                                              const bool (&in)[2], const int (&pz)[2], int64_t v, ChunkScalars& r)
{
    const int64_t V = (int64_t)a.X * a.Y * a.Z;
    bool occ[2] = {false, false};
    int evv[2] = {0, 0}, hh[2] = {0, 0}, mm[2] = {0, 0};
    float mhh[2] = {1.0f, 1.0f};
    for (int s0 = 0; s0 < a.B; s0 += 32) {
        for (SlotChunk sc = slot_chunk(a, col, s0, lane); sc.live;) {
            int sl[ANY_GROUP];
            unsigned am[2];
            next_group(sc, s0, in, pz, sl, am);
            int h[ANY_GROUP][2], m[ANY_GROUP][2];
#pragma unroll
            for (int j = 0; j < ANY_GROUP; ++j) {
                const bool r0 = (am[0] >> j) & 1u, r1 = (am[1] >> j) & 1u;
                ld2<PAIR>(a.bhit + sl[j] * V, v, r0, r1, h[j][0], h[j][1]);
                ld2<PAIR>(a.bmiss + sl[j] * V, v, r0, r1, m[j][0], m[j][1]);
            }
            unsigned so[2] = {0u, 0u};   // occupied slots of the group
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
                for (int j = 0; j < ANY_GROUP; ++j) {
                    const bool al = (am[e] >> j) & 1u;
                    const bool s_occ = al && h[j][e] > 0;
                    const int s_ev = (al && !s_occ) ? m[j][e] : 0;
                    if (s_ev > 0 && !occ[e]) evv[e] += s_ev;
                    occ[e] = occ[e] || s_occ;
                    if (s_occ) {
                        so[e] |= 1u << j;
                        hh[e] += h[j][e];
                        mm[e] += m[j][e];
                    }
                }
            }
            float mhs[ANY_GROUP][2];
#pragma unroll
            for (int j = 0; j < ANY_GROUP; ++j)
                ld2<PAIR>(a.bminh + sl[j] * V, v, (so[0] >> j) & 1u, (so[1] >> j) & 1u, mhs[j][0], mhs[j][1]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
                for (int j = 0; j < ANY_GROUP; ++j)
                    if ((so[e] >> j) & 1u) mhh[e] = fminf(mhh[e], mhs[j][e]);
            }
        }
    }
    // the old world: with no valid slot every channel passes through
    bool ol[2], mold[2], l[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        r.oam[e] = in[e] && col.old_xy && pz[e] >= col.old_lo && pz[e] < col.old_hi;
        ol[e] = anyv ? r.oam[e] : in[e];
    }
    ld2<PAIR>(a.ohit, v, ol[0], ol[1], r.oh[0], r.oh[1]);
    ld2<PAIR>(a.oev, v, ol[0], ol[1], r.oe[0], r.oe[1]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const bool old_occ = r.oam[e] && r.oh[e] > 0;
        const bool revive = old_occ && !occ[e] && evv[e] <= a.k.decay;
        const bool o2 = occ[e] || revive;
        const int old_ev = r.oam[e] ? r.oe[e] : 0;
        if (!old_occ && old_ev > 0 && !o2) evv[e] += old_ev;
        if (o2) evv[e] = 0;
        mold[e] = old_occ && o2;
        l[e] = anyv ? mold[e] : in[e];
        r.occ2[e] = o2;
    }
    ld2<PAIR>(a.omiss, v, l[0], l[1], r.om[0], r.om[1]);
    ld2<PAIR>(a.ominh, v, l[0], l[1], r.omh[0], r.omh[1]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        if (mold[e]) {
            hh[e] += r.oh[e];
            mm[e] += r.om[e];
            mhh[e] = fminf(mhh[e], r.omh[e]);
        }
        r.hs[e] = hh[e];
        r.ms[e] = mm[e];
        r.mh[e] = mhh[e];
        r.ev[e] = evv[e];
    }
}

// K4 for any B and Z (the header): one warp a column, lane l holding z =
// 64c + 2l and 64c + 2l + 1 of each 64-z chunk c. FITS: each voxel's band
// inputs stay in shared memory for the band sums; else they are computed
// again from the column's scalar channels.
template <bool PAIR, bool FITS>
__global__ void __launch_bounds__(ANY_WARPS * 32, 3) combine_any_kernel(AnyArgs a)
{
    extern __shared__ int sh_any[];
    const int Z = a.Z, ZR = any_zr(Z);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* band = sh_any + warp * 2 * ZR;   // band_put's encoding
    const int64_t cix = (int64_t)blockIdx.x * ANY_WARPS + warp;
    if (cix >= (int64_t)a.X * a.Y) return;
    const int* tgt = a.org + 3 * (a.B + 1);
    Column col{(int)(cix / a.Y), (int)(cix % a.Y), tgt[0], tgt[1], tgt[2], false, 0, 0};
    col.old_xy = a.ival[a.B] > 0 && axis_ok(col.x, col.ot0, a.org[3 * a.B], a.X) &&
                 axis_ok(col.y, col.ot1, a.org[3 * a.B + 1], a.Y);
    const int dold = col.ot2 - a.org[3 * a.B + 2];
    col.old_lo = -min(dold, 0);
    col.old_hi = Z - max(dold, 0);
    const int ot0 = col.ot0, ot1 = col.ot1, ot2 = col.ot2;
    const int relx = pmod(col.x - ot0, a.X), rely = pmod(col.y - ot1, a.Y), ot2m = pmod(ot2, Z);
    const bool anyv = a.ival[a.B + 1] > 0;
    const int64_t V = (int64_t)a.X * a.Y * Z;

    int best_sc = Z, best_sc2 = Z;
    float best_mh = 0.0f;
    for (int z0 = 2 * lane; z0 < ZR; z0 += 64) {
        const bool in[2] = {z0 < Z, z0 + 1 < Z};
        int pz[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) pz[e] = pmod(z0 + e - ot2m, Z);
        const int64_t v = cix * Z + z0;
        ChunkScalars r;
        chunk_scalars<PAIR>(a, col, lane, anyv, in, pz, v, r);

        // ---- moments: slots 0..B-1 then the old world, the XLA add order ----
        float acc[10][2];
#pragma unroll
        for (int ch = 0; ch < 10; ++ch) acc[ch][0] = acc[ch][1] = 0.0f;
        for (int s0 = 0; s0 < a.B; s0 += 32) {
            for (SlotChunk sc = slot_chunk(a, col, s0, lane); sc.live;) {
                int sl[ANY_GROUP];
                unsigned am[2];
                next_group(sc, s0, in, pz, sl, am);
#pragma unroll
                for (int ch = 0; ch < 10; ++ch) {
                    float mv[ANY_GROUP][2];
#pragma unroll
                    for (int j = 0; j < ANY_GROUP; ++j)
                        ld2<PAIR>(a.bmom + ((int64_t)sl[j] * 10 + ch) * V, v, (am[0] >> j) & 1u, (am[1] >> j) & 1u,
                                  mv[j][0], mv[j][1]);
#pragma unroll
                    for (int j = 0; j < ANY_GROUP; ++j) {
                        if (sl[j] >= 0) {
#pragma unroll
                            for (int e = 0; e < 2; ++e)
                                acc[ch][e] = __fadd_rn(acc[ch][e], ((am[e] >> j) & 1u) ? mv[j][e] : 0.0f);
                        }
                    }
                }
            }
        }
        const bool oo[2] = {r.oam[0] && r.occ2[0], r.oam[1] && r.occ2[1]};
#pragma unroll
        for (int ch = 0; ch < 10; ++ch) {
            float ov[2], out[2];
            ld2<PAIR>(a.omom + (int64_t)ch * V, v, anyv ? oo[0] : in[0], anyv ? oo[1] : in[1], ov[0], ov[1]);
#pragma unroll
            for (int e = 0; e < 2; ++e) out[e] = anyv ? __fadd_rn(acc[ch][e], oo[e] ? ov[e] : 0.0f) : ov[e];
            st2<PAIR>(a.mom_o + (int64_t)ch * V, v, in[0], in[1], out[0], out[1]);
        }

        // ---- world outputs (any_valid latch) ----
        st2<PAIR>(a.hit_o, v, in[0], in[1], anyv ? r.hs[0] : r.oh[0], anyv ? r.hs[1] : r.oh[1]);
        st2<PAIR>(a.miss_o, v, in[0], in[1], anyv ? r.ms[0] : r.om[0], anyv ? r.ms[1] : r.om[1]);
        st2<PAIR>(a.minh_o, v, in[0], in[1], anyv ? r.mh[0] : r.omh[0], anyv ? r.mh[1] : r.omh[1]);
        st2<PAIR>(a.ev_o, v, in[0], in[1], anyv ? r.ev[0] : r.oe[0], anyv ? r.ev[1] : r.oe[1]);

        // ---- column candidates, and what the band sums read ----
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            if (!in[e]) continue;
            if (r.occ2[e] && pz[e] < best_sc) { best_sc = pz[e]; best_mh = r.mh[e]; }
            if (!r.occ2[e] && r.ev[e] > 0 && pz[e] < best_sc2) best_sc2 = pz[e];
            if (FITS) band_put(band, ZR, z0 + e, r.occ2[e], r.hs[e], r.ms[e]);
        }
    }
    const ColumnHeights c = column_heights(best_sc, best_mh, best_sc2, Z, relx, rely, ot0, ot1, ot2, a.ego, a.k);
    // the band sums: each lane reads back its own voxels
    int num, den;
    band_sums<FITS>(c, a.k, band, Z, lane, ot2m,
                    [&](int z0, const bool (&in)[2], int (&hb)[2], int (&tot)[2]) {
                        int pz[2];
#pragma unroll
                        for (int e = 0; e < 2; ++e) pz[e] = pmod(z0 + e - ot2m, Z);
                        ChunkScalars r;
                        chunk_scalars<PAIR>(a, col, lane, anyv, in, pz, cix * Z + z0, r);
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            hb[e] = in[e] && r.occ2[e] ? r.hs[e] : INT_MIN;
                            tot[e] = r.hs[e] + r.ms[e];
                        }
                    },
                    num, den);
    column_write(c, num, den, lane, cix, a.hm_o, a.ihm_o, a.pnum_o, a.pden_o, a.bok_o);
}

// the launch of combine_any_kernel: its shared memory, the band inputs of
// its columns where they fit
int launch_any(const AnyArgs& a, bool pair, cudaStream_t stream)
{
    const size_t smem = any_band_smem(a.Z);
    const bool fits = smem > 0;
    const unsigned blocks = (unsigned)(((int64_t)a.X * a.Y + ANY_WARPS - 1) / ANY_WARPS);
    if (pair && fits) combine_any_kernel<true, true><<<blocks, ANY_WARPS * 32, smem, stream>>>(a);
    else if (pair) combine_any_kernel<true, false><<<blocks, ANY_WARPS * 32, smem, stream>>>(a);
    else if (fits) combine_any_kernel<false, true><<<blocks, ANY_WARPS * 32, smem, stream>>>(a);
    else combine_any_kernel<false, false><<<blocks, ANY_WARPS * 32, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

struct Args {
    const int* meta; const float* ego;
    const int* bhit; const int* bmiss; const float* bminh; const float* bmom;
    const int* ohit; const int* omiss; const float* ominh; const int* oev; const float* omom;
    int X, Y, Z;
    CombineConsts k;
    int* hit_o; int* miss_o; float* minh_o; int* ev_o; float* mom_o;
    float* hm_o; float* ihm_o; int* pnum_o; int* pden_o; int* bok_o;
};

template <int B, int ZC, bool PAIR>
void launch(const Args& a, cudaStream_t stream) {
    const int warps = 8;
    const int64_t blocks = ((int64_t)a.X * a.Y + warps - 1) / warps;
    combine_kernel<B, ZC, PAIR><<<(unsigned)blocks, warps * 32, 0, stream>>>(
        a.meta, a.ego, a.bhit, a.bmiss, a.bminh, a.bmom, a.ohit, a.omiss, a.ominh, a.oev, a.omom,
        a.X, a.Y, a.Z, a.k, a.hit_o, a.miss_o, a.minh_o, a.ev_o, a.mom_o,
        a.hm_o, a.ihm_o, a.pnum_o, a.pden_o, a.bok_o);
}

}  // namespace

extern "C" int gvom_combine(
    const void* meta, const void* ego,
    const void* bhit, const void* bmiss, const void* bminh, const void* bmom,
    const void* ohit, const void* omiss, const void* ominh, const void* oev, const void* omom,
    int B, int X, int Y, int Z,
    float zres, float xyres, float inv_z, float pot, float rh, float rr2, float g2l, float unknown,
    int decay, int hct,
    void* hit_o, void* miss_o, void* minh_o, void* ev_o, void* mom_o,
    void* hm_o, void* ihm_o, void* pnum_o, void* pden_o, void* bok_o, void* stream)
{
    static_assert(GVOM_COMBINE_B >= 1 && GVOM_COMBINE_B <= MAX_B, "GVOM_COMBINE_B is 1..16");
    if (B < 1 || X < 1 || Y < 1 || Z < 1) return (int)cudaErrorInvalidValue;
    const CombineConsts k{{zres, xyres, inv_z, pot, rh, rr2, g2l, unknown, hct}, decay};
    const bool aligned = aligned8(bhit) && aligned8(bmiss) && aligned8(bminh) && aligned8(bmom) &&
                         aligned8(ohit) && aligned8(omiss) && aligned8(ominh) && aligned8(oev) && aligned8(omom) &&
                         aligned8(hit_o) && aligned8(miss_o) && aligned8(minh_o) && aligned8(ev_o) && aligned8(mom_o);
    if (B > MAX_B || Z > 64 * MAX_ZC) {
        // the meta vector: origins [(B + 2) * 3], then valid flags [B + 2]
        const AnyArgs a{(const int*)meta, (const int*)meta + (B + 2) * 3, (const float*)ego,
                        (const int*)bhit, (const int*)bmiss, (const float*)bminh, (const float*)bmom,
                        (const int*)ohit, (const int*)omiss, (const float*)ominh, (const int*)oev, (const float*)omom,
                        B, X, Y, Z, k, (int*)hit_o, (int*)miss_o, (float*)minh_o, (int*)ev_o, (float*)mom_o,
                        (float*)hm_o, (float*)ihm_o, (int*)pnum_o, (int*)pden_o, (int*)bok_o};
        return launch_any(a, Z % 2 == 0 && aligned, (cudaStream_t)stream);
    }
    if (B != GVOM_COMBINE_B) return (int)cudaErrorInvalidValue;
    Args a{(const int*)meta, (const float*)ego,
           (const int*)bhit, (const int*)bmiss, (const float*)bminh, (const float*)bmom,
           (const int*)ohit, (const int*)omiss, (const float*)ominh, (const int*)oev, (const float*)omom,
           X, Y, Z, k,
           (int*)hit_o, (int*)miss_o, (float*)minh_o, (int*)ev_o, (float*)mom_o,
           (float*)hm_o, (float*)ihm_o, (int*)pnum_o, (int*)pden_o, (int*)bok_o};
    const bool pair = Z % 2 == 0 && Z <= 64 && aligned;
    if (pair) launch<GVOM_COMBINE_B, 1, true>(a, (cudaStream_t)stream);
    else launch<GVOM_COMBINE_B, MAX_ZC, false>(a, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}
