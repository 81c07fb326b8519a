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
// 256×256×64), 0.40 ms at 3.35 TB/s; chip_smoke.py counts a run's share of
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
// is a runtime argument there and the slot loop is not unrolled; one lane
// holds one z of each 32-z chunk, the chunks a runtime loop. A column no
// longer fits in registers, so it is taken in two passes: the first reads
// the scalar channels and finds the column's heights (columns.cuh), the
// second computes every output, stores it and adds the band sums (the
// column's bytes are in L2 by then). The arithmetic is the unrolled
// kernel's, in the same order, so its outputs are bitwise fuse_plain's too.

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

// Whether source s (a slot, or the old world at s = B) is valid and its
// window holds the voxel at window-relative (relx, rely, pz) of the target
// window: the overlap test of axis_ok on each axis.
__device__ __forceinline__ bool source_ok(const int* __restrict__ org, const int* __restrict__ ival, int s,
                                          int relx, int rely, int pz, int ot0, int ot1, int ot2, int X, int Y, int Z)
{
    if (ival[s] <= 0) return false;
    const int dx = ot0 - org[3 * s], dy = ot1 - org[3 * s + 1], dz = ot2 - org[3 * s + 2];
    return relx >= -min(dx, 0) && relx < X - max(dx, 0) && rely >= -min(dy, 0) && rely < Y - max(dy, 0) &&
           pz >= -min(dz, 0) && pz < Z - max(dz, 0);
}

// what the column tail reads of one voxel
struct Voxel {
    int hs, ms, ev;
    float mh;
    bool occ2;
};

struct AnyArgs {
    const int* org; const int* ival; const float* ego;
    const int* bhit; const int* bmiss; const float* bminh; const float* bmom;
    const int* ohit; const int* omiss; const float* ominh; const int* oev; const float* omom;
    int B, X, Y, Z;
    CombineConsts k;
    int* hit_o; int* miss_o; float* minh_o; int* ev_o; float* mom_o;
    float* hm_o; float* ihm_o; int* pnum_o; int* pden_o; int* bok_o;
};

// One voxel of combine_kernel's function, its slots in a runtime loop.
// FULL: also the moments, and every output stored.
template <bool FULL>
__device__ __forceinline__ Voxel combine_voxel(const AnyArgs& a, bool anyv, int relx, int rely, int pz,
                                               int ot0, int ot1, int ot2, int64_t v)
{
    const int64_t V = (int64_t)a.X * a.Y * a.Z;
    int evv = 0, hh = 0, mm = 0;
    bool occ = false;
    float mhh = 1.0f;
    float acc[10];
#pragma unroll
    for (int ch = 0; ch < 10; ++ch) acc[ch] = 0.0f;
    // ---- phase A in slot order, and the slots' share of phase B ----
    for (int s = 0; s < a.B; ++s) {
        const bool al = source_ok(a.org, a.ival, s, relx, rely, pz, ot0, ot1, ot2, a.X, a.Y, a.Z);
        const int h = al ? a.bhit[s * V + v] : 0;
        const int m = al ? a.bmiss[s * V + v] : 0;
        const bool s_occ = al && h > 0;
        const int s_ev = (al && !s_occ) ? m : 0;
        if (s_ev > 0 && !occ) evv += s_ev;
        occ = occ || s_occ;
        if (s_occ) {
            hh += h;
            mm += m;
            mhh = fminf(mhh, a.bminh[s * V + v]);
        }
        if (FULL) {
#pragma unroll
            for (int ch = 0; ch < 10; ++ch)
                acc[ch] = __fadd_rn(acc[ch], al ? a.bmom[((int64_t)s * 10 + ch) * V + v] : 0.0f);
        }
    }
    // ---- the old world: with no valid slot every channel passes through ----
    const bool oam = source_ok(a.org, a.ival, a.B, relx, rely, pz, ot0, ot1, ot2, a.X, a.Y, a.Z);
    const bool ol = anyv ? oam : true;
    const int oh = ol ? a.ohit[v] : 0, oe = ol ? a.oev[v] : 0;
    const bool old_occ = oam && oh > 0;
    const bool revive = old_occ && !occ && evv <= a.k.decay;
    const bool o2 = occ || revive;
    const int old_ev = oam ? oe : 0;
    if (!old_occ && old_ev > 0 && !o2) evv += old_ev;
    if (o2) evv = 0;
    const bool mold = old_occ && o2;
    const bool l = anyv ? mold : true;
    const int om = l ? a.omiss[v] : 0;
    const float omh = l ? a.ominh[v] : 0.0f;
    if (mold) {
        hh += oh;
        mm += om;
        mhh = fminf(mhh, omh);
    }
    if (FULL) {
        const bool oo = oam && o2;
#pragma unroll
        for (int ch = 0; ch < 10; ++ch) {
            const float ov = (anyv ? oo : true) ? a.omom[(int64_t)ch * V + v] : 0.0f;
            const float sum = __fadd_rn(acc[ch], oo ? ov : 0.0f);
            __stcs(a.mom_o + (int64_t)ch * V + v, anyv ? sum : ov);
        }
        __stcs(a.hit_o + v, anyv ? hh : oh);
        __stcs(a.miss_o + v, anyv ? mm : om);
        __stcs(a.minh_o + v, anyv ? mhh : omh);
        __stcs(a.ev_o + v, anyv ? evv : oe);
    }
    return Voxel{hh, mm, evv, mhh, o2};
}

// K4 for any B and Z: one warp a column, two passes over it (the header)
__global__ void __launch_bounds__(256) combine_any_kernel(AnyArgs a)
{
    const int lane = threadIdx.x & 31;
    const int64_t col = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (col >= (int64_t)a.X * a.Y) return;
    const int x = (int)(col / a.Y), y = (int)(col % a.Y), Z = a.Z;
    const int* tgt = a.org + 3 * (a.B + 1);
    const int ot0 = tgt[0], ot1 = tgt[1], ot2 = tgt[2];
    const int relx = pmod(x - ot0, a.X), rely = pmod(y - ot1, a.Y), ot2m = pmod(ot2, Z);
    const bool anyv = a.ival[a.B + 1] > 0;

    int best_sc = Z, best_sc2 = Z;
    float best_mh = 0.0f;
    for (int z0 = 0; z0 < Z; z0 += 32) {
        const int z = z0 + lane;
        if (z >= Z) continue;
        const int pz = z >= ot2m ? z - ot2m : z - ot2m + Z;
        const Voxel r = combine_voxel<false>(a, anyv, relx, rely, pz, ot0, ot1, ot2, col * Z + z);
        if (r.occ2 && pz < best_sc) { best_sc = pz; best_mh = r.mh; }
        if (!r.occ2 && r.ev > 0 && pz < best_sc2) best_sc2 = pz;
    }
    const ColumnHeights c = column_heights(best_sc, best_mh, best_sc2, Z, relx, rely, ot0, ot1, ot2, a.ego, a.k);
    int num = 0, den = 0;
    for (int z0 = 0; z0 < Z; z0 += 32) {
        const int z = z0 + lane;
        if (z >= Z) continue;
        const int pz = z >= ot2m ? z - ot2m : z - ot2m + Z;
        const Voxel r = combine_voxel<true>(a, anyv, relx, rely, pz, ot0, ot1, ot2, col * Z + z);
        if (in_band(c, a.k, r.occ2, r.hs, pz)) {
            num += r.hs;
            den += r.hs + r.ms;
        }
    }
    column_write(c, num, den, lane, col, a.hm_o, a.ihm_o, a.pnum_o, a.pden_o, a.bok_o);
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
    if (B > MAX_B || Z > 64 * MAX_ZC) {
        // the meta vector: origins [(B + 2) * 3], then valid flags [B + 2]
        const AnyArgs a{(const int*)meta, (const int*)meta + (B + 2) * 3, (const float*)ego,
                        (const int*)bhit, (const int*)bmiss, (const float*)bminh, (const float*)bmom,
                        (const int*)ohit, (const int*)omiss, (const float*)ominh, (const int*)oev, (const float*)omom,
                        B, X, Y, Z, k, (int*)hit_o, (int*)miss_o, (float*)minh_o, (int*)ev_o, (float*)mom_o,
                        (float*)hm_o, (float*)ihm_o, (int*)pnum_o, (int*)pden_o, (int*)bok_o};
        const int warps = 8;
        const int64_t blocks = ((int64_t)X * Y + warps - 1) / warps;
        combine_any_kernel<<<(unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(a);
        return (int)cudaGetLastError();
    }
    if (B != GVOM_COMBINE_B) return (int)cudaErrorInvalidValue;
    Args a{(const int*)meta, (const float*)ego,
           (const int*)bhit, (const int*)bmiss, (const float*)bminh, (const float*)bmom,
           (const int*)ohit, (const int*)omiss, (const float*)ominh, (const int*)oev, (const float*)omom,
           X, Y, Z, k,
           (int*)hit_o, (int*)miss_o, (float*)minh_o, (int*)ev_o, (float*)mom_o,
           (float*)hm_o, (float*)ihm_o, (int*)pnum_o, (int*)pden_o, (int*)bok_o};
    const bool pair = Z % 2 == 0 && Z <= 64 &&
                      aligned8(bhit) && aligned8(bmiss) && aligned8(bminh) && aligned8(bmom) &&
                      aligned8(ohit) && aligned8(omiss) && aligned8(ominh) && aligned8(oev) && aligned8(omom) &&
                      aligned8(hit_o) && aligned8(miss_o) && aligned8(minh_o) && aligned8(ev_o) && aligned8(mom_o);
    if (pair) launch<GVOM_COMBINE_B, 1, true>(a, (cudaStream_t)stream);
    else launch<GVOM_COMBINE_B, MAX_ZC, false>(a, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}
