// K4: the fused combine — ring-buffer slots + old world → new world and the
// per-column map products, in one pass.
//
// Replaces gvom_tpu/ops/pallas_kernels.py::fused_combine (body
// _combine_kernel_factory) and the XLA mom merge beside it
// (gvom_tpu/models/pipeline.py::_combine_fused). The TPU kernel left the
// mom merge to XLA only because of lane padding; here it is fused in.
//
// One warp per (x, y) column; lane l holds z = l, l + 32, ... so every
// channel read and write is 32 neighbouring words. Per voxel, in slot order:
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
// empty voxel), and the positive-obstacle band sums num, den and band_ok.
// Everything but mom is integer logic or the same f32 roundings as the XLA
// reference (explicit __fmaf_rn where XLA contracts a multiply-add), so it
// is bitwise equal to the plain version.
//
// Bound: bytes. Each voxel reads (B slots + world) × 3 scalar channels,
// the evidence, and 10 moment channels per source, and writes 4 + 10
// channels: ~1.35 GB at the upstream config (B=4, 256×256×64).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_ZC 8   // z chunks of 32 per lane: Z <= 256
#define MAX_B 16

namespace {

__device__ __forceinline__ int pmod(int a, int n) {
    int r = a % n;
    return r < 0 ? r + n : r;
}

// the overlap test of gvom_tpu/ops/grid.py::overlap_mask along one axis
__device__ __forceinline__ bool axis_ok(int i, int o_t, int o_s, int size) {
    const int rel_t = pmod(i - o_t, size);
    const int d = o_t - o_s;
    return rel_t >= -min(d, 0) && rel_t < size - max(d, 0);
}

struct CombineConsts {
    float zres, xyres, inv_z, pot, rh, rr2, g2l, unknown;
    int decay, hct;
};

__global__ void combine_kernel(
    const int* __restrict__ meta,      // org [(B+2)*3] (slots, old, target), ival [B+2] (slot_valid×B, old valid, any_valid)
    const float* __restrict__ ego,     // [3]
    const int* __restrict__ bhit, const int* __restrict__ bmiss,
    const float* __restrict__ bminh, const float* __restrict__ bmom,   // [B+1, ...] buffer
    const int* __restrict__ ohit, const int* __restrict__ omiss,
    const float* __restrict__ ominh, const int* __restrict__ oev, const float* __restrict__ omom,
    int B, int X, int Y, int Z, CombineConsts k,
    int* __restrict__ hit_o, int* __restrict__ miss_o, float* __restrict__ minh_o,
    int* __restrict__ ev_o, float* __restrict__ mom_o,
    float* __restrict__ hm_o, float* __restrict__ ihm_o,
    int* __restrict__ pnum_o, int* __restrict__ pden_o, int* __restrict__ bok_o)
{
    const int lane = threadIdx.x & 31;
    const int64_t col = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (col >= (int64_t)X * Y) return;
    const int x = (int)(col / Y), y = (int)(col % Y);
    const int64_t V = (int64_t)X * Y * Z;
    const int* org = meta;
    const int* ival = meta + (B + 2) * 3;
    const int ot0 = org[(B + 1) * 3], ot1 = org[(B + 1) * 3 + 1], ot2 = org[(B + 1) * 3 + 2];
    const bool anyv = ival[B + 1] > 0;

    // per-source x/y factors of the alignment mask (z is per lane)
    bool okxy[MAX_B + 1];
    for (int s = 0; s <= B; ++s)
        okxy[s] = ival[s] > 0 && axis_ok(x, ot0, org[3 * s], X) && axis_ok(y, ot1, org[3 * s + 1], Y);

    int best_sc = Z, best_sc2 = Z;
    float best_mh = 0.0f;
    int hit_r[MAX_ZC], tot_r[MAX_ZC], pz_r[MAX_ZC];
    bool occ_r[MAX_ZC];

#pragma unroll
    for (int c = 0; c < MAX_ZC; ++c) {
        const int z = c * 32 + lane;
        hit_r[c] = 0; tot_r[c] = 0; pz_r[c] = Z; occ_r[c] = false;
        if (z >= Z) continue;
        const int64_t v = col * Z + z;
        // ---- phase A ----
        bool occ = false;
        int ev = 0;
        unsigned smask = 0;
        for (int s = 0; s < B; ++s) {
            const bool am = okxy[s] && axis_ok(z, ot2, org[3 * s + 2], Z);
            const int64_t sv = (int64_t)s * V + v;
            const bool s_occ = am && bhit[sv] > 0;
            const int s_ev = (am && !s_occ) ? bmiss[sv] : 0;
            if (s_ev > 0 && !occ) ev += s_ev;
            occ = occ || s_occ;
            if (s_occ) smask |= 1u << s;
        }
        const bool oam = okxy[B] && axis_ok(z, ot2, org[3 * B + 2], Z);
        const int old_h = ohit[v];
        const bool old_occ = oam && old_h > 0;
        const bool revive = old_occ && !occ && ev <= k.decay;
        const bool occ2 = occ || revive;
        const int old_ev = oam ? oev[v] : 0;
        if (!old_occ && old_ev > 0 && !occ2) ev += old_ev;
        if (occ2) ev = 0;

        // ---- phase B ----
        int h = 0, ms = 0;
        float mh = 1.0f;
        for (int s = 0; s < B; ++s) {
            if (smask & (1u << s)) {
                const int64_t sv = (int64_t)s * V + v;
                h += bhit[sv];
                ms += bmiss[sv];
                mh = fminf(mh, bminh[sv]);
            }
        }
        const bool mold = old_occ && occ2;
        if (mold) {
            h += old_h;
            ms += omiss[v];
            mh = fminf(mh, ominh[v]);
        }
        // moments: slots 0..B-1 then the old world, the XLA add order
        const bool oz = axis_ok(z, ot2, org[3 * B + 2], Z);
        for (int ch = 0; ch < 10; ++ch) {
            float acc = 0.0f;
            for (int s = 0; s < B; ++s) {
                if (okxy[s] && axis_ok(z, ot2, org[3 * s + 2], Z))
                    acc = __fadd_rn(acc, bmom[((int64_t)s * 10 + ch) * V + v]);
                else
                    acc = __fadd_rn(acc, 0.0f);
            }
            const float om = omom[(int64_t)ch * V + v];
            acc = __fadd_rn(acc, (okxy[B] && oz && occ2) ? om : 0.0f);
            mom_o[(int64_t)ch * V + v] = anyv ? acc : om;
        }

        // ---- world outputs (any_valid latch) ----
        hit_o[v] = anyv ? h : old_h;
        miss_o[v] = anyv ? ms : omiss[v];
        minh_o[v] = anyv ? mh : ominh[v];
        ev_o[v] = anyv ? ev : oev[v];

        // ---- column candidates ----
        const int pz = pmod(z - ot2, Z);
        if (occ2 && pz < best_sc) { best_sc = pz; best_mh = mh; }
        if (!occ2 && ev > 0 && pz < best_sc2) best_sc2 = pz;
        hit_r[c] = h; tot_r[c] = h + ms; pz_r[c] = pz; occ_r[c] = occ2;
    }

    // ---- column reductions (window-relative z values are unique per column) ----
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int sc = __shfl_xor_sync(0xffffffffu, best_sc, off);
        const float m = __shfl_xor_sync(0xffffffffu, best_mh, off);
        if (sc < best_sc) { best_sc = sc; best_mh = m; }
        best_sc2 = min(best_sc2, __shfl_xor_sync(0xffffffffu, best_sc2, off));
    }
    const float o2f = (float)ot2;
    float hm;
    if (best_sc < Z) {
        hm = __fmul_rn(__fadd_rn(__fadd_rn(best_mh, (float)best_sc), o2f), k.zres);
    } else {
        const float relx = (float)pmod(x - ot0, X);
        const float rely = (float)pmod(y - ot1, Y);
        const float gx = __fmaf_rn(__fadd_rn((float)ot0, relx), k.xyres, -ego[0]);
        const float gy = __fmaf_rn(__fadd_rn((float)ot1, rely), k.xyres, -ego[1]);
        const bool disk = __fmaf_rn(gx, gx, __fmul_rn(gy, gy)) <= k.rr2;
        hm = disk ? __fsub_rn(ego[2], k.g2l) : k.unknown;
    }
    const float ihm = best_sc2 < Z ? __fmul_rn(__fadd_rn((float)best_sc2, o2f), k.zres) : k.unknown;

    const int lo = (int)floorf(__fmaf_rn(__fadd_rn(hm, k.pot), k.inv_z, -o2f)) + 1;
    const int hi = (int)floorf(__fmaf_rn(__fadd_rn(hm, k.rh), k.inv_z, -o2f));
    const bool band_ok = lo >= 0 && lo < Z && hi >= 0 && hi < Z;
    int num = 0, den = 0;
#pragma unroll
    for (int c = 0; c < MAX_ZC; ++c) {
        if (occ_r[c] && hit_r[c] > k.hct && pz_r[c] >= lo && pz_r[c] <= hi) {
            num += hit_r[c];
            den += tot_r[c];
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        num += __shfl_xor_sync(0xffffffffu, num, off);
        den += __shfl_xor_sync(0xffffffffu, den, off);
    }
    if (lane == 0) {
        hm_o[col] = hm;
        ihm_o[col] = ihm;
        pnum_o[col] = num;
        pden_o[col] = den;
        bok_o[col] = band_ok ? 1 : 0;
    }
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
    if (Z > 32 * MAX_ZC || B > MAX_B) return (int)cudaErrorInvalidValue;
    CombineConsts k{zres, xyres, inv_z, pot, rh, rr2, g2l, unknown, decay, hct};
    const int warps = 8;
    const int64_t cols = (int64_t)X * Y;
    const int64_t blocks = (cols + warps - 1) / warps;
    combine_kernel<<<(unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(
        (const int*)meta, (const float*)ego,
        (const int*)bhit, (const int*)bmiss, (const float*)bminh, (const float*)bmom,
        (const int*)ohit, (const int*)omiss, (const float*)ominh, (const int*)oev, (const float*)omom,
        B, X, Y, Z, k,
        (int*)hit_o, (int*)miss_o, (float*)minh_o, (int*)ev_o, (float*)mom_o,
        (float*)hm_o, (float*)ihm_o, (int*)pnum_o, (int*)pden_o, (int*)bok_o);
    return (int)cudaGetLastError();
}
