// M: the batched step's merge of a batch's contribution with the old world,
// and the column maps of the merged world, in one pass.
//
// No TPU kernel: the port's own. It replaces what the JAX package hands to
// XLA inside the step (gvom_tpu/parallel/sharding.py:264-328: the merge,
// then height_map, inferred_height_map and positive_obstacle_map's band
// sums on the slab), which the port ran as about 300 eager PyTorch launches
// with float64 fma32 emulation (parallel/sharding.py::merge_batch_plain and
// ops/maps2d.py). The plain twin is sharding.merge_and_columns_plain.
//
// Per voxel, the batched step's formula (sharding.merge_batch_plain):
//   omask   the two windows' overlap (global torus row y0 + ys on a slab);
//   old_occ old hit > 0 inside the overlap of a valid world;
//   revive  old_occ, the batch does not occupy it, and the batch's misses
//           are at most decay_miss_limit (the staleness veto, gvom.py:992);
//   occ2    the batch occupies it, or it is revived;
//   evidence the batch's misses, plus the old evidence where the old world
//           was not occupied, had evidence and the voxel stays empty; 0
//           where occ2 (occupied-wins);
//   hit, miss summed and min_height the minimum where old_occ and occ2;
//   mom     where(occ, batch, 0) + where(omask & occ2, old, 0), one
//           __fadd_rn in the twin's order (no atomic), so bitwise the twin.
// Per column (one warp a column, as K4): the height, the inferred height and
// the band sums num, den and band_ok (columns.cuh, shared with K4).
//
// Bound on the H100: bytes. Each voxel writes 16 B of scalar channels and
// 40 B of moments, reads 12 B of the batch's scalars and 8 B of the old
// world's hit and evidence, and reads moments only where the function needs
// them (the batch's where it occupies, the old world's where it overlaps and
// stays occupied); about 0.32 GB at the upstream config, 0.095 ms at
// 3.35 TB/s (benchmark/roofline.py merge_bound counts a run's share). The design is
// K4's: one warp a column, each lane two adjacent z with 8-byte accesses
// where Z <= 64 (ZC = 1; a 4-chunk, 4-byte path for other Z up to 256),
// streaming hints, every load of a voxel issued before its first use, and
// each channel loaded only where it is needed.
//
// Past 256 z the column no longer fits in a lane's registers, and
// merge_any_kernel takes the merge, in the same arithmetic and order. Its
// first form read the scalar channels twice, in a pass for the
// column's heights and a pass that merged, and used each 4-byte load before
// it issued the next: 35 % of its bound at 256×256×320. Its design now is
// K4's grouped form (combine.cu): lane l holds z = 64c + 2l and 64c + 2l + 1
// of each 64-z chunk c, a runtime loop over the chunks, with 8-byte
// accesses where Z is even and the pointers aligned (4-byte ones otherwise,
// as at Z = 257); a chunk's five scalar loads are issued while the chunk
// before it merges, its old miss, old min_height and twenty moment loads
// together before any of its stores; one pass stores every voxel output and
// keeps each lane's lowest occupied and lowest evidence z for the warp's
// column_heights; the band inputs wait in shared memory for the band sums
// (columns.cuh's band_put and band_sums, shared with K4), and past what a
// block's 48 KB holds (Z > 768) the band-sum loop reads back the merged hit
// and miss that the lane has just stored. Two blocks an SM, 128 registers:
// at three the loads in flight spilled and the merge took 6 % longer.
// What is left is the moments' sectors: a voxel's moments are read where it
// needs them, but the card reads whole sectors, and on a world whose
// occupied voxels are scattered most sectors hold one that is needed
// (scripts/time_wide_forms.py times the merge without its moment loads and
// with every moment loaded). Tried on the card and dropped: the next
// chunk's moment sectors prefetched into L2, the moments staged in shared
// memory with cp.async a chunk ahead (no faster: the loads wait on
// bandwidth, not latency), and stores skipped where a merged scalar equals
// the batch's (slower: partial sectors written).
//
// In place: the merged hit, miss, min_height and moments are written over
// the contribution's own buffers (each voxel is read and written by one
// thread); the old world is only read. The origins, the old world's valid
// flag and the ego are read from device memory: no host sync.

#include "columns.cuh"

namespace {

struct MergeConsts : ColumnConsts {
    int decay;
};

template <int ZC, bool PAIR>
__global__ void __launch_bounds__(256, 4) merge_kernel(
    const int* __restrict__ origin, const int* __restrict__ oorigin, const unsigned char* __restrict__ ovalid,
    const float* __restrict__ ego,
    int* hit, int* miss, float* minh, float* mom,   // the batch's [X, Ys, Z] / [10, X, Ys, Z], merged in place
    const int* __restrict__ ohit, const int* __restrict__ omiss, const float* __restrict__ ominh,
    const int* __restrict__ oev, const float* __restrict__ omom,
    int X, int Ys, int Y, int Z, int y0, MergeConsts k,
    int* __restrict__ ev_o, float* __restrict__ hm_o, float* __restrict__ ihm_o,
    int* __restrict__ pnum_o, int* __restrict__ pden_o, int* __restrict__ bok_o)
{
    const int lane = threadIdx.x & 31;
    const int64_t col = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (col >= (int64_t)X * Ys) return;
    const int x = (int)(col / Ys), yg = y0 + (int)(col % Ys);
    const int64_t V = (int64_t)X * Ys * Z;
    const int ot0 = origin[0], ot1 = origin[1], ot2 = origin[2];
    const bool valid = ovalid[0] != 0;
    const bool okxy = axis_ok(x, ot0, oorigin[0], X) && axis_ok(yg, ot1, oorigin[1], Y);
    const int d = ot2 - oorigin[2];
    const int zlo = -min(d, 0), zhi = Z - max(d, 0);
    const int ot2m = pmod(ot2, Z);

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
        bool om[2], ow[2];      // in the overlap; and the old world valid
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            int r = z0 + e - ot2m;
            if (r < 0) r += Z;
            pz[e] = r;
            om[e] = in[e] && okxy && r >= zlo && r < zhi;
            ow[e] = om[e] && valid;
        }

        // ---- the batch's scalars, the old world's hit and evidence ----
        int h[2], m[2], oh[2], oe[2];
        float mh[2];
        ld2<PAIR>(hit, v, in[0], in[1], h[0], h[1]);
        ld2<PAIR>(miss, v, in[0], in[1], m[0], m[1]);
        ld2<PAIR>(minh, v, in[0], in[1], mh[0], mh[1]);
        ld2<PAIR>(ohit, v, ow[0], ow[1], oh[0], oh[1]);
        ld2<PAIR>(oev, v, ow[0], ow[1], oe[0], oe[1]);

        bool occ[2], occ2[2], msel[2];
        int ev[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            occ[e] = h[e] > 0;
            const bool old_occ = ow[e] && oh[e] > 0;
            const bool revive = old_occ && !occ[e] && m[e] <= k.decay;
            occ2[e] = occ[e] || revive;
            const int old_ev = ow[e] ? oe[e] : 0;
            int evv = (!old_occ && old_ev > 0 && !occ2[e]) ? m[e] + old_ev : m[e];
            ev[e] = occ2[e] ? 0 : evv;
            msel[e] = old_occ && occ2[e];
        }

        // ---- hit and miss summed, min of min_height, where msel ----
        int om_[2];
        float omh[2];
        ld2<PAIR>(omiss, v, msel[0], msel[1], om_[0], om_[1]);
        ld2<PAIR>(ominh, v, msel[0], msel[1], omh[0], omh[1]);
        int hs[2], ms[2];
        float mhs[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            hs[e] = h[e] + (msel[e] ? oh[e] : 0);
            ms[e] = m[e] + (msel[e] ? om_[e] : 0);
            mhs[e] = msel[e] ? fminf(mh[e], omh[e]) : mh[e];
        }

        // ---- moments: the batch's where it occupies, plus the old world's
        // where it overlaps and the voxel stays occupied ----
        const bool oo[2] = {om[0] && occ2[0], om[1] && occ2[1]};
#pragma unroll
        for (int ch = 0; ch < 10; ++ch) {
            float cm[2], omv[2];
            ld2<PAIR>(mom + (int64_t)ch * V, v, occ[0] && in[0], occ[1] && in[1], cm[0], cm[1]);
            ld2<PAIR>(omom + (int64_t)ch * V, v, oo[0], oo[1], omv[0], omv[1]);
            float out[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
                out[e] = __fadd_rn(occ[e] ? cm[e] : 0.0f, oo[e] ? omv[e] : 0.0f);
            st2<PAIR>(mom + (int64_t)ch * V, v, in[0], in[1], out[0], out[1]);
        }

        st2<PAIR>(hit, v, in[0], in[1], hs[0], hs[1]);
        st2<PAIR>(miss, v, in[0], in[1], ms[0], ms[1]);
        st2<PAIR>(minh, v, in[0], in[1], mhs[0], mhs[1]);
        st2<PAIR>(ev_o, v, in[0], in[1], ev[0], ev[1]);

        // ---- column candidates ----
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            if (in[e]) {
                if (occ2[e] && pz[e] < best_sc) { best_sc = pz[e]; best_mh = mhs[e]; }
                if (!occ2[e] && ev[e] > 0 && pz[e] < best_sc2) best_sc2 = pz[e];
            }
            hit_r[c][e] = hs[e];
            tot_r[c][e] = hs[e] + ms[e];
            pz_r[c][e] = pz[e];
            occ_r[c][e] = in[e] && occ2[e];
        }
    }

    column_tail<ZC>(best_sc, best_mh, best_sc2, occ_r, hit_r, tot_r, pz_r, Z, pmod(x - ot0, X), pmod(yg - ot1, Y),
                    ot0, ot1, ot2, ego, k, lane, col, hm_o, ihm_o, pnum_o, pden_o, bok_o);
}

struct Args {
    const int* origin; const int* oorigin; const unsigned char* ovalid; const float* ego;
    int* hit; int* miss; float* minh; float* mom;
    const int* ohit; const int* omiss; const float* ominh; const int* oev; const float* omom;
    int X, Ys, Y, Z, y0;
    MergeConsts k;
    int* ev_o; float* hm_o; float* ihm_o; int* pnum_o; int* pden_o; int* bok_o;
};

constexpr int ANY_BLOCKS = 2;   // merge_any_kernel's blocks an SM: at most 128 registers a thread

// Where a lane's two voxels of one chunk of its column lie, and the scalar
// channels of both that merge_any_kernel loads before it knows anything else
struct AnyChunk {
    bool in[2], om[2], ow[2];   // inside the column; in the windows' overlap; and the old world valid
    int pz[2];                  // window-relative z
    int h[2], m[2], oh[2], oe[2];
    float mh[2];
};

// the positions of the lane's voxels z0 and z0 + 1 of column col, and their
// scalar loads issued (nothing loaded past the column's end)
template <bool PAIR>
__device__ __forceinline__ void any_chunk(const Args& a, int64_t col, int z0, int ot2m, bool okxy, bool valid,
                                          int zlo, int zhi, AnyChunk& q)
{
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        q.in[e] = z0 + e < a.Z;
        const int r = z0 + e - ot2m;
        q.pz[e] = r < 0 ? r + a.Z : r;
        q.om[e] = q.in[e] && okxy && q.pz[e] >= zlo && q.pz[e] < zhi;
        q.ow[e] = q.om[e] && valid;
    }
    const int64_t v = col * a.Z + z0;
    ld2<PAIR>(a.hit, v, q.in[0], q.in[1], q.h[0], q.h[1]);
    ld2<PAIR>(a.miss, v, q.in[0], q.in[1], q.m[0], q.m[1]);
    ld2<PAIR>(a.minh, v, q.in[0], q.in[1], q.mh[0], q.mh[1]);
    ld2<PAIR>(a.ohit, v, q.ow[0], q.ow[1], q.oh[0], q.oh[1]);
    ld2<PAIR>(a.oev, v, q.ow[0], q.ow[1], q.oe[0], q.oe[1]);
}

// The merge for any Z, in one pass (the header): a warp a column, lane l
// holding z = 64c + 2l and 64c + 2l + 1 of each 64-z chunk c. A chunk's
// scalar loads are issued a chunk ahead, its old miss, old min_height and
// twenty moment loads together, before any of its stores. FITS: the band
// inputs wait in shared memory for the band sums (columns.cuh); else the
// band-sum loop reads back the merged hit and miss that this lane stored:
// a hit count is never negative, so the merge gives a positive hit to the
// voxels of occ2 and to no other.
template <bool PAIR, bool FITS>
__global__ void __launch_bounds__(ANY_WARPS * 32, ANY_BLOCKS) merge_any_kernel(Args a)
{
    extern __shared__ int sh_any[];
    const int Z = a.Z, ZR = any_zr(Z);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* band = sh_any + warp * 2 * ZR;
    const int64_t col = (int64_t)blockIdx.x * ANY_WARPS + warp;
    if (col >= (int64_t)a.X * a.Ys) return;
    const int x = (int)(col / a.Ys), yg = a.y0 + (int)(col % a.Ys);
    const int64_t V = (int64_t)a.X * a.Ys * Z;
    const int ot0 = a.origin[0], ot1 = a.origin[1], ot2 = a.origin[2];
    const bool valid = a.ovalid[0] != 0;
    const bool okxy = axis_ok(x, ot0, a.oorigin[0], a.X) && axis_ok(yg, ot1, a.oorigin[1], a.Y);
    const int d = ot2 - a.oorigin[2];
    const int zlo = -min(d, 0), zhi = Z - max(d, 0);
    const int ot2m = pmod(ot2, Z);

    int best_sc = Z, best_sc2 = Z;
    float best_mh = 0.0f;
    AnyChunk q;
    any_chunk<PAIR>(a, col, 2 * lane, ot2m, okxy, valid, zlo, zhi, q);
    for (int z0 = 2 * lane; z0 < ZR; z0 += 64) {
        const int64_t v = col * Z + z0;
        bool occ[2], occ2[2], msel[2], oo[2];
        int ev[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            occ[e] = q.h[e] > 0;
            const bool old_occ = q.ow[e] && q.oh[e] > 0;
            const bool revive = old_occ && !occ[e] && q.m[e] <= a.k.decay;
            occ2[e] = occ[e] || revive;
            const int old_ev = q.ow[e] ? q.oe[e] : 0;
            const int evv = (!old_occ && old_ev > 0 && !occ2[e]) ? q.m[e] + old_ev : q.m[e];
            ev[e] = occ2[e] ? 0 : evv;
            msel[e] = old_occ && occ2[e];
            oo[e] = q.om[e] && occ2[e];
        }

        // ---- the old miss and min_height where msel, and the moments: the
        // batch's where it occupies, the old world's where it overlaps and
        // the voxel stays occupied ----
        int omi[2];
        float omh[2], cm[10][2], ov[10][2];
        ld2<PAIR>(a.omiss, v, msel[0], msel[1], omi[0], omi[1]);
        ld2<PAIR>(a.ominh, v, msel[0], msel[1], omh[0], omh[1]);
#pragma unroll
        for (int ch = 0; ch < 10; ++ch) {
            ld2<PAIR>(a.mom + ch * V, v, occ[0] && q.in[0], occ[1] && q.in[1], cm[ch][0], cm[ch][1]);
            ld2<PAIR>(a.omom + ch * V, v, oo[0], oo[1], ov[ch][0], ov[ch][1]);
        }
        const AnyChunk p = q;
        any_chunk<PAIR>(a, col, z0 + 64, ot2m, okxy, valid, zlo, zhi, q);

        int hs[2], ms[2];
        float mhs[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            hs[e] = p.h[e] + (msel[e] ? p.oh[e] : 0);
            ms[e] = p.m[e] + (msel[e] ? omi[e] : 0);
            mhs[e] = msel[e] ? fminf(p.mh[e], omh[e]) : p.mh[e];
        }
#pragma unroll
        for (int ch = 0; ch < 10; ++ch) {
            float out[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) out[e] = __fadd_rn(occ[e] ? cm[ch][e] : 0.0f, oo[e] ? ov[ch][e] : 0.0f);
            st2<PAIR>(a.mom + ch * V, v, p.in[0], p.in[1], out[0], out[1]);
        }
        st2<PAIR>(a.hit, v, p.in[0], p.in[1], hs[0], hs[1]);
        st2<PAIR>(a.miss, v, p.in[0], p.in[1], ms[0], ms[1]);
        st2<PAIR>(a.minh, v, p.in[0], p.in[1], mhs[0], mhs[1]);
        st2<PAIR>(a.ev_o, v, p.in[0], p.in[1], ev[0], ev[1]);

        // ---- column candidates, and what the band sums read ----
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            if (!p.in[e]) continue;
            if (occ2[e] && p.pz[e] < best_sc) { best_sc = p.pz[e]; best_mh = mhs[e]; }
            if (!occ2[e] && ev[e] > 0 && p.pz[e] < best_sc2) best_sc2 = p.pz[e];
            if (FITS) band_put(band, ZR, z0 + e, occ2[e], hs[e], ms[e]);
        }
    }
    const ColumnHeights c = column_heights(best_sc, best_mh, best_sc2, Z, pmod(x - ot0, a.X), pmod(yg - ot1, a.Y),
                                           ot0, ot1, ot2, a.ego, a.k);
    int num, den;
    band_sums<FITS>(c, a.k, band, Z, lane, ot2m,
                    [&](int z0, const bool (&in)[2], int (&hb)[2], int (&tot)[2]) {
                        int h[2], m[2];
                        ld2<PAIR>(a.hit, col * Z + z0, in[0], in[1], h[0], h[1]);
                        ld2<PAIR>(a.miss, col * Z + z0, in[0], in[1], m[0], m[1]);
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            hb[e] = h[e] > 0 ? h[e] : INT_MIN;
                            tot[e] = h[e] + m[e];
                        }
                    },
                    num, den);
    column_write(c, num, den, lane, col, a.hm_o, a.ihm_o, a.pnum_o, a.pden_o, a.bok_o);
}

template <int ZC, bool PAIR>
void launch(const Args& a, cudaStream_t stream) {
    const int warps = 8;
    const int64_t blocks = ((int64_t)a.X * a.Ys + warps - 1) / warps;
    merge_kernel<ZC, PAIR><<<(unsigned)blocks, warps * 32, 0, stream>>>(
        a.origin, a.oorigin, a.ovalid, a.ego, a.hit, a.miss, a.minh, a.mom,
        a.ohit, a.omiss, a.ominh, a.oev, a.omom, a.X, a.Ys, a.Y, a.Z, a.y0, a.k,
        a.ev_o, a.hm_o, a.ihm_o, a.pnum_o, a.pden_o, a.bok_o);
}

}  // namespace

// cols is [2, X, Ys] f32 (height, inferred height), bands [3, X, Ys] int32
// (num, den, band_ok), all in the slab's torus layout.
extern "C" int gvom_merge_batch(
    const void* origin, const void* oorigin, const void* ovalid, const void* ego,
    void* hit, void* miss, void* minh, void* mom,
    const void* ohit, const void* omiss, const void* ominh, const void* oev, const void* omom,
    int X, int Ys, int Y, int Z, int y0,
    float zres, float xyres, float inv_z, float pot, float rh, float rr2, float g2l, float unknown,
    int decay, int hct, void* ev_o, void* cols, void* bands, void* stream)
{
    if (Z < 1 || y0 < 0 || y0 + Ys > Y) return (int)cudaErrorInvalidValue;
    const int64_t n2 = (int64_t)X * Ys;
    const MergeConsts k{{zres, xyres, inv_z, pot, rh, rr2, g2l, unknown, hct}, decay};
    Args a{(const int*)origin, (const int*)oorigin, (const unsigned char*)ovalid, (const float*)ego,
           (int*)hit, (int*)miss, (float*)minh, (float*)mom,
           (const int*)ohit, (const int*)omiss, (const float*)ominh, (const int*)oev, (const float*)omom,
           X, Ys, Y, Z, y0, k,
           (int*)ev_o, (float*)cols, (float*)cols + n2, (int*)bands, (int*)bands + n2, (int*)bands + 2 * n2};
    const bool aligned = aligned8(hit) && aligned8(miss) && aligned8(minh) && aligned8(mom) && aligned8(ohit) &&
                         aligned8(omiss) && aligned8(ominh) && aligned8(oev) && aligned8(omom) && aligned8(ev_o);
    if (Z > 256) {
        const size_t smem = any_band_smem(Z);
        const unsigned blocks = (unsigned)((n2 + ANY_WARPS - 1) / ANY_WARPS);
        const cudaStream_t st = (cudaStream_t)stream;
        if (Z % 2 == 0 && aligned) {
            if (smem) merge_any_kernel<true, true><<<blocks, ANY_WARPS * 32, smem, st>>>(a);
            else merge_any_kernel<true, false><<<blocks, ANY_WARPS * 32, 0, st>>>(a);
        } else {
            if (smem) merge_any_kernel<false, true><<<blocks, ANY_WARPS * 32, smem, st>>>(a);
            else merge_any_kernel<false, false><<<blocks, ANY_WARPS * 32, 0, st>>>(a);
        }
    } else if (Z % 2 == 0 && Z <= 64 && aligned) {
        launch<1, true>(a, (cudaStream_t)stream);
    } else {
        launch<4, false>(a, (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}
