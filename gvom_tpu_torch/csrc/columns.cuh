// What K4 (combine.cu) and the batched merge (merge.cu) share: the overlap
// test, the paired loads and stores of one lane's two adjacent z, the
// column tail, which turns a warp's per-lane candidates into the five
// column maps of one (x, y) column, and, for their forms past 256 z, the
// band sums over a column whose band inputs wait in shared memory.
//
// The column tail is the arithmetic of ops/maps2d.py's height_map,
// inferred_height_map and positive_band_sums (gvom_tpu/ops/maps2d.py:76-116,
// :285-317), rounded as XLA rounds it: __fmaf_rn where the plain twin calls
// grid.fma32, one __f*_rn for every other operation (the sources are built
// with -fmad=false).

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T> struct Vec2;
template <> struct Vec2<int> { using type = int2; };
template <> struct Vec2<float> { using type = float2; };

// one lane's two adjacent z of a channel: element 0 at p[i], 1 at p[i + 1]
template <bool PAIR, typename T>
__device__ __forceinline__ void ld2(const T* __restrict__ p, int64_t i, bool ok0, bool ok1, T& a, T& b) {
    if (PAIR) {
        if (ok0 || ok1) {
            const typename Vec2<T>::type q = __ldcs(reinterpret_cast<const typename Vec2<T>::type*>(p + i));
            a = q.x;
            b = q.y;
        } else {
            a = T(0);
            b = T(0);
        }
    } else {
        a = ok0 ? __ldcs(p + i) : T(0);
        b = ok1 ? __ldcs(p + i + 1) : T(0);
    }
}

template <bool PAIR, typename T>
__device__ __forceinline__ void st2(T* __restrict__ p, int64_t i, bool ok0, bool ok1, T a, T b) {
    if (PAIR) {
        if (ok0) {
            typename Vec2<T>::type q;
            q.x = a;
            q.y = b;
            __stcs(reinterpret_cast<typename Vec2<T>::type*>(p + i), q);
        }
    } else {
        if (ok0) __stcs(p + i, a);
        if (ok1) __stcs(p + i + 1, b);
    }
}

struct ColumnConsts {
    float zres, xyres, inv_z, pot, rh, rr2, g2l, unknown;
    int hct;
};

// A column's heights from its warp's candidates: best_sc is the lane's
// lowest window-relative z of an occupied voxel and best_mh that voxel's
// min_height, best_sc2 the lowest of an unoccupied voxel with evidence (Z
// where none). relx and rely are the column's window-relative x and y,
// (ot0, ot1, ot2) the window's origin. Every lane gets the height, the
// inferred height and the band [lo, hi] of window-relative z whose voxels
// the band sums take.
struct ColumnHeights {
    float hm, ihm;
    int lo, hi;
    bool band_ok;
};

__device__ __forceinline__ ColumnHeights column_heights(
    int best_sc, float best_mh, int best_sc2, int Z, int relx, int rely, int ot0, int ot1, int ot2,
    const float* __restrict__ ego, const ColumnConsts& k)
{
    // window-relative z values are unique per column
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int sc = __shfl_xor_sync(0xffffffffu, best_sc, off);
        const float mm = __shfl_xor_sync(0xffffffffu, best_mh, off);
        if (sc < best_sc) { best_sc = sc; best_mh = mm; }
        best_sc2 = min(best_sc2, __shfl_xor_sync(0xffffffffu, best_sc2, off));
    }
    const float o2f = (float)ot2;
    ColumnHeights c;
    if (best_sc < Z) {
        c.hm = __fmul_rn(__fadd_rn(__fadd_rn(best_mh, (float)best_sc), o2f), k.zres);
    } else {
        const float gx = __fmaf_rn(__fadd_rn((float)ot0, (float)relx), k.xyres, -ego[0]);
        const float gy = __fmaf_rn(__fadd_rn((float)ot1, (float)rely), k.xyres, -ego[1]);
        const bool disk = __fmaf_rn(gx, gx, __fmul_rn(gy, gy)) <= k.rr2;
        c.hm = disk ? __fsub_rn(ego[2], k.g2l) : k.unknown;
    }
    c.ihm = best_sc2 < Z ? __fmul_rn(__fadd_rn((float)best_sc2, o2f), k.zres) : k.unknown;
    c.lo = (int)floorf(__fmaf_rn(__fadd_rn(c.hm, k.pot), k.inv_z, -o2f)) + 1;
    c.hi = (int)floorf(__fmaf_rn(__fadd_rn(c.hm, k.rh), k.inv_z, -o2f));
    c.band_ok = c.lo >= 0 && c.lo < Z && c.hi >= 0 && c.hi < Z;
    return c;
}

// whether a voxel joins the band sums: occupied, more hits than the
// threshold, its window-relative z inside the band
__device__ __forceinline__ bool in_band(const ColumnHeights& c, const ColumnConsts& k, bool occ, int hit, int pz) {
    return occ && hit > k.hct && pz >= c.lo && pz <= c.hi;
}

// The warp's band sums added up, and lane 0 writes the column's five maps
// at index `col`.
__device__ __forceinline__ void column_write(
    const ColumnHeights& c, int num, int den, int lane, int64_t col,
    float* __restrict__ hm_o, float* __restrict__ ihm_o, int* __restrict__ pnum_o, int* __restrict__ pden_o,
    int* __restrict__ bok_o)
{
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        num += __shfl_xor_sync(0xffffffffu, num, off);
        den += __shfl_xor_sync(0xffffffffu, den, off);
    }
    if (lane == 0) {
        hm_o[col] = c.hm;
        ihm_o[col] = c.ihm;
        pnum_o[col] = num;
        pden_o[col] = den;
        bok_o[col] = c.band_ok ? 1 : 0;
    }
}

// The five column maps of one column whose voxels the warp's lanes hold in
// registers: occ_r, hit_r, tot_r and pz_r are each of the lane's voxels'
// occupancy, hit, hit + miss and window-relative z (the rest as
// column_heights). A column longer than the registers hold is taken in two
// passes by the *_any kernels instead: the heights, then the band sums.
template <int ZC>
__device__ __forceinline__ void column_tail(
    int best_sc, float best_mh, int best_sc2, const bool (&occ_r)[ZC][2], const int (&hit_r)[ZC][2],
    const int (&tot_r)[ZC][2], const int (&pz_r)[ZC][2], int Z, int relx, int rely, int ot0, int ot1, int ot2,
    const float* __restrict__ ego, const ColumnConsts& k, int lane, int64_t col,
    float* __restrict__ hm_o, float* __restrict__ ihm_o, int* __restrict__ pnum_o, int* __restrict__ pden_o,
    int* __restrict__ bok_o)
{
    const ColumnHeights c = column_heights(best_sc, best_mh, best_sc2, Z, relx, rely, ot0, ot1, ot2, ego, k);
    int num = 0, den = 0;
#pragma unroll
    for (int z = 0; z < ZC; ++z) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            if (in_band(c, k, occ_r[z][e], hit_r[z][e], pz_r[z][e])) {
                num += hit_r[z][e];
                den += tot_r[z][e];
            }
        }
    }
    column_write(c, num, den, lane, col, hm_o, ihm_o, pnum_o, pden_o, bok_o);
}

// The forms past 256 z (combine_any_kernel, merge_any_kernel) take a column
// a warp, lane l holding z = 64c + 2l and 64c + 2l + 1 of each 64-z chunk c,
// ANY_WARPS columns a block. What the band sums read of a voxel waits in
// shared memory between the column's merge loop and its band-sum loop: a
// warp's 2·ZR ints (ZR = Z rounded up to 64), band_put's encoding. Past
// what ANY_SMEM holds for a block's columns (Z > 768) the band-sum loop
// computes the inputs again instead (band_sums' `again`).
constexpr int ANY_WARPS = 8;
constexpr int ANY_SMEM = 48 * 1024;   // without opting in

__host__ __device__ __forceinline__ int any_zr(int Z) { return (Z + 63) / 64 * 64; }

// the shared memory of a block whose band inputs fit, else 0
inline size_t any_band_smem(int Z) {
    const size_t full = sizeof(int) * (size_t)ANY_WARPS * 2 * any_zr(Z);
    return full <= (size_t)ANY_SMEM ? full : 0;
}

// a voxel's band inputs at band[z] and band[ZR + z]: its hit where it is
// occupied (INT_MIN, below any threshold, where not) and hit + miss
__device__ __forceinline__ void band_put(int* band, int ZR, int z, bool occ2, int hs, int ms) {
    band[z] = occ2 ? hs : INT_MIN;
    band[ZR + z] = hs + ms;
}

// The column's band sums over this lane's voxels: their inputs read back
// from band (FITS), or again(z0, in, hb, tot) gives them in band_put's
// encoding for the lane's two voxels from z0.
template <bool FITS, typename Again>
__device__ __forceinline__ void band_sums(const ColumnHeights& c, const ColumnConsts& k, const int* band, int Z,
                                          int lane, int ot2m, Again again, int& num, int& den)
{
    const int ZR = any_zr(Z);
    num = den = 0;
    for (int z0 = 2 * lane; z0 < ZR; z0 += 64) {
        const bool in[2] = {z0 < Z, z0 + 1 < Z};
        int hb[2], tot[2];
        if (FITS) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                hb[e] = in[e] ? band[z0 + e] : INT_MIN;
                tot[e] = in[e] ? band[ZR + z0 + e] : 0;
            }
        } else {
            again(z0, in, hb, tot);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            if (in_band(c, k, true, hb[e], pmod(z0 + e - ot2m, Z))) {
                num += hb[e];
                den += tot[e];
            }
        }
    }
}

bool aligned8(const void* p) { return ((uintptr_t)p & 7u) == 0; }

}  // namespace
