// What K4 (combine.cu) and the batched merge (merge.cu) share: the overlap
// test, the paired loads and stores of one lane's two adjacent z, and the
// column tail, which turns a warp's per-lane candidates into the five
// column maps of one (x, y) column.
//
// The column tail is the arithmetic of ops/maps2d.py's height_map,
// inferred_height_map and positive_band_sums (gvom_tpu/ops/maps2d.py:76-116,
// :285-317), rounded as XLA rounds it: __fmaf_rn where the plain twin calls
// grid.fma32, one __f*_rn for every other operation (the sources are built
// with -fmad=false).

#pragma once

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

// The five column maps of one column from its warp's candidates: best_sc is
// the lane's lowest window-relative z of an occupied voxel and best_mh that
// voxel's min_height, best_sc2 the lowest of an unoccupied voxel with
// evidence (Z where none); occ_r, hit_r, tot_r and pz_r are each of the
// lane's voxels' occupancy, hit, hit + miss and window-relative z. relx and
// rely are the column's window-relative x and y, (ot0, ot1, ot2) the
// window's origin. Lane 0 writes the maps at index `col`.
template <int ZC>
__device__ __forceinline__ void column_tail(
    int best_sc, float best_mh, int best_sc2, const bool (&occ_r)[ZC][2], const int (&hit_r)[ZC][2],
    const int (&tot_r)[ZC][2], const int (&pz_r)[ZC][2], int Z, int relx, int rely, int ot0, int ot1, int ot2,
    const float* __restrict__ ego, const ColumnConsts& k, int lane, int64_t col,
    float* __restrict__ hm_o, float* __restrict__ ihm_o, int* __restrict__ pnum_o, int* __restrict__ pden_o,
    int* __restrict__ bok_o)
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
    float hm;
    if (best_sc < Z) {
        hm = __fmul_rn(__fadd_rn(__fadd_rn(best_mh, (float)best_sc), o2f), k.zres);
    } else {
        const float gx = __fmaf_rn(__fadd_rn((float)ot0, (float)relx), k.xyres, -ego[0]);
        const float gy = __fmaf_rn(__fadd_rn((float)ot1, (float)rely), k.xyres, -ego[1]);
        const bool disk = __fmaf_rn(gx, gx, __fmul_rn(gy, gy)) <= k.rr2;
        hm = disk ? __fsub_rn(ego[2], k.g2l) : k.unknown;
    }
    const float ihm = best_sc2 < Z ? __fmul_rn(__fadd_rn((float)best_sc2, o2f), k.zres) : k.unknown;

    const int lo = (int)floorf(__fmaf_rn(__fadd_rn(hm, k.pot), k.inv_z, -o2f)) + 1;
    const int hi = (int)floorf(__fmaf_rn(__fadd_rn(hm, k.rh), k.inv_z, -o2f));
    const bool band_ok = lo >= 0 && lo < Z && hi >= 0 && hi < Z;
    int num = 0, den = 0;
#pragma unroll
    for (int c = 0; c < ZC; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            if (occ_r[c][e] && hit_r[c][e] > k.hct && pz_r[c][e] >= lo && pz_r[c][e] <= hi) {
                num += hit_r[c][e];
                den += tot_r[c][e];
            }
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

bool aligned8(const void* p) { return ((uintptr_t)p & 7u) == 0; }

}  // namespace
