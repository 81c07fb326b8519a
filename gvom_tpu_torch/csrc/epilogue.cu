// K3 and K5: the moments epilogue — neighbourhood box, crop, optional
// occupancy pre-mask, and the write of the ten moment channels into a tensor
// of the caller's.
//
// K3 replaces gvom_tpu/ops/pallas_kernels.py:1459 _xbox_epilogue_into (body
// :1362): mask on, written straight into one scan's ring-buffer slot. K5
// replaces :1310 _xbox_epilogue (body _xbox_epilogue_factory :1217): a fresh
// tensor, the mask optional, the full grid or a y-slab (:1540, the slab's
// U = Ys). On the TPU the y/z box happens inside the sorted matmul kernel and
// the epilogue adds only the ±rx x-box and splits hit and min_height out of a
// packed slot; here K2 leaves own-voxel sums and writes hit and min_height
// dense, so this kernel does the whole ±rx/±ry/±rz box and there is nothing
// to split. Each source is translated into the target voxel's frame (the
// parallel-axis update of gvom_tpu/ops/moments.py::translate_raw):
//   S1'_a  = S1_a + t_a·n
//   R2'_ab = R2_ab + t_a·S1_b + t_b·S1_a + t_a·t_b·n
// The sums are K2's (binning.cu): n at `sums` [P], channels 1–9 at `rest`
// [9, P], the caller's scratch. Channels 1–9 of a source are read only where
// its n > 0, by a branch, never through a multiply by zero, so whatever they
// hold where n is 0 (zero in K2's scratch, NaN in a test) reaches no output.
//
// What bounds it on the H100: bytes. Every voxel of the output is written
// (10 f32 channels, 168 MB at 256×256×64, 0.050 ms at 3.35 TB/s); n is read
// where a target's box reaches and the nine other channels where n > 0
// there. Its first version ran one thread per target with 64-bit index
// division, loaded n at all 27 box neighbours from global memory (113 M loads
// with the mask off), ran the whole box loop even where the neighbourhood was
// empty and read a term's channels with one dependent round trip each: 22 %
// of its bound with the mask off.
//
// The design (its variants' times on the card are in PERF.md §6):
//   * one block per 8×8×32 tile of torus-ordered targets (x, y, z; z
//     fastest, so a warp stores 32 neighbouring floats), its indices from a
//     3-D grid, no 64-bit division;
//   * one pass of asynchronous copies (cp.async, all in flight at once)
//     stages the tile's n and its ±r halo in shared memory. Along each axis
//     the tile's targets are one run of scratch coordinates, or two where the
//     window seam (or the slab's seam) falls inside the tile; the staged row
//     then holds each run with its own halo, as the slab scratch does
//     (binning.cu), so no target reads across the seam. A ballot per staged
//     column turns its n into a 64-bit mask of n > 0;
//   * an early exit: __syncthreads_or over "some n > 0 in the halo" (with
//     the mask on, first "some target has a hit") lets an empty tile do
//     nothing but 16-byte zero stores;
//   * the channels 1-9 of the tile's non-empty voxels, and only those, are
//     staged too, compacted in rank order (a voxel's rank from its column's
//     mask), when at most CAP of them; past that a term reads them from the
//     scratch;
//   * the box is taken only at the targets that need it (a hit with the mask
//     on, some n > 0 in the box with it off), listed and taken one a lane, so
//     a warp's lanes all work where a surface crosses the tile; each visits
//     only its neighbours with n > 0 (the column masks) and adds the terms in
//     the order (ox, oy, oz) of the plain twin, so every form is bitwise what
//     the first version wrote. The other targets get zeros, 16 bytes at a
//     time where four neighbours in z need none.
//
// MASK (template): with the mask on, a voxel without a hit of its own is
// written as zero and its box is skipped. With it off (the batched step,
// which masks later by the whole batch's occupancy) the box is computed at
// EVERY voxel, since a voxel with no endpoint of its own still receives its
// neighbours' sums.
//
// Any eigen distance: the tiled kernel stages a column's n bits in one
// 64-bit word (TZ + 4rz <= 64) and the box's halo in shared memory, which
// grows with (8+4rx)(8+4ry)(32+4rz). Where either does not hold (rz >= 9,
// rx >= 8, (rx, rz) = (5, 8) on the H100's 227 KB), the launcher takes the
// separable passes below (three launches, bitwise the plain twin, with a
// workspace of the caller's: gvom_moments_epilogue_workspace says how
// large) or epilogue_direct_kernel: with the mask on at a box of at most
// BOX_DIRECT_MAX voxels, and at any box whose smallest pass tile does not
// fit (max(rx, ry) > 1452 on the H100) or whose grid is past the launch
// limits. gvom_moments_epilogue_route says which. It asks the device what
// a block may opt in to, so it never fails the attribute call.

// Slab form ((ys0, Ys) != (0, Y), the same rule as raycast.cu and
// binning.cu): the output and hit are [.., X, Ys, Z], the torus
// rows [ys0, ys0+Ys), and the sums are K2's slab scratch
// [10, Xp, Ys+4ry, Zp] (binning.cu): slab row j is window row (w0+j) mod Y
// and sits at scratch row j + ry, or j + 3ry past the window seam
// (j >= lenA). The full grid is ys0 = 0, Ys = Y with scratch row wy + ry.
//
// The output is [S, 10, X, Ys, Z] and the slot is read on the device
// (slot = scan_ok ? cursor : B), so the insert needs no sync with the host;
// a null slot pointer means slot 0 of a fresh tensor.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 8, TY = 8, TZ = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(TX * TY == 2 * 32 && TZ == 32, "a tile column's targets are one warp's lanes; two columns a lane in a scan");

__device__ __forceinline__ int pmod(int a, int n) {
    int r = a % n;
    return r < 0 ? r + n : r;
}

// One axis of a tile: its tv targets (those inside the grid) sit at scratch
// coordinates c0, c0+1, ... up to target ks, and cs, cs+1, ... from there
// (ks = tv: one run). The staged row holds run A with its ±r halo, then run
// B with its own.
struct Axis {
    int c0, cs, ks, tv, r;
    __device__ int centre(int k) const { return k < ks ? c0 + k : cs + (k - ks); }
    __device__ int staged(int k) const { return k + r + (k >= ks ? 2 * r : 0); }
    __device__ int src(int e) const { return e < ks + 2 * r ? c0 - r + e : cs - r + (e - ks - 2 * r); }
    __device__ int staged_len() const { return ks < tv ? tv + 4 * r : tv + 2 * r; }
};

// targets at torus coordinates t0, t0+1, ... of an axis of `size` whose
// window starts at torus coordinate o mod size; scratch = window + r
__device__ __forceinline__ Axis torus_axis(int t0, int T, int size, int o, int r) {
    Axis a;
    a.r = r;
    a.tv = min(T, size - t0);
    const int w0 = pmod(t0 - o, size);
    a.c0 = w0 + r;
    a.ks = w0 + a.tv > size ? size - w0 : a.tv;
    a.cs = r;
    return a;
}

// targets at slab rows j0, j0+1, ... of a slab scratch whose window seam
// falls before slab row lenA: scratch row j + ry, or j + 3ry from lenA on
__device__ __forceinline__ Axis slab_axis(int j0, int T, int Ys, int lenA, int r) {
    Axis a;
    a.r = r;
    a.tv = min(T, Ys - j0);
    a.c0 = j0 + r + (j0 >= lenA ? 2 * r : 0);
    if (j0 < lenA && lenA < j0 + a.tv) {
        a.ks = lenA - j0;
        a.cs = lenA + 3 * r;
    } else {
        a.ks = a.tv;
        a.cs = 0;
    }
    return a;
}

// the non-empty voxels of a staged tile whose channels 1-9 are staged too
constexpr int CAP = 640;

// A source voxel's term of a target's box: n and its channels 1-9 v,
// translated by (ox, oy, oz) into the target's frame and added to acc
// (the plain twin's arithmetic and order; -fmad=false keeps it unfused).
__device__ __forceinline__ void add_term(float (&acc)[10], const float (&v)[9], float n, int ox, int oy, int oz)
{
    const float tv[3] = {(float)ox, (float)oy, (float)oz};
    const float* s1 = v;
    acc[0] += n;
#pragma unroll
    for (int a = 0; a < 3; ++a) acc[1 + a] += s1[a] + tv[a] * n;
    // (xx, xy, xz, yy, yz, zz)
    const int pa[6] = {0, 0, 0, 1, 1, 2};
    const int pb[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int q = 0; q < 6; ++q) {
        const int a = pa[q], b = pb[q];
        acc[4 + q] += v[3 + q] + tv[a] * s1[b] + tv[b] * s1[a] + tv[a] * tv[b] * n;
    }
}

template <bool MASK>
__global__ void __launch_bounds__(THREADS, 4) epilogue_kernel(
    const float* __restrict__ sums,    // [Xp, Yp | Ys+4ry, Zp] own-voxel n, padded window layout
    const float* __restrict__ rest,    // [9, ...] channels 1-9 beside it
    const int* __restrict__ hit,       // [X, Ys, Z] torus (read only when MASK)
    const int* __restrict__ origin,    // [3]
    const int* __restrict__ slot,      // [1] or null
    int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys, bool vec4,
    float* __restrict__ out)           // [S, 10, X, Ys, Z] torus
{
    // shared: staged n [TX+4rx][TY+4ry][TZ+4rz]; per staged (x, y) column
    // the bits of n > 0 and the rank of its first one among the tile's;
    // channels 1-9 of the non-empty voxels in rank order, [9][CAP]
    extern __shared__ float sh[];
    __shared__ int total, nact;
    __shared__ unsigned act[TX * TY];          // per tile column: the targets (z bits) whose box is taken
    __shared__ int actbase[TX * TY];
    __shared__ unsigned short list[TX * TY * TZ];   // those targets, column << 5 | z
    const int SYa = TY + 4 * ry, SZa = TZ + 4 * rz;
    const int ncol = (TX + 4 * rx) * SYa;
    uint64_t* colbits = reinterpret_cast<uint64_t*>(sh + ncol * SZa);
    int* colbase = reinterpret_cast<int*>(colbits + ncol);
    float* chan = reinterpret_cast<float*>(colbase + ncol);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tz0 = blockIdx.x * TZ, jy0 = blockIdx.y * TY, tx0 = blockIdx.z * TX;
    const int64_t V = (int64_t)X * Ys * Z;
    float* o = out + (int64_t)(slot ? slot[0] : 0) * 10 * V;

    const bool slab = !(ys0 == 0 && Ys == Y);
    const Axis ax = torus_axis(tx0, TX, X, origin[0], rx);
    const Axis az = torus_axis(tz0, TZ, Z, origin[2], rz);
    Axis ay;
    int Ysc;
    if (slab) {
        ay = slab_axis(jy0, TY, Ys, min(Ys, Y - pmod(ys0 - origin[1], Y)), ry);
        Ysc = Ys + 4 * ry;
    } else {
        ay = torus_axis(jy0, TY, Y, origin[1], ry);
        Ysc = Y + 2 * ry;
    }
    const int Zp = Z + 2 * rz;
    const int64_t P = (int64_t)(X + 2 * rx) * Ysc * Zp;
    const int lx_len = ax.staged_len(), ly_len = ay.staged_len(), lz_len = az.staged_len();

    auto torus_index = [&](int lx, int ly, int lz) {
        return ((int64_t)(tx0 + lx) * Ys + (jy0 + ly)) * Z + (tz0 + lz);
    };
    auto in_tile = [&](int col) { return col / TY < ax.tv && col % TY < ay.tv; };
    // the staged column of row r of the staged tile, and its source row of the scratch
    auto column = [&](int r, int& ex, int& ey) {
        ex = r / ly_len;
        ey = r - ex * ly_len;
        return ex * SYa + ey;
    };
    auto source = [&](int ex, int ey) { return ((int64_t)ax.src(ex) * Ysc + ay.src(ey)) * Zp; };

    bool empty = false;
    if (MASK) {
        // the targets' hits, one warp a tile column (z = lane), every load in flight at once
        int h[TX * TY / WARPS];
#pragma unroll
        for (int k = 0; k < TX * TY / WARPS; ++k) {
            const int col = warp + WARPS * k;
            h[k] = in_tile(col) && lane < az.tv ? hit[torus_index(col / TY, col % TY, lane)] : 0;
        }
        unsigned any = 0;
#pragma unroll
        for (int k = 0; k < TX * TY / WARPS; ++k) {
            const unsigned b = __ballot_sync(0xffffffffu, h[k] > 0);
            if (lane == 0) act[warp + WARPS * k] = b;
            any |= b;
        }
        empty = !__syncthreads_or(any != 0);
    }
    if (!empty) {
        // stage n over the tile and its halo: every copy in flight at once
        for (int r = warp; r < lx_len * ly_len; r += WARPS) {
            int ex, ey;
            float* srow = sh + column(r, ex, ey) * SZa;
            const float* g = sums + source(ex, ey);
            for (int ez = lane; ez < lz_len; ez += 32) __pipeline_memcpy_async(srow + ez, g + az.src(ez), 4);
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        for (int c = threadIdx.x; c < ncol; c += THREADS) colbits[c] = 0;
        __syncthreads();
        // the columns' bits of n > 0 (SZa <= 64)
        int any = 0;
        for (int r = warp; r < lx_len * ly_len; r += WARPS) {
            int ex, ey;
            const int c = column(r, ex, ey);
            const float* srow = sh + c * SZa;
            const unsigned lo = __ballot_sync(0xffffffffu, lane < lz_len && srow[lane] != 0.0f);
            const unsigned hi = __ballot_sync(0xffffffffu, lane + 32 < lz_len && srow[lane + 32] != 0.0f);
            if (lane == 0) colbits[c] = (uint64_t)hi << 32 | lo;
            any |= (lo | hi) != 0;
        }
        empty = !__syncthreads_or(any);
    }
    if (!MASK && !empty && threadIdx.x < TX * TY) {
        // with the mask off a target's box is taken where some n > 0 in it
        const int col = threadIdx.x, lx = col / TY, ly = col % TY;
        unsigned a = 0;
        if (in_tile(col)) {
            uint64_t w = 0;
            for (int ox = -rx; ox <= rx; ++ox)
                for (int oy = -ry; oy <= ry; ++oy) w |= colbits[(ax.staged(lx) + ox) * SYa + ay.staged(ly) + oy];
            uint64_t d = 0;     // dilated by ±rz along z
            for (int oz = -rz; oz <= rz; ++oz) d |= oz < 0 ? w << -oz : w >> oz;
            for (int lz = 0; lz < az.tv; ++lz) a |= (unsigned)(d >> az.staged(lz) & 1) << lz;
        }
        act[col] = a;
    }
    if (empty && threadIdx.x < TX * TY) act[threadIdx.x] = 0;
    __syncthreads();

    // zeros where no box is taken: 16 bytes where four neighbours in z have none
    if (vec4 && az.tv == TZ) {
        const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int idx = threadIdx.x; idx < 10 * TX * TY * (TZ / 4); idx += THREADS) {
            const int q = idx % (TZ / 4), col = (idx / (TZ / 4)) % (TX * TY), c = idx / (TX * TY * (TZ / 4));
            if (!in_tile(col)) continue;
            const unsigned b = act[col] >> 4 * q & 0xFu;
            float* d = o + c * V + torus_index(col / TY, col % TY, 4 * q);
            if (!b) {
                *reinterpret_cast<float4*>(d) = z4;
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (!(b >> e & 1)) d[e] = 0.0f;
            }
        }
    } else {
        for (int col = warp; col < TX * TY; col += WARPS) {
            if (!in_tile(col) || lane >= az.tv || act[col] >> lane & 1) continue;
            const int64_t t = torus_index(col / TY, col % TY, lane);
#pragma unroll
            for (int c = 0; c < 10; ++c) o[c * V + t] = 0.0f;
        }
    }
    if (empty) return;

    // each staged column's first rank and each tile column's first listed
    // target: scans over the columns by warp 0
    if (warp == 0) {
        const int per = (ncol + 31) / 32;
        int local = 0;
        for (int i = 0; i < per; ++i) {
            const int c = lane * per + i;
            if (c < ncol) local += __popcll(colbits[c]);
        }
        int incl = local;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += t;
        }
        int base = incl - local;
        for (int i = 0; i < per; ++i) {
            const int c = lane * per + i;
            if (c < ncol) {
                colbase[c] = base;
                base += __popcll(colbits[c]);
            }
        }
        if (lane == 31) total = incl;
        // TX·TY = 64 tile columns, two a lane
        const int a0 = __popc(act[2 * lane]), a1 = __popc(act[2 * lane + 1]);
        int ai = a0 + a1;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, ai, d);
            if (lane >= d) ai += t;
        }
        actbase[2 * lane] = ai - a0 - a1;
        actbase[2 * lane + 1] = ai - a1;
        if (lane == 31) nact = ai;
    }
    __syncthreads();
    for (int col = warp; col < TX * TY; col += WARPS) {
        const unsigned a = act[col];
        if (a >> lane & 1)
            list[actbase[col] + __popc(a & ((1u << lane) - 1))] = (unsigned short)(col << 5 | lane);
    }
    // channels 1-9 of the non-empty voxels, where they fit: read only there
    const bool compact = total <= CAP;
    if (compact) {
        for (int r = warp; r < lx_len * ly_len; r += WARPS) {
            int ex, ey;
            const int c = column(r, ex, ey);
            const uint64_t w = colbits[c];
            if (!w) continue;
            const float* g = rest + source(ex, ey);
            for (int ez = lane; ez < lz_len; ez += 32) {
                if (!(w >> ez & 1)) continue;
                const int rank = colbase[c] + __popcll(w & ((1ull << ez) - 1));
                const float* gz = g + az.src(ez);
#pragma unroll
                for (int ch = 0; ch < 9; ++ch) __pipeline_memcpy_async(chan + ch * CAP + rank, gz + ch * P, 4);
            }
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
    }
    __syncthreads();

    // the listed targets, one a lane
    for (int i = threadIdx.x; i < nact; i += THREADS) {
        const int e = list[i], col = e >> 5, lz = e & 31, lx = col / TY, ly = col % TY;
        float acc[10];
#pragma unroll
        for (int c = 0; c < 10; ++c) acc[c] = 0.0f;
        const int cx = ax.centre(lx), cy = ay.centre(ly), cz = az.centre(lz);
        const int ex = ax.staged(lx), ey = ay.staged(ly), ez = az.staged(lz);
        const unsigned zmask = (2u << 2 * rz) - 1;
        for (int ox = -rx; ox <= rx; ++ox) {
            for (int oy = -ry; oy <= ry; ++oy) {
                const int scol = (ex + ox) * SYa + (ey + oy);
                // the neighbours (ox, oy, oz) with n > 0, oz ascending:
                // channels 1-9 are defined only there
                const uint64_t w = colbits[scol];
                unsigned nz = (unsigned)(w >> (ez - rz)) & zmask;
                if (!nz) continue;
                int rank = colbase[scol] + __popcll(w & ((1ull << (ez - rz)) - 1));
                const float* nrow = sh + scol * SZa + ez;
                const float* srow = rest + ((int64_t)(cx + ox) * Ysc + (cy + oy)) * Zp + cz;
                for (; nz; nz &= nz - 1, ++rank) {
                    const int oz = __ffs(nz) - 1 - rz;
                    const float n = nrow[oz];
                    float v[9];
                    if (compact) {
#pragma unroll
                        for (int ch = 0; ch < 9; ++ch) v[ch] = chan[ch * CAP + rank];
                    } else {
#pragma unroll
                        for (int ch = 0; ch < 9; ++ch) v[ch] = srow[oz + ch * P];
                    }
                    add_term(acc, v, n, ox, oy, oz);
                }
            }
        }
        const int64_t t = torus_index(lx, ly, lz);
#pragma unroll
        for (int c = 0; c < 10; ++c) o[c * V + t] = acc[c];
    }
}

// The box at any other eigen distance, as three separable passes (x, then
// y, then z), the plain twin's recurrence (ops/moments.py::
// box_aggregate_moments) in its own order: along each axis a target starts
// from its centre and adds its neighbours at offsets -r .. -1, +1 .. +r, each
// translated into the target's frame by the twin's translate_raw, one
// __fadd_rn / __fmul_rn per operation. So every channel is bitwise the
// twin's, and the work is O(rx + ry + rz) a target, not the box's
// (2rx+1)(2ry+1)(2rz+1).
//
// Most voxels are empty, and that is what the passes exploit. Where a
// source's n is not > 0 its term is +0 in every channel (the twin zeroes
// channels 1-9 there first, and a translated +0 is +0), so its channels are
// neither read nor added; adding +0 changes a sum only from -0 to +0, so a
// target that skipped a term adds +0 once at the end, which gives the twin's
// bits. A pass writes n everywhere and channels 1-9 only where its n > 0;
// the next pass reads them only there. So the passes move about n's bytes
// (plus the non-empty voxels' channels) and the last one writes the ten
// output channels: the output is most of the traffic.
//
// Passes x and y are box_pass, over tiles of 32 targets along the axis by
// 32 z, whose lines with their ±r halo are staged in shared memory, every
// load of the tile in flight at once; the twin's loop then reads every
// neighbour from shared memory. Pass z (box_pass_z), whose lines are
// contiguous and whose writes are the output, takes one thread a target:
// line_sum loads the n of its window eight loads at a time, then the
// channels of its live neighbours. What was tried on the card first (PERF.md
// §6): one thread a target reading each neighbour's n and waiting for it
// before the next reached a fifth of the memory rate in passes x and y; a
// tile for pass z as well was 2.4 times slower with the mask on. Pass x
// reads the scratch [10, Xp, Ysc, Zp] and writes the workspace W1 [10, X,
// Ysc, Zp] (x in window order); pass y writes W2 [10, X, Yw, Zp] (Yw = Ysc
// - 2ry rows: the window rows, or for a slab scratch the slab rows with the
// 2ry unused rows between its two runs); pass z reads W2 and writes the
// torus output, masked, into out[slot].
//
// With the mask on and a small box (box_direct_takes) the direct kernel
// below stays: it reads the box only at occupied targets, while the passes
// cost about as much with the mask as without.

// One neighbour's term along AXIS at offset t (the twin's translate_raw,
// then the add into acc, in its order): v holds its n, S1 and R2; n, S1
// with S1_a + t·n, R2 with the diagonal (R2_aa + 2t·S1_a) + t²·n and the
// two cross terms R2_ab + t·S1_b.
template <int AXIS>
__device__ __forceinline__ void add_axis_term(float (&acc)[10], const float (&v)[10], int off)
{
    constexpr int DIAG = AXIS == 0 ? 0 : (AXIS == 1 ? 3 : 5);
    // the two cross pairs (xx, xy, xz, yy, yz, zz order) and the S1 component each takes
    constexpr int C0 = AXIS == 2 ? 2 : 1, S0 = AXIS == 0 ? 1 : 0;
    constexpr int C1 = AXIS == 0 ? 2 : 4, S1 = AXIS == 2 ? 1 : 2;
    const float t = (float)off, t2 = (float)(2 * off), tt = (float)(off * off), n = v[0];
    acc[0] = __fadd_rn(acc[0], n);
#pragma unroll
    for (int c = 0; c < 3; ++c)
        acc[1 + c] = __fadd_rn(acc[1 + c], c == AXIS ? __fadd_rn(v[1 + c], __fmul_rn(t, n)) : v[1 + c]);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
        float term = v[4 + q];
        if (q == DIAG) term = __fadd_rn(__fadd_rn(term, __fmul_rn(t2, v[1 + AXIS])), __fmul_rn(tt, n));
        else if (q == C0) term = __fadd_rn(term, __fmul_rn(t, v[1 + S0]));
        else if (q == C1) term = __fadd_rn(term, __fmul_rn(t, v[1 + S1]));
        acc[4 + q] = __fadd_rn(acc[4 + q], term);
    }
}

// Pass x or y (AXIS 0, 1): targets (a, u, k), a along the axis (A of
// them), u across it (U), k the padded z (Zp); the input element at in +
// (a + r)·a_in + u·u_in + k (n; channels 1-9 at the same place of in_rest),
// the output at a·a_out + u·u_out + k.
struct BoxPass {
    const float* in;
    const float* in_rest;
    int64_t Pin, a_in, u_in;
    float* out;
    int64_t Pout, a_out, u_out;
    int A, Zp, r, TA, TK;
};

// the loads a thread issues before it uses one: the warp waits at the first use
constexpr int LOADS = 8;

// Pass x or y over a tile of TA targets along the axis by TK z (a lane a
// z, the warps along the axis; TA = TK = 32 but where the staged lines
// would not fit). The tile's lines with their ±r halo are staged in shared
// memory, [10][TA + 2r][TK + 1]: first n (LOADS loads in
// flight a thread; n not > 0 kept as 0), then channels 1-9 where n > 0, so
// every neighbour the twin's loop visits is a shared-memory read. A tile
// with no n > 0 writes n = 0 and stages nothing more. Writes n everywhere
// and channels 1-9 where n > 0.
template <int AXIS>
__global__ void __launch_bounds__(THREADS) box_pass(BoxPass g)
{
    extern __shared__ float sbox[];
    const int TA = g.TA, TK = g.TK, SK = TK + 1, r = g.r, LA = TA + 2 * r, CH = LA * SK;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int a0 = blockIdx.y * TA, k = blockIdx.x * TK + lane, u = blockIdx.z;
    const bool kin = lane < TK && k < g.Zp;
    const float* in = g.in + u * g.u_in + k;
    const float* in_rest = g.in_rest + u * g.u_in + k;
    float* out = g.out + u * g.u_out + k;
    int any = 0;
    for (int l0 = warp; l0 < LA; l0 += 8 * LOADS) {
        float n[LOADS];
#pragma unroll
        for (int q = 0; q < LOADS; ++q) {
            const int l = l0 + 8 * q;
            n[q] = kin && l < LA && a0 + l < g.A + 2 * r ? __ldg(in + (a0 + l) * g.a_in) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < LOADS; ++q) {
            const int l = l0 + 8 * q;
            if (l < LA && lane < TK) sbox[l * SK + lane] = n[q] > 0.0f ? n[q] : 0.0f;
            any |= n[q] > 0.0f;
        }
    }
    if (!__syncthreads_or(any)) {
        for (int al = warp; al < TA; al += 8)
            if (kin && a0 + al < g.A) out[(a0 + al) * g.a_out] = 0.0f;
        return;
    }
    // channels 1-9 where n > 0, two elements' loads in flight at once
    for (int l0 = warp; l0 < LA; l0 += 16) {
        float v[2][9];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int l = l0 + 8 * q;
            const bool live = l < LA && lane < TK && sbox[l * SK + lane] > 0.0f;
#pragma unroll
            for (int c = 0; c < 9; ++c) v[q][c] = live ? __ldg(in_rest + (a0 + l) * g.a_in + c * g.Pin) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int l = l0 + 8 * q;
            if (!(l < LA && lane < TK && sbox[l * SK + lane] > 0.0f)) continue;
#pragma unroll
            for (int c = 0; c < 9; ++c) sbox[(c + 1) * CH + l * SK + lane] = v[q][c];
        }
    }
    __syncthreads();
    if (!kin) return;
    for (int al = warp; al < TA && a0 + al < g.A; al += 8) {
        const float* centre = sbox + (al + r) * SK + lane;
        const bool live = centre[0] > 0.0f;
        float acc[10];
#pragma unroll
        for (int c = 0; c < 10; ++c) acc[c] = live ? centre[c * CH] : 0.0f;
        // a neighbour without n > 0 adds +0 to every channel: once, at the end
        bool skipped = false;
        for (int off = -r; off <= r; ++off) {
            if (off == 0) continue;
            const float* p = centre + off * SK;
            if (!(p[0] > 0.0f)) {
                skipped = true;
                continue;
            }
            float v[10];
#pragma unroll
            for (int c = 0; c < 10; ++c) v[c] = p[c * CH];
            add_axis_term<AXIS>(acc, v, off);
        }
        if (skipped) {
#pragma unroll
            for (int c = 0; c < 10; ++c) acc[c] = __fadd_rn(acc[c], 0.0f);
        }
        float* d = out + (a0 + al) * g.a_out;
        d[0] = acc[0];
        if (acc[0] > 0.0f) {
#pragma unroll
            for (int c = 1; c < 10; ++c) d[c * g.Pout] = acc[c];
        }
    }
}

// The twin's sums along AXIS of the line whose centre is src, in global
// memory ([10, ...] of channel stride P, step between neighbours), any r:
// the n of 64 neighbours at a time, LOADS loads in flight, then the
// channels of those with n > 0, each added in offset order.
template <int AXIS>
__device__ __forceinline__ void line_sum(float (&acc)[10], const float* __restrict__ src, int64_t P, int64_t step,
                                         int r)
{
    const float n0 = __ldg(src);
    const bool live = n0 > 0.0f;
#pragma unroll
    for (int c = 0; c < 10; ++c) acc[c] = live ? (c ? __ldg(src + c * P) : n0) : 0.0f;
    int nlive = 0;
    for (int w0 = 0; w0 <= 2 * r; w0 += 64) {
        const int len = min(64, 2 * r + 1 - w0);
        const float* base = src + (w0 - r) * step;
        uint64_t bits = 0;
        for (int b0 = 0; b0 < len; b0 += LOADS) {
            float n[LOADS];
#pragma unroll
            for (int q = 0; q < LOADS; ++q) n[q] = b0 + q < len ? __ldg(base + (b0 + q) * step) : 0.0f;
#pragma unroll
            for (int q = 0; q < LOADS; ++q) bits |= (uint64_t)(n[q] > 0.0f) << (b0 + q);
        }
        if (w0 <= r && r < w0 + 64) bits &= ~(1ull << (r - w0));   // the centre is acc's start
        nlive += __popcll(bits);
        for (; bits; bits &= bits - 1) {
            const int off = w0 + __ffsll((long long)bits) - 1 - r;
            const float* p = src + off * step;
            float v[10];
#pragma unroll
            for (int c = 0; c < 10; ++c) v[c] = __ldg(p + c * P);
            add_axis_term<AXIS>(acc, v, off);
        }
    }
    // a neighbour without n > 0 adds +0 to every channel: once, at the end
    if (nlive < 2 * r) {
#pragma unroll
        for (int c = 0; c < 10; ++c) acc[c] = __fadd_rn(acc[c], 0.0f);
    }
}

// Pass z: one thread a torus target (x = blockIdx.y, then y and z), its
// line in W2 [10, X, Yw, Zp]; writes the ten channels of out[slot], zeros
// where MASK and the target has no hit.
template <bool MASK>
__global__ void __launch_bounds__(THREADS) box_pass_z(
    const float* __restrict__ w2, int64_t P2, const int* __restrict__ hit, const int* __restrict__ origin,
    const int* __restrict__ slot, int X, int Y, int Z, int ry, int rz, int ys0, int Ys, float* __restrict__ out)
{
    const int t = blockIdx.x * THREADS + threadIdx.x;
    if (t >= Ys * Z) return;
    const int x = blockIdx.y, y = t / Z, z = t - y * Z;
    const int64_t V = (int64_t)X * Ys * Z, idx = (int64_t)x * Ys * Z + t;
    float* o = out + (int64_t)(slot ? slot[0] : 0) * 10 * V + idx;
    float acc[10];
    if (MASK && !(hit[idx] > 0)) {
#pragma unroll
        for (int c = 0; c < 10; ++c) acc[c] = 0.0f;
    } else {
        // the target's row of W2 (its window x and row) and padded z
        int q, Yw;
        if (!(ys0 == 0 && Ys == Y)) {
            const int lenA = min(Ys, Y - pmod(ys0 - origin[1], Y));
            q = y < lenA ? y : y + 2 * ry;
            Yw = Ys + 2 * ry;
        } else {
            q = pmod(y - origin[1], Y);
            Yw = Y;
        }
        const int Zp = Z + 2 * rz;
        line_sum<2>(acc, w2 + ((int64_t)pmod(x - origin[0], X) * Yw + q) * Zp + pmod(z - origin[2], Z) + rz, P2, 1,
                    rz);
    }
#pragma unroll
    for (int c = 0; c < 10; ++c) o[c * V] = acc[c];
}

// The box at any eigen distance: one thread a target, z fastest, its box
// read from the scratch in global memory (L1 and L2 hold the neighbourhood
// that a block's targets share), in the order (ox, oy, oz) of the tiled
// kernel, channels 1-9 only where n != 0. Taken with the mask on at a
// small box (box_direct_takes), where only the occupied targets read their
// box and it is faster than the separable passes, whose cost does not
// fall with the mask (PERF.md §6), and wherever the passes cannot launch
// (separable_fits). Its sums are in the tiled kernel's order, not the
// twin's: within the f32 summation bound of the twin's, not bitwise.
template <bool MASK>
__global__ void __launch_bounds__(THREADS) epilogue_direct_kernel(
    const float* __restrict__ sums, const float* __restrict__ rest, const int* __restrict__ hit,
    const int* __restrict__ origin, const int* __restrict__ slot, int X, int Y, int Z, int rx, int ry, int rz,
    int ys0, int Ys, float* __restrict__ out)
{
    const int64_t V = (int64_t)X * Ys * Z;
    const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (t >= V) return;
    float* o = out + (int64_t)(slot ? slot[0] : 0) * 10 * V;
    const int z = (int)(t % Z), y = (int)(t / Z % Ys), x = (int)(t / ((int64_t)Z * Ys));
    const bool slab = !(ys0 == 0 && Ys == Y);
    // the target's scratch coordinates (torus_axis and slab_axis)
    const int cx = pmod(x - origin[0], X) + rx, cz = pmod(z - origin[2], Z) + rz;
    int cy, Ysc;
    if (slab) {
        const int lenA = min(Ys, Y - pmod(ys0 - origin[1], Y));
        cy = y + ry + (y >= lenA ? 2 * ry : 0);
        Ysc = Ys + 4 * ry;
    } else {
        cy = pmod(y - origin[1], Y) + ry;
        Ysc = Y + 2 * ry;
    }
    const int Zp = Z + 2 * rz;
    const int64_t P = (int64_t)(X + 2 * rx) * Ysc * Zp;
    float acc[10];
#pragma unroll
    for (int c = 0; c < 10; ++c) acc[c] = 0.0f;
    if (!MASK || hit[t] > 0) {
        for (int ox = -rx; ox <= rx; ++ox) {
            for (int oy = -ry; oy <= ry; ++oy) {
                const int64_t row = ((int64_t)(cx + ox) * Ysc + (cy + oy)) * Zp + cz;
                for (int oz = -rz; oz <= rz; ++oz) {
                    const float n = __ldg(sums + row + oz);
                    if (n == 0.0f) continue;
                    float v[9];
#pragma unroll
                    for (int ch = 0; ch < 9; ++ch) v[ch] = __ldg(rest + row + oz + ch * P);
                    add_term(acc, v, n, ox, oy, oz);
                }
            }
        }
    }
#pragma unroll
    for (int c = 0; c < 10; ++c) o[c * V + t] = acc[c];
}

// the tiled kernel's dynamic shared memory: the staged floats (an even
// count: TZ + 4rz is even), then the columns' 64-bit words and ranks, then
// the compacted channels
size_t tiled_smem(int rx, int ry, int rz)
{
    const size_t ncol = (size_t)(TX + 4 * rx) * (TY + 4 * ry);
    return sizeof(float) * ncol * (TZ + 4 * rz) + (sizeof(uint64_t) + sizeof(int)) * ncol + sizeof(float) * 9 * CAP;
}

// The largest dynamic shared memory a block of this device may opt in to;
// rc: a CUDA error of the query
int smem_optin(int* rc)
{
    static int optin = 0;
    if (!optin) {
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e != cudaSuccess) {
            optin = 0;
            *rc = (int)e;
        }
    }
    return optin;
}

// Whether the tiled kernel takes this shape: its grid within the launch
// limits, a staged column's bits in one 64-bit word, and its shared memory
// (with the static arrays) within what a block of the current device may
// opt in to. Else the separable passes or the direct kernel (route). rc: a
// CUDA error of the queries.
template <bool MASK>
bool tiled(int X, int Ys, int rx, int ry, int rz, int* rc)
{
    static size_t fixed = 0;
    static bool known = false;
    *rc = 0;
    const size_t optin = (size_t)smem_optin(rc);
    if (*rc) return false;
    if (!known) {
        cudaFuncAttributes fa;
        const cudaError_t e = cudaFuncGetAttributes(&fa, epilogue_kernel<MASK>);
        if (e != cudaSuccess) {
            *rc = (int)e;
            return false;
        }
        fixed = fa.sharedSizeBytes;
        known = true;
    }
    return (Ys + TY - 1) / TY <= 65535 && (X + TX - 1) / TX <= 65535 && TZ + 4 * rz <= 64 &&
           tiled_smem(rx, ry, rz) + fixed <= optin;
}

// One launch of box_pass: its tile (TA halved, then TK, until the staged
// lines fit in the shared memory a block may opt in to) and its grid, tiles
// of the axis (A) and of z (Zp), and U blocks across.
template <int AXIS>
int launch_pass(BoxPass g, int U, cudaStream_t st)
{
    int rc = 0;
    const size_t optin = (size_t)smem_optin(&rc);
    if (rc) return rc;
    g.TA = g.TK = 32;
    auto smem = [&]() { return sizeof(float) * 10 * (size_t)(g.TA + 2 * g.r) * (g.TK + 1); };
    while (smem() > optin) {
        if (g.TA > 1) g.TA /= 2;
        else if (g.TK > 1) g.TK /= 2;
        else return (int)cudaErrorInvalidValue;
    }
    const dim3 grid((unsigned)((g.Zp + g.TK - 1) / g.TK), (unsigned)((g.A + g.TA - 1) / g.TA), (unsigned)U);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
    // past 48 KB the block must opt in; the first call's size is set once, before any graph capture
    static size_t set = 48 * 1024;
    if (smem() > set) {
        const cudaError_t e = cudaFuncSetAttribute(box_pass<AXIS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)smem());
        if (e != cudaSuccess) return (int)e;
        set = smem();
    }
    box_pass<AXIS><<<grid, THREADS, smem(), st>>>(g);
    return 0;
}

// The largest box (in voxels) that epilogue_direct_kernel takes with the
// mask on where the passes fit; a larger one, and any box with the mask
// off, takes the separable passes. Past the tiled kernel a box under 475
// voxels is (1, rz) with rz >= 9, 9(2rz + 1) voxels; on an upstream scan
// the direct kernel wins up to (1, 16), 297, and loses from (1, 20), 369
// (scripts/time_wide_forms.py, PERF.md §6)
constexpr int BOX_DIRECT_MAX = 297;

bool box_direct_takes(int rx, int ry, int rz)
{
    return (int64_t)(2 * rx + 1) * (2 * ry + 1) * (2 * rz + 1) <= BOX_DIRECT_MAX;
}

// the rows of the scratch: the window's with ry a side, or the slab's with
// its seam rows (binning.cu)
int scratch_rows(int Y, int ry, int ys0, int Ys)
{
    return (ys0 == 0 && Ys == Y) ? Y + 2 * ry : Ys + 4 * ry;
}

// Whether the separable passes can launch: the smallest tile of a pass
// (launch_pass: one line of 2r + 1 voxels by one z of ten channels, its
// rows padded to two) within what a block may opt in to, and every grid
// within the launch limits (X and the scratch's rows are grid dimensions)
bool separable_fits(int X, int Ysc, int rx, int ry, size_t optin)
{
    return sizeof(float) * 10 * (2 * (size_t)max(rx, ry) + 1) * 2 <= optin && X <= 65535 && Ysc <= 65535;
}

// the separable passes' workspace in floats: W1 [10, X, Ysc, Zp], then W2
// [10, X, Ysc - 2ry, Zp]
int64_t separable_floats(int X, int Z, int ry, int rz, int Ysc)
{
    return (int64_t)10 * X * (2 * Ysc - 2 * ry) * (Z + 2 * rz);
}

// the epilogue's kernels, numbered as gvom_moments_epilogue_route answers
enum Route { TILED = 0, SEPARABLE = 1, DIRECT = 2 };

// Which kernel takes this shape; rc: a CUDA error of the queries
template <bool MASK>
Route route(int X, int Y, int rx, int ry, int rz, int ys0, int Ys, int* rc)
{
    if (tiled<MASK>(X, Ys, rx, ry, rz, rc)) return TILED;
    if (MASK && box_direct_takes(rx, ry, rz)) return DIRECT;
    const size_t optin = (size_t)smem_optin(rc);
    return separable_fits(X, scratch_rows(Y, ry, ys0, Ys), rx, ry, optin) ? SEPARABLE : DIRECT;
}

template <bool MASK>
int launch(const void* sums, const void* rest, const void* hit, const void* origin, const void* slot,
           int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys, void* out, void* work, cudaStream_t st)
{
    int rc = 0;
    const Route r = route<MASK>(X, Y, rx, ry, rz, ys0, Ys, &rc);
    if (rc) return rc;
    if (r == DIRECT) {
        epilogue_direct_kernel<MASK><<<(unsigned)(((int64_t)X * Ys * Z + THREADS - 1) / THREADS), THREADS, 0, st>>>(
            (const float*)sums, (const float*)rest, (const int*)hit, (const int*)origin, (const int*)slot,
            X, Y, Z, rx, ry, rz, ys0, Ys, (float*)out);
        return (int)cudaGetLastError();
    }
    if (r == SEPARABLE) {
        const int Ysc = scratch_rows(Y, ry, ys0, Ys), Yw = Ysc - 2 * ry, Zp = Z + 2 * rz;
        const int64_t P0 = (int64_t)(X + 2 * rx) * Ysc * Zp, P1 = (int64_t)X * Ysc * Zp, P2 = (int64_t)X * Yw * Zp;
        float* w1 = (float*)work;
        float* w2 = w1 + 10 * P1;
        const dim3 targets((unsigned)((Ys * Z + THREADS - 1) / THREADS), (unsigned)X);
        if (!work) return (int)cudaErrorInvalidValue;
        BoxPass g{(const float*)sums, (const float*)rest, P0, (int64_t)Ysc * Zp, Zp, w1, P1, (int64_t)Ysc * Zp, Zp,
                  X, Zp, rx, 0, 0};
        if ((rc = launch_pass<0>(g, Ysc, st))) return rc;
        g = BoxPass{w1, w1 + P1, P1, Zp, (int64_t)Ysc * Zp, w2, P2, Zp, (int64_t)Yw * Zp, Yw, Zp, ry, 0, 0};
        if ((rc = launch_pass<1>(g, X, st))) return rc;
        box_pass_z<MASK><<<targets, THREADS, 0, st>>>(w2, P2, (const int*)hit, (const int*)origin,
                                                      (const int*)slot, X, Y, Z, ry, rz, ys0, Ys, (float*)out);
        return (int)cudaGetLastError();
    }
    const dim3 grid((Z + TZ - 1) / TZ, (Ys + TY - 1) / TY, (X + TX - 1) / TX);
    const size_t smem = tiled_smem(rx, ry, rz);
    // past 48 KB with the static arrays the block must opt in; the first
    // call's size is set once, before any graph capture
    static size_t set = 0;
    if (smem > set) {
        cudaFuncAttributes fa;
        cudaError_t e = cudaFuncGetAttributes(&fa, epilogue_kernel<MASK>);
        if (e == cudaSuccess && smem + fa.sharedSizeBytes > 48 * 1024)
            e = cudaFuncSetAttribute(epilogue_kernel<MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        set = smem;
    }
    const bool vec4 = Z % 4 == 0 && (uintptr_t)out % 16 == 0;
    epilogue_kernel<MASK><<<grid, THREADS, smem, st>>>(
        (const float*)sums, (const float*)rest, (const int*)hit, (const int*)origin, (const int*)slot,
        X, Y, Z, rx, ry, rz, ys0, Ys, vec4, (float*)out);
    return (int)cudaGetLastError();
}

}  // namespace

// n at sums, channels 1-9 at rest (the contract above)
extern "C" int gvom_moments_epilogue(
    const void* sums, const void* rest, const void* hit, const void* origin, const void* slot,
    int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys, int mask,
    void* out, void* work, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    return mask ? launch<true>(sums, rest, hit, origin, slot, X, Y, Z, rx, ry, rz, ys0, Ys, out, work, st)
                : launch<false>(sums, rest, hit, origin, slot, X, Y, Z, rx, ry, rz, ys0, Ys, out, work, st);
}

// The floats of workspace that gvom_moments_epilogue needs for this shape:
// the separable passes' W1 and W2, 0 where it takes the tiled kernel or
// the direct one; a negative CUDA error when the device cannot be queried
extern "C" int64_t gvom_moments_epilogue_workspace(int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys,
                                                   int mask)
{
    int rc = 0;
    const Route r = mask ? route<true>(X, Y, rx, ry, rz, ys0, Ys, &rc) : route<false>(X, Y, rx, ry, rz, ys0, Ys, &rc);
    if (rc) return -rc;
    return r == SEPARABLE ? separable_floats(X, Z, ry, rz, scratch_rows(Y, ry, ys0, Ys)) : 0;
}

// Which kernel gvom_moments_epilogue takes for this shape (Route: 0 the
// tiled kernel, 1 the separable passes, 2 the direct kernel), with the
// workspace query's arguments; a negative CUDA error when the device
// cannot be queried
extern "C" int gvom_moments_epilogue_route(int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys, int mask)
{
    int rc = 0;
    const Route r = mask ? route<true>(X, Y, rx, ry, rz, ys0, Ys, &rc) : route<false>(X, Y, rx, ry, rz, ys0, Ys, &rc);
    return rc ? -rc : (int)r;
}
