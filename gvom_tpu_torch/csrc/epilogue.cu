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
// The sums follow K2's contract (binning.cu): channels 1–9 of a source are
// read only where its n > 0, by a branch, never through a multiply by zero,
// since they may hold anything (NaN included) where n is 0.
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

template <bool MASK>
__global__ void __launch_bounds__(THREADS, 4) epilogue_kernel(
    const float* __restrict__ sums,    // [10, Xp, Yp | Ys+4ry, Zp] own-voxel sums, padded window layout
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
    auto source = [&](int ex, int ey) { return sums + ((int64_t)ax.src(ex) * Ysc + ay.src(ey)) * Zp; };

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
            const float* g = source(ex, ey);
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
            const float* g = source(ex, ey);
            for (int ez = lane; ez < lz_len; ez += 32) {
                if (!(w >> ez & 1)) continue;
                const int rank = colbase[c] + __popcll(w & ((1ull << ez) - 1));
                const float* gz = g + az.src(ez);
#pragma unroll
                for (int ch = 0; ch < 9; ++ch) __pipeline_memcpy_async(chan + ch * CAP + rank, gz + (ch + 1) * P, 4);
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
                const float* srow = sums + ((int64_t)(cx + ox) * Ysc + (cy + oy)) * Zp + cz;
                for (; nz; nz &= nz - 1, ++rank) {
                    const int oz = __ffs(nz) - 1 - rz;
                    const float n = nrow[oz];
                    float v[9];
                    if (compact) {
#pragma unroll
                        for (int ch = 0; ch < 9; ++ch) v[ch] = chan[ch * CAP + rank];
                    } else {
#pragma unroll
                        for (int ch = 0; ch < 9; ++ch) v[ch] = srow[oz + (ch + 1) * P];
                    }
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
            }
        }
        const int64_t t = torus_index(lx, ly, lz);
#pragma unroll
        for (int c = 0; c < 10; ++c) o[c * V + t] = acc[c];
    }
}

template <bool MASK>
int launch(const void* sums, const void* hit, const void* origin, const void* slot,
           int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys, void* out, cudaStream_t st)
{
    const dim3 grid((Z + TZ - 1) / TZ, (Ys + TY - 1) / TY, (X + TX - 1) / TX);
    const size_t ncol = (size_t)(TX + 4 * rx) * (TY + 4 * ry);
    // the staged floats (an even count: TZ + 4rz is even), then the columns'
    // 64-bit words and ranks, then the compacted channels
    const size_t smem = sizeof(float) * ncol * (TZ + 4 * rz) + (sizeof(uint64_t) + sizeof(int)) * ncol
                        + sizeof(float) * 9 * CAP;
    if (grid.y > 65535 || grid.z > 65535 || TZ + 4 * rz > 64) return (int)cudaErrorInvalidValue;
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
        (const float*)sums, (const int*)hit, (const int*)origin, (const int*)slot,
        X, Y, Z, rx, ry, rz, ys0, Ys, vec4, (float*)out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gvom_moments_epilogue(
    const void* sums, const void* hit, const void* origin, const void* slot,
    int X, int Y, int Z, int rx, int ry, int rz, int ys0, int Ys, int mask,
    void* out, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    return mask ? launch<true>(sums, hit, origin, slot, X, Y, Z, rx, ry, rz, ys0, Ys, out, st)
                : launch<false>(sums, hit, origin, slot, X, Y, Z, rx, ry, rz, ys0, Ys, out, st);
}
