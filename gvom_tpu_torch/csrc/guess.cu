// The guess-height search of the 2-D maps: for each cell with no measured
// height but an inferred one, the spread (max − min) of the nearest measured
// heights found in four wedges within guess_search_radius steps, and the
// inferred height; then, as its epilogue, the maps that need that spread or
// nothing after it: the positive obstacle, the negative obstacle and the
// visibility. One launch.
//
// No TPU kernel: the JAX package computes this in XLA
// (gvom_tpu/ops/maps2d.py:201-282, guess_height_delta), as nearest-known
// scans and R unrolled constant-time steps; that is the reference's per-cell
// search (gvom.py:556-661), which this kernel runs as written. Its plain twin
// is gvom_tpu_torch/ops/maps2d.py::guess_height_plain (with the epilogue,
// guess_products_plain: guess_height_plain, then map_products_plain). At
// step i = 1..R a
// cell (x0, y0) queries four wedges, each for its lowest-index known cell:
//   x_p: row x0+i, columns [max(y0−i, 0), min(y0+i−1, X−1)]
//   x_n: row x0−i, columns [max(y0−i+1, 0), min(y0+i, X−1)]
//   y_p: column y0+i, rows [max(x0−i+1, 0), min(x0+i, X−1)]
//   y_n: column y0−i, rows [max(x0−i, 0), min(x0+i−1, X−1)]
// A wedge latches `done` when its row or column leaves the map or when it
// finds a height, and keeps only the first one. The reference's quirks are
// kept: the search stops once x_n, y_p and y_n are done (x_p_done is never
// tested, gvom.py:581), and y_n's height is merged under x_n's guard
// (gvom.py:655). The only arithmetic is max_h − min_h of two selected
// heights, so the output is bitwise the twin's once the same heights are
// selected; min and max propagate NaN as torch.minimum / torch.maximum do.
//
// The epilogue (no TPU kernel: XLA in the JAX package, gvom_tpu/models/
// pipeline.py:386-389 and :442-458): each block writes its tile's positive
// obstacle, negative obstacle and visibility once the tile's deltas are
// known, the idle blocks that exit early included. A cell reads its slopes
// (window layout, from the plane fit earlier on the stream) at its own index
// and its band sums (torus layout, from K4 or the batched merge) at its
// torus index: the products are elementwise, so reading at the permuted
// index is bitwise the twin's round trip through the torus layout. steep =
// sqrt(fma(sx, sx, sy·sy)) >= threshold (__fsqrt_rn, __fmaf_rn); density =
// num / den (__fdiv_rn) where den > 0; 100·density truncated to an int, as
// the twin's .to(torch.int32) does (the density lies in [0, 1], num <= den);
// negative = delta > threshold; visible = height > unknown. These maps are
// this kernel's epilogue rather than a launch of their own: they need the
// deltas, and nothing after them reads the deltas again.
//
// What bounds it on the H100: bytes. hm and ihm are read once and one map
// written, 12 bytes a cell (0.79 MB at 256×256); the epilogue reads the two
// slopes and the three band words and writes three maps, 32 bytes a cell
// more. A cell whose output is 0
// whatever the search finds (a measured cell, or one with no inferred
// height) does not search. The kernel is far from that bound: at 256×256 it
// is one wave of 256 blocks, and its time is one block's chain of
// dependent steps. Its first version (256 threads a block, a thread
// a cell) staged the tile's R-cell halo, then 92 of its threads each
// scanned a staged row or column backwards for the next-known offsets, 46
// dependent shared-memory steps, whether or not any of its cells searched,
// and each searching thread walked its four wedges in one loop. Now:
//   * the idle test and the staging overlap: each thread loads its cell's
//     hm and ihm while the block's cp.async copies of the region are in
//     flight, and a block none of whose cells searches (__syncthreads_or)
//     writes its zeros and exits without reading the region;
//   * the next-known offsets a warp a staged row or column: a ballot of the
//     known cells a 32-cell word, the words taken from the end, and each
//     lane's offset the first set bit at or after it (__ffs), else the
//     carry from the words after: no dependent chain but the words';
//   * the walks are tasks: the block lists its searching cells and walks
//     each wedge of each as a task of its own, one wedge's tasks after
//     another, on 512 threads, so a warp's lanes run the same query and no
//     lane idles on a cell that does not search; the four wedges of a cell
//     meet in shared memory, where the walk's quirks are applied (below).
// PERF.md §6 has its times beside the first version's (a parent build
// timed in turns, scripts/tree_timing.py). When the region would not fit in the
// shared memory left beside the static arrays (R > 27 on a map wider than
// 71 cells) the blocks walk each wedge cell by cell, reading hm from global
// memory (the map is L2-resident). The launcher chooses by R, so every
// radius the config accepts is right, R = 0 and R >= X included.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;                       // a block's cells per side
constexpr int STAGED_THREADS = 512;            // the staged route's block
// the staged route's dynamic shared memory without an opt-in: 48 KB less its
// static arrays (a cell's four tasks, 8 bytes each, its list entry and the
// group counts)
constexpr int SHARED_MAX = 48 * 1024 - TILE * TILE * (4 * 8 + 2) - TILE * TILE / 32 * 4;

__device__ __forceinline__ float min_nan(float a, float b)
{
    return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b)
{
    return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fmaxf(a, b);
}

// The staged region [r0, r0 + rows) × [c0, c0 + cols) of hm, with each
// row's and each column's next-known offsets: ny[r][c] is the least c' >= c
// whose cell is known (cols if none), nx[r][c] the least r' >= r.
struct Staged {
    const float* h;
    const int16_t *ny, *nx;
    int rows, cols, r0, c0;

    // the first known height of row x, columns [lo, hi] (all inside the region)
    __device__ __forceinline__ bool row(int x, int lo, int hi, float, float* v) const
    {
        const int i = (x - r0) * cols;
        const int c = ny[i + lo - c0];
        if (c > hi - c0) return false;
        *v = h[i + c];
        return true;
    }

    __device__ __forceinline__ bool col(int y, int lo, int hi, float, float* v) const
    {
        const int j = y - c0;
        const int r = nx[(lo - r0) * cols + j];
        if (r > hi - r0) return false;
        *v = h[r * cols + j];
        return true;
    }
};

// hm in global memory, each wedge walked cell by cell
struct Global {
    const float* h;
    int X;

    __device__ __forceinline__ bool row(int x, int lo, int hi, float unknown, float* v) const
    {
        for (int y = lo; y <= hi; ++y) {
            const float a = __ldg(h + (size_t)x * X + y);
            if (a > unknown) {
                *v = a;
                return true;
            }
        }
        return false;
    }

    __device__ __forceinline__ bool col(int y, int lo, int hi, float unknown, float* v) const
    {
        for (int x = lo; x <= hi; ++x) {
            const float a = __ldg(h + (size_t)x * X + y);
            if (a > unknown) {
                *v = a;
                return true;
            }
        }
        return false;
    }
};

// Step i of wedge w (0 x_p, 1 x_n, 2 y_p, 3 y_n) of the cell (x0, y0): true
// when the wedge is done at this step, its row or column outside the map or
// a known height found (then *v holds it).
template <class H>
__device__ __forceinline__ bool wedge_step(const H& h, int w, int i, int x0, int y0, int X, float unknown, float* v)
{
    switch (w) {
    case 0: return x0 + i >= X || h.row(x0 + i, max(y0 - i, 0), min(y0 + i - 1, X - 1), unknown, v);
    case 1: return x0 - i < 0 || h.row(x0 - i, max(y0 - i + 1, 0), min(y0 + i, X - 1), unknown, v);
    case 2: return y0 + i >= X || h.col(y0 + i, max(x0 - i + 1, 0), min(x0 + i, X - 1), unknown, v);
    default: return y0 - i < 0 || h.col(y0 - i, max(x0 - i, 0), min(x0 + i - 1, X - 1), unknown, v);
    }
}

// The guessed delta of a searching cell from its inferred height ih and
// the four wedges' heights hv (unknown where a wedge found none).
__device__ __forceinline__ float guess_delta(float ih, const float (&hv)[4], float unknown)
{
    float min_h = 1000.0f, max_h = ih;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        // y_n is merged under x_n's guard (gvom.py:655)
        if (hv[w == 3 ? 1 : w] > unknown) {
            min_h = min_nan(hv[w], min_h);
            max_h = max_nan(hv[w], max_h);
        }
    }
    const float dh = __fsub_rn(max_h, min_h);
    return dh > 0.0f ? dh : 0.0f;
}

// What the epilogue reads and writes, and its constants
struct Tail {
    const float *sx, *sy;                 // [X, X] window layout
    const int *pnum, *pden, *bok;         // [X, X] torus layout
    const int* origin;                    // [3]
    int* pos;                             // [X, X] window layout
    int* neg;
    int* vis;
    float slope_thr, neg_thr;
};

__device__ __forceinline__ int pmod(int a, int n)
{
    const int r = a % n;
    return r < 0 ? r + n : r;
}

// The maps of the window cell (x, y), i0 its index, from its height hv and
// its delta ghd; (ox, oy) the origin mod X
__device__ __forceinline__ void products(const Tail& T, int X, int ox, int oy, float unknown, int x, int y,
                                         size_t i0, float hv, float ghd)
{
    const int tx = x + ox - (x + ox >= X ? X : 0), ty = y + oy - (y + oy >= X ? X : 0);
    const size_t t = (size_t)tx * X + ty;
    const float a = T.sx[i0], b = T.sy[i0];
    const bool steep = __fsqrt_rn(__fmaf_rn(a, a, __fmul_rn(b, b))) >= T.slope_thr;
    const float num = __int2float_rn(T.pnum[t]), den = __int2float_rn(T.pden[t]);
    const float dens = den > 0.0f ? __fdiv_rn(num, den) : 0.0f;
    const int val = __float2int_rz(__fmul_rn(dens, 100.0f));
    T.pos[i0] = steep ? 100 : (T.bok[t] > 0 ? val : 0);
    T.neg[i0] = ghd > T.neg_thr ? 100 : 0;
    T.vis[i0] = hv > unknown ? 1 : 0;
}

// whether the cell searches: no measured height, an inferred one
__device__ __forceinline__ bool searches(float hv, float ih, float unknown)
{
    return !(hv > unknown) && ih != unknown;
}

// The reference's walk at one searching cell, its four wedges in one loop
// (the global route): the cell's delta
template <class H>
__device__ __forceinline__ float search(const H& h, float ih, int X, int R, float unknown, int x0, int y0)
{
    bool done[4] = {false, false, false, false};
    float hv[4] = {unknown, unknown, unknown, unknown};
    for (int i = 1; i <= R && !(done[1] && done[2] && done[3]); ++i) {
#pragma unroll
        for (int w = 0; w < 4; ++w)
            if (!done[w]) done[w] = wedge_step(h, w, i, x0, y0, X, unknown, &hv[w]);
    }
    return guess_delta(ih, hv, unknown);
}

// One 32-cell word j of a staged line's next-known offsets, by one warp:
// m is the ballot of the word's known cells (bit k: cell 32j + k), carry
// the first known cell after the word (n if none); the lane's cell k gets
// the first set bit at or after it, or the carry. Returns the carry of the
// word before. The words of a line are taken from the end.
__device__ __forceinline__ int word_offsets(unsigned m, int j, int lane, int n, int carry, int16_t* __restrict__ off)
{
    const int k = (j << 5) + lane;
    const unsigned at = m >> lane;
    if (k < n) *off = (int16_t)(at ? k + __ffs(at) - 1 : carry);
    return m ? (j << 5) + __ffs(m) - 1 : carry;
}

// Wedge W of the cell (x0, y0) walked to the step at which it is done:
// that step, with *v the height it found (if it found one), or R + 1
template <int W, class H>
__device__ __forceinline__ int walk(const H& h, int R, int x0, int y0, int X, float unknown, float* v)
{
    for (int i = 1; i <= R; ++i)
        if (wedge_step(h, W, i, x0, y0, X, unknown, v)) return i;
    return R + 1;
}

// The staged route: a block of TILE × TILE cells. After the staging, the
// block lists its searching cells and walks each of their four wedges as
// a task of its own, the tasks of one wedge after another (so a warp's
// lanes run the same query, and no lane idles on a cell that does not
// search). The reference's walk runs all four wedges until x_n, y_p and
// y_n are done (x_p's done flag is never tested, gvom.py:581), so a cell's
// walk ends at the last of those three steps (R if one never is), and
// x_p's height counts only if x_p was done by then.
__global__ void __launch_bounds__(STAGED_THREADS) guess_staged_kernel(
    const float* __restrict__ hm, const float* __restrict__ ihm, int X, int R, float unknown,
    float* __restrict__ out, Tail T)
{
    constexpr int WARPS = STAGED_THREADS / 32, C = TILE * TILE;
    extern __shared__ float stage[];
    __shared__ int firsts[4 * C];           // each task's done step
    __shared__ float heights[4 * C];        // and the height it found
    __shared__ unsigned short list[C];      // the searching cells
    __shared__ int counts[C / 32];          // searching cells of each 32-cell group
    const int tx0 = blockIdx.y * TILE, ty0 = blockIdx.x * TILE;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r0 = max(tx0 - R, 0), c0 = max(ty0 - R, 0);
    const int rows = min(tx0 + TILE - 1 + R, X - 1) - r0 + 1;
    const int cols = min(ty0 + TILE - 1 + R, X - 1) - c0 + 1;
    const int n = rows * cols;
    // threads 0..C-1 hold a cell each: the idle test's loads and the staging
    // copies, all in flight together
    const int x0 = tx0 + tid / TILE, y0 = ty0 + tid % TILE;
    const bool inside = tid < C && x0 < X && y0 < X;
    const size_t i0 = (size_t)x0 * X + y0;
    const float hv = inside ? hm[i0] : unknown, ih = inside ? ihm[i0] : unknown;
    const bool searching = inside && searches(hv, ih, unknown);
    const int ox = pmod(T.origin[0], X), oy = pmod(T.origin[1], X);
    for (int r = warp; r < rows; r += WARPS)
        for (int c = lane; c < cols; c += 32)
            __pipeline_memcpy_async(stage + r * cols + c, hm + (size_t)(r0 + r) * X + c0 + c, 4);
    __pipeline_commit();
    const unsigned group = __ballot_sync(0xffffffffu, searching);
    if (tid < C && lane == 0) counts[warp] = __popc(group);
    const bool any = __syncthreads_or(searching);
    __pipeline_wait_prior(0);
    if (!any) {
        if (inside) {
            out[i0] = 0.0f;
            products(T, X, ox, oy, unknown, x0, y0, i0, hv, 0.0f);
        }
        return;
    }
    __syncthreads();    // every thread's copies have landed
    // the searching cells' list, in cell order
    int pos = 0, count = 0;
#pragma unroll
    for (int g = 0; g < C / 32; ++g) {
        pos += g < warp ? counts[g] : 0;
        count += counts[g];
    }
    pos += __popc(group & ((1u << lane) - 1));
    if (searching) list[pos] = (unsigned short)tid;
    // every staged row's and column's next-known offsets, a warp a line
    int16_t* ny = reinterpret_cast<int16_t*>(stage + n);
    int16_t* nx = ny + n;
    for (int r = warp; r < rows; r += WARPS) {
        int carry = cols;
        for (int j = (cols - 1) >> 5; j >= 0; --j) {
            const int c = (j << 5) + lane;
            const unsigned m = __ballot_sync(0xffffffffu, c < cols && stage[r * cols + c] > unknown);
            carry = word_offsets(m, j, lane, cols, carry, ny + r * cols + c);
        }
    }
    for (int c = warp; c < cols; c += WARPS) {
        int carry = rows;
        for (int j = (rows - 1) >> 5; j >= 0; --j) {
            const int r = (j << 5) + lane;
            const unsigned m = __ballot_sync(0xffffffffu, r < rows && stage[r * cols + c] > unknown);
            carry = word_offsets(m, j, lane, rows, carry, nx + r * cols + c);
        }
    }
    __syncthreads();
    // the tasks: wedge w of the searching cell list[k] is task w·count + k
    const Staged h{stage, ny, nx, rows, cols, r0, c0};
    for (int t = tid; t < 4 * count; t += STAGED_THREADS) {
        const int w = t / count, cell = list[t - w * count];
        const int x = tx0 + cell / TILE, y = ty0 + cell % TILE;
        float v = unknown;
        int first;
        switch (w) {
        case 0: first = walk<0>(h, R, x, y, X, unknown, &v); break;
        case 1: first = walk<1>(h, R, x, y, X, unknown, &v); break;
        case 2: first = walk<2>(h, R, x, y, X, unknown, &v); break;
        default: first = walk<3>(h, R, x, y, X, unknown, &v); break;
        }
        firsts[t] = first;
        heights[t] = v;
    }
    __syncthreads();
    if (!inside) return;
    float ghd = 0.0f;
    if (searching) {
        const int steps = min(R, max(firsts[count + pos], max(firsts[2 * count + pos], firsts[3 * count + pos])));
        float found[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) found[w] = firsts[w * count + pos] <= steps ? heights[w * count + pos] : unknown;
        ghd = guess_delta(ih, found, unknown);
    }
    out[i0] = ghd;
    products(T, X, ox, oy, unknown, x0, y0, i0, hv, ghd);
}

__global__ void __launch_bounds__(TILE * TILE) guess_global_kernel(
    const float* __restrict__ hm, const float* __restrict__ ihm, int X, int R, float unknown,
    float* __restrict__ out, Tail T)
{
    const int x0 = blockIdx.y * TILE + threadIdx.y, y0 = blockIdx.x * TILE + threadIdx.x;
    if (x0 >= X || y0 >= X) return;
    const size_t i0 = (size_t)x0 * X + y0;
    const float hv = hm[i0], ih = ihm[i0];
    // the delta is nonzero only at an unmeasured cell with an inferred height
    const float ghd = searches(hv, ih, unknown) ? search(Global{hm, X}, ih, X, R, unknown, x0, y0) : 0.0f;
    out[i0] = ghd;
    products(T, X, pmod(T.origin[0], X), pmod(T.origin[1], X), unknown, x0, y0, i0, hv, ghd);
}

}  // namespace

// Shared memory that the staged form needs for a map of X×X at radius R:
// the largest tile-plus-halo region clipped to the map. The launcher stages
// when it is at most SHARED_MAX bytes.
static size_t staged_bytes(int X, int R)
{
    const long side = (long)TILE + 2L * R < X ? (long)TILE + 2L * R : X;
    // hm and two 16-bit offsets a cell
    return (size_t)(side * side) * (sizeof(float) + 2 * sizeof(int16_t));
}

// The delta map out and the epilogue's positive, negative and visibility
// maps, each [X, X] window layout, from the window-layout hm, ihm, slope_x
// and slope_y, the torus-layout band sums pnum, pden and band_ok, and the
// origin [3]
extern "C" int gvom_guess_height(const void* hm, const void* ihm, const void* sx, const void* sy, const void* pnum,
                                 const void* pden, const void* bok, const void* origin, int X, int R, float unknown,
                                 float slope_thr, float neg_thr, void* out, void* pos, void* neg, void* vis,
                                 void* stream)
{
    const Tail T{(const float*)sx, (const float*)sy, (const int*)pnum, (const int*)pden, (const int*)bok,
                 (const int*)origin, (int*)pos, (int*)neg, (int*)vis, slope_thr, neg_thr};
    const dim3 block(TILE, TILE), grid((X + TILE - 1) / TILE, (X + TILE - 1) / TILE);
    const size_t bytes = staged_bytes(X, R);
    if (bytes <= SHARED_MAX)
        guess_staged_kernel<<<grid, STAGED_THREADS, bytes, (cudaStream_t)stream>>>(
            (const float*)hm, (const float*)ihm, X, R, unknown, (float*)out, T);
    else
        guess_global_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const float*)hm, (const float*)ihm, X, R, unknown, (float*)out, T);
    return (int)cudaGetLastError();
}

// 1 when gvom_guess_height stages hm in shared memory for this X and R
extern "C" int gvom_guess_height_staged(int X, int R) { return staged_bytes(X, R) <= SHARED_MAX; }
