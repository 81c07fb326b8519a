// The guess-height search of the 2-D maps: for each cell with no measured
// height but an inferred one, the spread (max − min) of the nearest measured
// heights found in four wedges within guess_search_radius steps, and the
// inferred height. One launch, one thread a map cell.
//
// No TPU kernel: the JAX package computes this in XLA
// (gvom_tpu/ops/maps2d.py:201-282, guess_height_delta), as nearest-known
// scans and R unrolled constant-time steps; that is the reference's per-cell
// search (gvom.py:556-661), which this kernel runs as written. Its plain twin
// is gvom_tpu_torch/ops/maps2d.py::guess_height_plain. At step i = 1..R a
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
// What bounds it on the H100: bytes. hm and ihm are read once and one map
// written, 12 bytes a cell (0.79 MB at 256×256). A cell whose output is 0
// whatever the search finds (a measured cell, or one with no inferred
// height) does not search. Design: a block stages its 16×16 tile and an
// R-cell halo of hm (clipped to the map) in shared memory, and with it, for
// every staged row and column, the offset of the next known cell at or
// after each position (one thread a row or a column scans it backwards, as
// the twin's flip-cummin-flip). A wedge query is then two shared loads:
// the next known cell at or after the wedge's first cell, taken if it lies
// before the wedge's end. A wedge lies inside the staged region, so the
// offsets never need the map beyond it. When the region would not fit in
// 48 KB (R > 31 on a map wider than 78 cells) the blocks walk each wedge
// cell by cell, reading hm from global memory (the map is L2-resident). The
// launcher chooses by R, so every radius the config accepts is right, R = 0
// and R >= X included.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;                       // a block's cells per side, one thread each
constexpr int SHARED_MAX = 48 * 1024;          // dynamic shared memory without an opt-in
constexpr int STAGED_BYTES = 8;                // a staged cell: hm, and two 16-bit next-known offsets

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

    __device__ __forceinline__ float at(int x, int y) const { return h[(x - r0) * cols + (y - c0)]; }
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

    __device__ __forceinline__ float at(int x, int y) const { return __ldg(h + (size_t)x * X + y); }
};

template <class H>
__device__ __forceinline__ void search(const H& h, const float* __restrict__ ihm, int X, int R, float unknown,
                                       int x0, int y0, float* __restrict__ out)
{
    const size_t i0 = (size_t)x0 * X + y0;
    const float ih = ihm[i0];
    // the output is dh only at an unmeasured cell with an inferred height
    if (h.at(x0, y0) > unknown || ih == unknown) {
        out[i0] = 0.0f;
        return;
    }
    bool xp_done = false, xn_done = false, yp_done = false, yn_done = false;
    float hxp = unknown, hxn = unknown, hyp = unknown, hyn = unknown;
    for (int i = 1; i <= R && !(xn_done && yp_done && yn_done); ++i) {
        if (!xp_done)
            xp_done = x0 + i >= X || h.row(x0 + i, max(y0 - i, 0), min(y0 + i - 1, X - 1), unknown, &hxp);
        if (!xn_done)
            xn_done = x0 - i < 0 || h.row(x0 - i, max(y0 - i + 1, 0), min(y0 + i, X - 1), unknown, &hxn);
        if (!yp_done)
            yp_done = y0 + i >= X || h.col(y0 + i, max(x0 - i + 1, 0), min(x0 + i, X - 1), unknown, &hyp);
        if (!yn_done)
            yn_done = y0 - i < 0 || h.col(y0 - i, max(x0 - i, 0), min(x0 + i - 1, X - 1), unknown, &hyn);
    }

    float min_h = 1000.0f, max_h = ih;
    if (hxp > unknown) {
        min_h = min_nan(hxp, min_h);
        max_h = max_nan(hxp, max_h);
    }
    if (hxn > unknown) {
        min_h = min_nan(hxn, min_h);
        max_h = max_nan(hxn, max_h);
    }
    if (hyp > unknown) {
        min_h = min_nan(hyp, min_h);
        max_h = max_nan(hyp, max_h);
    }
    if (hxn > unknown) {   // y_n under x_n's guard (gvom.py:655)
        min_h = min_nan(hyn, min_h);
        max_h = max_nan(hyn, max_h);
    }
    const float dh = __fsub_rn(max_h, min_h);
    out[i0] = dh > 0.0f ? dh : 0.0f;
}

__global__ void __launch_bounds__(TILE * TILE) guess_staged_kernel(
    const float* __restrict__ hm, const float* __restrict__ ihm, int X, int R, float unknown,
    float* __restrict__ out)
{
    extern __shared__ float stage[];
    const int tx0 = blockIdx.y * TILE, ty0 = blockIdx.x * TILE;
    const int r0 = max(tx0 - R, 0), c0 = max(ty0 - R, 0);
    const int rows = min(tx0 + TILE - 1 + R, X - 1) - r0 + 1;
    const int cols = min(ty0 + TILE - 1 + R, X - 1) - c0 + 1;
    const int n = rows * cols;
    const int tid = threadIdx.y * TILE + threadIdx.x;
    int16_t* ny = reinterpret_cast<int16_t*>(stage + n);
    int16_t* nx = ny + n;
    for (int t = tid; t < n; t += TILE * TILE)
        stage[t] = hm[(size_t)(r0 + t / cols) * X + c0 + t % cols];
    __syncthreads();
    // one thread a staged row (then a staged column): the next known offset, backwards
    for (int t = tid; t < rows + cols; t += TILE * TILE) {
        if (t < rows) {
            int next = cols;
            for (int c = cols - 1; c >= 0; --c) {
                if (stage[t * cols + c] > unknown) next = c;
                ny[t * cols + c] = (int16_t)next;
            }
        } else {
            const int c = t - rows;
            int next = rows;
            for (int r = rows - 1; r >= 0; --r) {
                if (stage[r * cols + c] > unknown) next = r;
                nx[r * cols + c] = (int16_t)next;
            }
        }
    }
    __syncthreads();
    const int x0 = tx0 + threadIdx.y, y0 = ty0 + threadIdx.x;
    if (x0 < X && y0 < X) search(Staged{stage, ny, nx, rows, cols, r0, c0}, ihm, X, R, unknown, x0, y0, out);
}

__global__ void __launch_bounds__(TILE * TILE) guess_global_kernel(
    const float* __restrict__ hm, const float* __restrict__ ihm, int X, int R, float unknown,
    float* __restrict__ out)
{
    const int x0 = blockIdx.y * TILE + threadIdx.y, y0 = blockIdx.x * TILE + threadIdx.x;
    if (x0 < X && y0 < X) search(Global{hm, X}, ihm, X, R, unknown, x0, y0, out);
}

}  // namespace

// Shared memory that the staged form needs for a map of X×X at radius R:
// the largest tile-plus-halo region clipped to the map. The launcher stages
// when it is at most SHARED_MAX bytes.
static size_t staged_bytes(int X, int R)
{
    const long side = (long)TILE + 2L * R < X ? (long)TILE + 2L * R : X;
    return (size_t)(side * side) * STAGED_BYTES;
}

extern "C" int gvom_guess_height(const void* hm, const void* ihm, int X, int R, float unknown, void* out,
                                 void* stream)
{
    const dim3 block(TILE, TILE), grid((X + TILE - 1) / TILE, (X + TILE - 1) / TILE);
    const size_t bytes = staged_bytes(X, R);
    if (bytes <= SHARED_MAX)
        guess_staged_kernel<<<grid, block, bytes, (cudaStream_t)stream>>>(
            (const float*)hm, (const float*)ihm, X, R, unknown, (float*)out);
    else
        guess_global_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const float*)hm, (const float*)ihm, X, R, unknown, (float*)out);
    return (int)cudaGetLastError();
}

// 1 when gvom_guess_height stages hm in shared memory for this X and R
extern "C" int gvom_guess_height_staged(int X, int R) { return staged_bytes(X, R) <= SHARED_MAX; }
