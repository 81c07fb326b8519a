// Point preparation of S scans in one launch: the sensor→world transform, the
// min-distance filter, the grid origin and each scan's scan_ok.
//
// No TPU kernel: the JAX package computes this in XLA, inside the jit of its
// kernels: gvom_tpu/ops/binning.py:47-69 (prepare_points),
// gvom_tpu/models/pipeline.py:209-213 (the origin and scan_ok of an ingest)
// and gvom_tpu/parallel/sharding.py:193-202 (the batched step's dead scans).
// The plain twin is gvom_tpu_torch/ops/binning.py::prepare_plain, which the
// CPU tests hold bitwise against those JAX functions.
//
// The contract is bitwise, so every rounding of the JAX package's compiled
// arithmetic is written out (and the library is built with -fmad=false):
//   * the transform, row r of R: fma(p2, r2, fma(p1, r1, p0·r0)), then + t
//     (XLA:CPU's dot of [N,3] by [3,3]);
//   * the squared distance fma(v2, v2, fma(v1, v1, v0·v0)) with v = p, or
//     v = p − ego under ego_relative_min_distance; keep = valid and
//     d2 >= fl(min_distance)²;
//   * the origin floor(fma(ego, 1/res, −size/2)) of the frame's ego, unless
//     the caller pins it;
//   * vox = floor(fma(p, 1/res, −origin)); scan_ok[s] = any(keep and vox in
//     the grid). Float to int conversion saturates and NaN gives 0, as XLA
//     converts. A point that is not kept never reaches scan_ok.
//
// What bounds it on the H100: bytes. About 16 f32 operations a point (28 with
// a transform) against 14 bytes (the point read, valid read, keep written;
// with a transform the world point is written too, 26 bytes): 4.19 M points
// are 0.018 ms at 3.35 TB/s and 0.001 ms of f32 arithmetic. Without a
// transform the world point is the input itself and is not written.
//
// The design (one launch a call, no memset, no second kernel):
//   * groups of four points: three 16-byte loads of a group's 48 contiguous
//     bytes, one 32-bit load of its valid bytes and one 32-bit store of its
//     keep bytes (and three 16-byte stores of the world points with a
//     transform); a thread takes two groups a step and issues both groups'
//     loads before it computes either, so that twice the bytes are in flight
//     (timed against one group a step as a variant build in turns,
//     scripts/tree_timing.py, PERF.md §6);
//     A scan whose rows are not so aligned (n % 4 != 0 puts every other
//     scan's rows off the 16-byte grid), and the last n % 4 points of every
//     scan, take the scalar path, one point a thread;
//   * a grid of (blocks a scan, S) whose blocks stride over their scan's
//     points, 2048 threads an SM over the card's SMs (gvom_prepare_points);
//   * the origin computed once a block, into shared memory;
//   * scan_ok by a last-block reduction: each block adds one ticket to its
//     scan's word, 1 + 2^16 if one of its points is kept inside the window
//     and 1 if none is, so one atomic returns both counts; the block whose
//     ticket completes the count stores scan_ok[s] (a plain byte store, so
//     the bool array needs no zeroing), resets the word for the next call
//     and hands the verdict to its block through shared memory. The word a
//     scan lives in a workspace that the wrapper zeroes once, when it
//     allocates it, one workspace a stream, so that calls on two streams
//     never share one;
//   * the dead-scan mask (drop_dead, the batched step): the last block of a
//     dead scan zeroes its keep row. Every thread fences its keep stores
//     before its block takes the ticket, and the last block fences before
//     its zeros, so the zeros land last. A live scan pays nothing for it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int STEP = 2;                          // groups of four points a thread a step
// blocks a scan: as many as 2048 threads an SM would hold, though ptxas's
// register count lets half of them be resident (two waves)
constexpr int BLOCKS_PER_SM = 2048 / THREADS;
constexpr unsigned LIVE = 1u << 16;              // a ticket's live count unit; a scan takes fewer blocks

__device__ __forceinline__ int floor_i32(float x) {
    const float f = floorf(x);
    if (f != f) return 0;
    if (f >= 2147483648.0f) return INT_MAX;
    if (f < -2147483648.0f) return INT_MIN;
    return (int)f;
}

struct Params {
    const float* transform;     // [4, 4] row-major, or null
    float inv[3];
    float md2;
    int ego_relative;
    int size[3];
};

// One point: p (in place: the world point with a transform), its keep, and
// whether it is kept inside the window at origin o
__device__ __forceinline__ bool prepare_one(const Params& P, const float (&T)[12], const float (&ego)[3],
                                            const int (&o)[3], bool valid, float (&p)[3], bool* ok)
{
    if (P.transform) {
        float q[3];
#pragma unroll
        for (int r = 0; r < 3; ++r)
            q[r] = __fadd_rn(__fmaf_rn(p[2], T[4 * r + 2], __fmaf_rn(p[1], T[4 * r + 1], __fmul_rn(p[0], T[4 * r]))),
                             T[4 * r + 3]);
#pragma unroll
        for (int a = 0; a < 3; ++a) p[a] = q[a];
    }
    float v[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) v[a] = P.ego_relative ? __fsub_rn(p[a], ego[a]) : p[a];
    const float d2 = __fmaf_rn(v[2], v[2], __fmaf_rn(v[1], v[1], __fmul_rn(v[0], v[0])));
    const bool kp = valid && d2 >= P.md2;
    if (kp) {
        bool in = true;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const int vox = floor_i32(__fmaf_rn(p[a], P.inv[a], -(float)o[a]));
            in = in && vox >= 0 && vox < P.size[a];
        }
        *ok = *ok || in;
    }
    return kp;
}

__global__ void __launch_bounds__(THREADS) prepare_kernel(
    const float* __restrict__ points,      // [S, n, 3]
    const uint8_t* __restrict__ valid,     // [S, n]
    const float* __restrict__ egos,        // [S, 3]
    const float* __restrict__ frame_ego,   // [3], or null when the origin is pinned
    const int* __restrict__ origin_in,     // [3], or null
    Params P, int n, int drop_dead,
    float* __restrict__ p_out,             // [S, n, 3]; written only with a transform
    uint8_t* __restrict__ keep,            // [S, n]
    int* __restrict__ origin_out,          // [3]
    uint8_t* __restrict__ scan_ok,         // [S] bool
    unsigned* __restrict__ work)           // [S]: each scan's tickets; zero between calls
{
    __shared__ int so[3];
    __shared__ int verdict;     // -1 but in the scan's last block to arrive; there whether the scan is live
    const int s = blockIdx.y, tid = threadIdx.x;
    if (tid < 3)
        so[tid] = origin_in ? origin_in[tid]
                            : floor_i32(__fmaf_rn(frame_ego[tid], P.inv[tid], -0.5f * (float)P.size[tid]));
    __syncthreads();
    const int o[3] = {so[0], so[1], so[2]};
    if (blockIdx.x == 0 && s == 0 && tid < 3) origin_out[tid] = o[tid];
    const float ego[3] = {egos[3 * s], egos[3 * s + 1], egos[3 * s + 2]};
    float T[12];     // the transform's first three rows, in registers
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = P.transform ? __ldg(P.transform + k) : 0.0f;

    const int64_t base = (int64_t)s * n;
    const float* pts = points + 3 * base;
    const uint8_t* val = valid + base;
    uint8_t* kp = keep + base;
    float* pw = p_out ? p_out + 3 * base : nullptr;
    const bool vec = ((uintptr_t)pts & 15) == 0 && ((uintptr_t)val & 3) == 0 && ((uintptr_t)kp & 3) == 0
                     && ((uintptr_t)pw & 15) == 0;
    const int groups = vec ? n / 4 : 0;
    const int stride = gridDim.x * THREADS;
    bool ok = false;
    // STEP groups a thread a step, their loads issued together
    for (int g0 = blockIdx.x * THREADS + tid; g0 < groups; g0 += STEP * stride) {
        float4 a[STEP], b[STEP], c[STEP];
        uint32_t vv[STEP];
#pragma unroll
        for (int u = 0; u < STEP; ++u) {
            const int g = g0 + u * stride;
            if (g < groups) {
                const float4* src = reinterpret_cast<const float4*>(pts) + 3 * g;
                a[u] = __ldg(src);
                b[u] = __ldg(src + 1);
                c[u] = __ldg(src + 2);
                vv[u] = __ldg(reinterpret_cast<const uint32_t*>(val) + g);
            }
        }
#pragma unroll
        for (int u = 0; u < STEP; ++u) {
            const int g = g0 + u * stride;
            if (g >= groups) continue;
            float q[12] = {a[u].x, a[u].y, a[u].z, a[u].w, b[u].x, b[u].y, b[u].z, b[u].w,
                           c[u].x, c[u].y, c[u].z, c[u].w};
            uint32_t kk = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float p[3] = {q[3 * j], q[3 * j + 1], q[3 * j + 2]};
                if (prepare_one(P, T, ego, o, ((vv[u] >> (8 * j)) & 0xFFu) != 0, p, &ok)) kk |= 1u << (8 * j);
#pragma unroll
                for (int a3 = 0; a3 < 3; ++a3) q[3 * j + a3] = p[a3];
            }
            reinterpret_cast<uint32_t*>(kp)[g] = kk;
            if (pw) {
                float4* dst = reinterpret_cast<float4*>(pw) + 3 * g;
                dst[0] = make_float4(q[0], q[1], q[2], q[3]);
                dst[1] = make_float4(q[4], q[5], q[6], q[7]);
                dst[2] = make_float4(q[8], q[9], q[10], q[11]);
            }
        }
    }
    // the scalar path: the points after the last whole group
    for (int i = 4 * groups + blockIdx.x * THREADS + tid; i < n; i += stride) {
        float p[3] = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
        kp[i] = prepare_one(P, T, ego, o, val[i] != 0, p, &ok);
        if (pw) {
#pragma unroll
            for (int a3 = 0; a3 < 3; ++a3) pw[3 * i + a3] = p[a3];
        }
    }

    // ---- scan_ok: one ticket a block, the scan's last block to arrive reads the verdict ----
    if (drop_dead) __threadfence();       // this thread's keep stores, before the ticket
    const bool any = __syncthreads_or(ok);
    if (tid == 0) {
        // the ticket counts the blocks in its low bits and the blocks with a kept point in the window above
        const unsigned mine = 1u + (any ? LIVE : 0u);
        const unsigned all = atomicAdd(work + s, mine) + mine;
        verdict = -1;
        if ((all & (LIVE - 1)) == gridDim.x) {
            verdict = all >= LIVE;
            scan_ok[s] = verdict;
            work[s] = 0;                  // for the stream's next call
        }
    }
    __syncthreads();
    if (drop_dead && verdict == 0) {
        __threadfence();                  // after the other blocks' keep stores
        for (int i = tid; i < n; i += THREADS) kp[i] = 0;
    }
}

int multiprocessors()
{
    static int count[64] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
    if (count[dev] == 0 && cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 132;
    return count[dev];
}

}  // namespace

// The preparation of S scans of n points on `stream`, with drop_dead the
// dead-scan mask too, in one launch. scan_ok is a bool array of S bytes;
// work is the stream's workspace of S 32-bit words, zero between calls.
extern "C" int gvom_prepare_points(
    const void* points, const void* valid, const void* egos, const void* frame_ego, const void* origin_in,
    const void* transform, float inv_xy, float inv_z, float md2, int ego_relative,
    int S, int n, int X, int Y, int Z, int drop_dead,
    void* p_out, void* keep, void* origin_out, void* scan_ok, void* work, void* stream)
{
    if (S < 1 || S > 65535 || n < 0 || (transform && !p_out) || (!frame_ego == !origin_in))
        return (int)cudaErrorInvalidValue;
    Params P;
    P.transform = (const float*)transform;
    P.inv[0] = inv_xy;
    P.inv[1] = inv_xy;
    P.inv[2] = inv_z;
    P.md2 = md2;
    P.ego_relative = ego_relative;
    P.size[0] = X;
    P.size[1] = Y;
    P.size[2] = Z;
    // blocks a scan: BLOCKS_PER_SM over the card's SMs, at most one a 4·THREADS points
    const int want = (multiprocessors() * BLOCKS_PER_SM + S - 1) / S;
    const int most = (n + 4 * THREADS - 1) / (4 * THREADS);
    int per_scan = want < most ? want : (most > 0 ? most : 1);
    per_scan = per_scan < (int)LIVE - 1 ? per_scan : (int)LIVE - 1;
    const dim3 grid((unsigned)(per_scan > 0 ? per_scan : 1), (unsigned)S);
    prepare_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)points, (const uint8_t*)valid, (const float*)egos, (const float*)frame_ego,
        (const int*)origin_in, P, n, drop_dead, (float*)p_out, (uint8_t*)keep, (int*)origin_out,
        (uint8_t*)scan_ok, (unsigned*)work);
    return (int)cudaGetLastError();
}
