// Probe of the card's rate of scattered global atomics. Not a kernel of the
// main path: scripts/tree_timing.py times it to give kernels K1 and K2, which are
// bounded by their atomics, a bound in time (atomics needed / this rate).
//
// Each of n_ops atomics adds to its own word of a 2^log2_words buffer: op i
// goes to word (i·2654435761) mod 2^log2_words, a bijection within each run
// of 2^log2_words ops, so the words a warp hits at once are distinct and far
// apart (no contention, no coalescing). In the 16-byte mode an op adds a
// float4 to a group of four words, scattered over the 2^(log2_words − 2)
// groups by the same rule: K2's flush adds channels 1–8 of a voxel so. The
// result is unused, so the adds compile to fire-and-forget reductions, as
// the adds of K1 and K2 do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T one() { return (T)1; }

template <>
__device__ __forceinline__ float4 one<float4>() { return make_float4(1.f, 1.f, 1.f, 1.f); }

template <typename T>
__global__ void atomic_rate_kernel(T* __restrict__ buf, uint32_t mask, int64_t n_ops)
{
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_ops; i += stride) {
        atomicAdd(buf + ((uint32_t)((uint64_t)i * 2654435761ull) & mask), one<T>());
    }
}

}  // namespace

// mode: 0 int32 adds, 1 float32 adds, 2 float4 adds (16 bytes an op)
extern "C" int gvom_atomic_rate(void* buf, int log2_words, long long n_ops, int mode, void* stream)
{
    const uint32_t mask = (1u << log2_words) - 1u;
    const int threads = 256;
    const int blocks = 132 * 8;
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == 2) {
        atomic_rate_kernel<float4><<<blocks, threads, 0, st>>>((float4*)buf, mask >> 2, (int64_t)n_ops);
    } else if (mode == 1) {
        atomic_rate_kernel<float><<<blocks, threads, 0, st>>>((float*)buf, mask, (int64_t)n_ops);
    } else {
        atomic_rate_kernel<int><<<blocks, threads, 0, st>>>((int*)buf, mask, (int64_t)n_ops);
    }
    return (int)cudaGetLastError();
}
