// Shared pieces of the banded Viterbi (banded_viterbi.cu) and banded
// forward-backward (banded_fb.cu) kernels: the bound of their compiled
// paths, asynchronous global -> shared copies for the prefetch rings,
// and the block's first-match argmin.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace khg {

// The compiled paths (a plane count the band menus of align/banded.py
// produce, DK = 16, 20 or 32) run one state per thread: at most 16
// warps, so a thread may hold 128 registers and two blocks of 256
// states share an SM.  Other shapes take the generic kernels.
constexpr int FAST_MAX_S = 512;

// shared memory a block may use (bytes)
constexpr size_t SMEM_LIMIT = 232448;

// 4-byte cp.async global -> shared (through L1)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(gmem) : "memory");
}

// 16-byte cp.async global -> shared, past L1 (rows read once)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// (v, i) replaces (bv, bi) when smaller, ties to the smaller index: a
// total order on distinct indices, so any reduction tree gives the
// serial first-match result
__device__ __forceinline__ void take_min(float& bv, int& bi, float v, int i) {
    if (v < bv || (v == bv && i < bi)) {
        bv = v;
        bi = i;
    }
}

// First-match argmin over the block (blockDim a multiple of 32): each
// thread brings (v, i) and every thread gets the block's result.  red_v
// and red_i hold one entry per warp.
__device__ __forceinline__ void block_argmin(float& v, int& i, float* red_v,
                                             int* red_i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, i, o);
        take_min(v, i, ov, oi);
    }
    if ((threadIdx.x & 31) == 0) {
        red_v[threadIdx.x >> 5] = v;
        red_i[threadIdx.x >> 5] = i;
    }
    __syncthreads();
    v = red_v[0];
    i = red_i[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) take_min(v, i, red_v[w], red_i[w]);
}

}  // namespace khg
