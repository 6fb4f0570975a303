// Shared pieces of the banded Viterbi (banded_viterbi.cu), banded
// forward-backward (banded_fb.cu) and incoming-arc Viterbi (viterbi.cu)
// kernels: the bound of their compiled paths, asynchronous global ->
// shared copies for the prefetch rings, the block's first-match argmin,
// and the compiled Viterbi paths' backpointer chunks and backtrace.

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

// The compiled Viterbi paths stage int8 backpointers in shared memory,
// [2 * BP_CHUNK][Sp] (a row of Sp bytes a frame, Sp a multiple of 16),
// and write each finished chunk of BP_CHUNK frames out to a (T, Sp)
// global scratch with 16-byte stores, except the last two, which never
// leave shared memory.
constexpr int BP_CHUNK = 32;

// After frame t's barrier, of nf frames: chunk t / BP_CHUNK goes out
// once complete, unless it is one of the last two.
__device__ __forceinline__ void flush_chunk(int t, int nf, const int8_t* stage,
                                            int8_t* gbp, int Sp) {
    const int K = (nf + BP_CHUNK - 1) / BP_CHUNK;
    const int k = t / BP_CHUNK;
    if (t % BP_CHUNK == BP_CHUNK - 1 && k < K - 2) {
        const uint4* from = reinterpret_cast<const uint4*>(stage + (k & 1) * BP_CHUNK * Sp);
        uint4* to = reinterpret_cast<uint4*>(gbp + (size_t)k * BP_CHUNK * Sp);
        for (int i = threadIdx.x; i < BP_CHUNK * Sp / 16; i += blockDim.x) to[i] = from[i];
    }
}

// The backtrace from end state v over nf frames, chunk by chunk from the
// last; path [2][2][BP_CHUNK] holds a chunk's states and backpointers.
// Thread 0 chases through the staged chunk: at frame tt, state v and its
// backpointer p; back(v, p) is the state a frame earlier.  Meanwhile the
// threads from the second warp on (all but thread 0 in a one-warp block)
// write the later chunk's tids, tid(v, p) into tb, and load the
// next-earlier chunk back from gbp into the half that chunk held.
template <typename Back, typename Tid>
__device__ __forceinline__ void backtrace_chunks(int v, int nf, int8_t* stage,
                                                 const int8_t* gbp, int Sp, int* path,
                                                 int32_t* tb, Back back, Tid tid) {
    const int tx = threadIdx.x;
    const int nt = blockDim.x;
    const int K = (nf + BP_CHUNK - 1) / BP_CHUNK;
    auto write_tids = [&](int k, int from, int by) {
        const int lo = k * BP_CHUNK;
        const int n = min(nf - lo, BP_CHUNK);
        const int* pk = path + (k & 1) * 2 * BP_CHUNK;
        for (int i = from; i < n; i += by) tb[lo + i] = tid(pk[i], pk[BP_CHUNK + i]);
    };
    const int h0 = nt > 32 ? 32 : 1;  // the first thread that does not chase
    for (int k = K - 1; k >= 0; --k) {
        if (tx == 0) {
            const int lo = k * BP_CHUNK;
            int* pk = path + (k & 1) * 2 * BP_CHUNK;
            for (int tt = min(nf, lo + BP_CHUNK) - 1; tt >= lo; --tt) {
                const int p = stage[(tt & (2 * BP_CHUNK - 1)) * Sp + v];
                pk[tt - lo] = v;
                pk[BP_CHUNK + tt - lo] = p;
                v = back(v, p);
            }
        } else if (tx >= h0) {
            if (k + 1 < K) write_tids(k + 1, tx - h0, nt - h0);
            // chunk k - 1 into the half chunk k + 1 held, unless resident
            if (k >= 1 && k - 1 < K - 2) {
                const uint4* from = reinterpret_cast<const uint4*>(gbp + (size_t)(k - 1) * BP_CHUNK * Sp);
                uint4* to = reinterpret_cast<uint4*>(stage + ((k - 1) & 1) * BP_CHUNK * Sp);
                for (int i = tx - h0; i < BP_CHUNK * Sp / 16; i += nt - h0) to[i] = from[i];
            }
        }
        __syncthreads();
    }
    if (K > 0) write_tids(0, tx, nt);
}

}  // namespace khg
