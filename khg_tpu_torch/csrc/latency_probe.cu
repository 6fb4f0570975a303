// Dependent-step latencies on the card, for the serial bounds of the
// banded Viterbi and forward-backward kernels (banded_viterbi.cu,
// banded_fb.cu).  Not a kernel of any path: chip_smoke.py calls it once
// to turn each kernel's dependency chain into a least time.
//
// Whatever their design, both run their frames one after another
// (frame t+1 reads every alpha of frame t, so the states must exchange
// values once per frame); Viterbi's backtrace is a chain of dependent
// reads, and a forward-backward frame adds one expf and one logf to the
// chain.  One block of 256 threads times, on the %globaltimer clock:
//
//   out[0]: `iters` frame steps of the least form: read a neighbour's
//           value from shared memory, add, min, write, block barrier;
//   out[1]: `iters` dependent (add, min) pairs in one thread;
//   out[2]: `iters` dependent shared-memory reads (a pointer chase);
//   out[4]: `iters` dependent precise expf calls in one thread;
//   out[5]: `iters` dependent precise logf calls in one thread.
//
// out[3] keeps the results live.  All times are in nanoseconds.
//
// A second probe, latency_chase_kernel, times a chain of dependent
// global loads (one thread, j = next[j], loads that bypass L1) over a
// table the caller lays out: a small one that stays in the 50 MB L2, or
// a large one spread over device memory.  Its time per load says how
// many frames ahead the kernels must prefetch their per-frame rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

// the clock, read after `dep` is computed and after all memory traffic
// before it (the compiler may move neither across the read)
__device__ __forceinline__ long long global_ns(int dep) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : "r"(dep) : "memory");
    return t;
}

__global__ void __launch_bounds__(NT) latency_probe_kernel(
    const float* __restrict__ in,  // (2 * NT,)
    long long* __restrict__ out,   // (6,)
    int iters)
{
    __shared__ float buf[2][NT];
    __shared__ int chase[NT];
    const int s = threadIdx.x;
    buf[0][s] = in[s];
    buf[1][s] = 0.f;
    chase[s] = (s * 97 + 1) % NT;  // a permutation of [0, NT)
    const float c = in[NT + s];
    __syncthreads();

    const long long t0 = global_ns(0);
    int cur = 0;
    for (int i = 0; i < iters; ++i) {
        buf[cur ^ 1][s] = fminf(buf[cur][(s + 1) % NT] + c, 1.0e30f);
        cur ^= 1;
        __syncthreads();
    }
    const long long t1 = global_ns(cur);
    float x = buf[cur][s];
    for (int i = 0; i < iters; ++i) x = fminf(x + c, 1.0e30f);
    const long long t2 = global_ns(__float_as_int(x));
    int j = s;
    for (int i = 0; i < iters; ++i) j = chase[j];
    const long long t3 = global_ns(j);
    // each chain starts from the clock read before it, so it cannot be
    // scheduled ahead of that read
    float e = (float)(t3 & 1);  // in [0, 1]: expf(-e) stays in [0.36, 1]
    for (int i = 0; i < iters; ++i) e = expf(-e);
    const long long t4 = global_ns(__float_as_int(e));
    float l = e + (float)(t4 & 1);  // in [0, 2]: logf(l + 2) stays in [0.69, 1.4]
    for (int i = 0; i < iters; ++i) l = logf(l + 2.0f);
    const long long t5 = global_ns(__float_as_int(l));
    if (s == 0) {
        out[0] = t1 - t0;
        out[1] = t2 - t1;
        out[2] = t3 - t2;
        out[3] = (long long)__float_as_int(x) + j + __float_as_int(l);
        out[4] = t4 - t3;
        out[5] = t5 - t4;
    }
}

__global__ void latency_chase_kernel(
    const int* __restrict__ next,  // a cycle of indices into itself
    long long* __restrict__ out,   // (2,): ns for `iters` loads, last index
    int iters)
{
    int j = 0;
    const long long t0 = global_ns(0);
    for (int i = 0; i < iters; ++i) j = __ldcg(next + j);
    const long long t1 = global_ns(j);
    out[0] = t1 - t0;
    out[1] = j;
}

}  // namespace

extern "C" int launch_latency_probe(const void* in, void* out, int iters,
                                    void* stream)
{
    latency_probe_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
        (const float*)in, (long long*)out, iters);
    return (int)cudaGetLastError();
}

extern "C" int launch_latency_chase(const void* next, void* out, int iters,
                                    void* stream)
{
    latency_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (const int*)next, (long long*)out, iters);
    return (int)cudaGetLastError();
}
