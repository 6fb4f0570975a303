// Wide-model stats fold for Hopper (sm_90a): each frame's aligned graph
// state rescored, its component posteriors, and [occ | post*x |
// post*x^2] folded into per-(utterance, state) accumulators.
//
// Replaces khg_tpu/stats/pallas_fold.py::_fold_kernel (called through
// accumulate_am_stats_fold_pallas).  For utterance b and local state s
// with pdf p = state_pdf[b, s], over the frames t with w[b, t] > 0 and
// pdf_ids[b, t] == p, taking each pdf's FIRST state only (states of one
// pdf share their model rows, so the first one takes all its frames):
//
//   sc[k]       = [x, x^2][t] . [miv, -1/2 iv][p, k] + max(g[p, k], -1e30)
//   lse         = logsumexp_k sc[k];  post[k] = exp(sc[k] - max) / sum * w
//   local[b, s, k, :] += post[k] * [1, x[t], x[t]^2]
//   ll[b, s]    += lse * w;  frames[b, s] += w
//
// The (B, S) -> P scatter runs outside (stats/accum.scatter_local_stats,
// a sorted segment sum), as it runs outside the TPU kernel.
//
// What bounds it on the H100: bytes, barely.  The function moves the
// (P, K, 2D+1) model once in and the (P, K, 2D+1) stats once out (~85 MB
// at P = 2051, K = 32, D = 80) and does ~20k flops per frame (K dots of
// 2D for the scores, K (2D+1) multiply-adds for the fold): ~0.4 GFLOP
// for 64 x 300 frames, ~0.006 ms at the fp32 peak against ~0.025 ms of
// bytes.  The TPU kernel scores ALL S*K rows of every frame and selects
// one state with a one-hot (S times the operations); here a block
// scores only its own state's K rows for its own frames.
//
// Design: one block per (utterance, state); no atomics, so reruns are
// bit-identical.  A block that is not its pdf's first state writes
// zeros.  Otherwise it stages its K model rows [miv | -iv/2 | g] and
// its K x (1+2D) accumulators in shared memory and walks the
// utterance's frames in order, 32 at a time: warp 0 ballots which
// frames are its own and compacts them in time order; the block loads
// their [x, x^2] rows, one thread per (frame, component) computes a
// score, one thread per frame its logsumexp and posteriors, then each
// thread adds the chunk's frames, in time order, into the accumulators
// it owns.  Thread 0 sums ll and frames in the same order.  Shared
// memory: 2 K (2D+1) + CH (2D + K + 3) + 1 floats, CH = 32 (see
// fold_smem_bytes below; stats/fold_kernel.py mirrors it).

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int CH = 32;        // frames per chunk (one warp's ballot)
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) stats_fold_kernel(
    const float* __restrict__ gconsts,    // (P, K)
    const float* __restrict__ miv,        // (P, K, D)
    const float* __restrict__ iv,         // (P, K, D)
    const float* __restrict__ feats,      // (B, T, D)
    const int32_t* __restrict__ pdf_ids,  // (B, T)
    const float* __restrict__ weights,    // (B, T)
    const int32_t* __restrict__ state_pdf,  // (B, S)
    float* __restrict__ local,            // (B, S, K, 1+2D) out
    float* __restrict__ ll_out,           // (B, S) out
    float* __restrict__ frames_out,       // (B, S) out
    int S, int T, int K, int D)
{
    extern __shared__ float smem[];
    const int Q = 2 * D + 1;
    const int D2 = 2 * D;
    float* m_s = smem;                       // K * Q model rows
    float* acc_s = m_s + (size_t)K * Q;      // K * Q accumulators
    float* xs = acc_s + (size_t)K * Q;       // CH * 2D frame rows
    float* sc = xs + CH * D2;                // CH * K scores, then posteriors
    float* ws = sc + CH * K;                 // CH weights
    float* lw = ws + CH;                     // CH lse * w
    int* idx_s = reinterpret_cast<int*>(lw + CH);  // CH frame indices
    int* cnt_s = idx_s + CH;                 // 1

    const int bs = blockIdx.x;
    const int b = bs / S;
    const int s = bs - b * S;
    const int tx = threadIdx.x;
    const int nt = blockDim.x;
    const int32_t* spdf = state_pdf + (size_t)b * S;
    const int pdf = spdf[s];
    float* outp = local + (size_t)bs * K * Q;

    int dup = 0;
    for (int i = tx; i < s; i += nt) dup |= (spdf[i] == pdf);
    if (__syncthreads_or(dup)) {  // not the first state of its pdf
        for (int i = tx; i < K * Q; i += nt) outp[i] = 0.f;
        if (tx == 0) {
            ll_out[bs] = 0.f;
            frames_out[bs] = 0.f;
        }
        return;
    }
    for (int i = tx; i < K * Q; i += nt) {
        const int k = i / Q;
        const int q = i - k * Q;
        const size_t row = (size_t)pdf * K + k;
        float v;
        if (q < D) v = miv[row * D + q];
        else if (q < D2) v = -0.5f * iv[row * D + (q - D)];
        else v = fmaxf(gconsts[row], -1.0e30f);  // -inf padding -> finite
        m_s[i] = v;
        acc_s[i] = 0.f;
    }

    const int32_t* pid = pdf_ids + (size_t)b * T;
    const float* wb = weights + (size_t)b * T;
    const float* fb = feats + (size_t)b * T * D;
    float ll_acc = 0.f;
    float fr_acc = 0.f;
    for (int t0 = 0; t0 < T; t0 += CH) {
        __syncthreads();  // the previous chunk's buffers are free
        if (tx < 32) {
            const int t = t0 + tx;
            const bool hit = t < T && wb[t] > 0.f && pid[t] == pdf;
            const unsigned mask = __ballot_sync(0xffffffffu, hit);
            if (hit) idx_s[__popc(mask & ((1u << tx) - 1u))] = t;
            if (tx == 0) *cnt_s = __popc(mask);
        }
        __syncthreads();
        const int n = *cnt_s;
        if (n == 0) continue;
        for (int i = tx; i < n * D2; i += nt) {
            const int j = i / D2;
            const int q = i - j * D2;
            const float x = fb[(size_t)idx_s[j] * D + (q < D ? q : q - D)];
            xs[i] = q < D ? x : __fmul_rn(x, x);
        }
        for (int j = tx; j < n; j += nt) ws[j] = wb[idx_s[j]];
        __syncthreads();
        for (int i = tx; i < n * K; i += nt) {
            const int j = i / K;
            const int k = i - j * K;
            const float* mr = m_s + (size_t)k * Q;
            const float* xr = xs + j * D2;
            float dot = 0.f;
            for (int q = 0; q < D2; ++q) dot = fmaf(xr[q], mr[q], dot);
            sc[i] = dot + mr[D2];
        }
        __syncthreads();
        for (int j = tx; j < n; j += nt) {
            float* r = sc + j * K;
            float mx = r[0];
            for (int k = 1; k < K; ++k) mx = fmaxf(mx, r[k]);
            float z = 0.f;
            for (int k = 0; k < K; ++k) z += expf(r[k] - mx);
            const float w = ws[j];
            for (int k = 0; k < K; ++k) r[k] = expf(r[k] - mx) / z * w;
            lw[j] = (mx + logf(z)) * w;
        }
        __syncthreads();
        if (tx == 0) {
            for (int j = 0; j < n; ++j) {
                ll_acc += lw[j];
                fr_acc += ws[j];
            }
        }
        for (int e = tx; e < K * Q; e += nt) {
            const int k = e / Q;
            const int q = e - k * Q;
            float a = acc_s[e];
            for (int j = 0; j < n; ++j) {
                const float p = sc[j * K + k];
                a += q == 0 ? p : p * xs[j * D2 + (q - 1)];
            }
            acc_s[e] = a;
        }
    }
    __syncthreads();
    for (int i = tx; i < K * Q; i += nt) outp[i] = acc_s[i];
    if (tx == 0) {
        ll_out[bs] = ll_acc;
        frames_out[bs] = fr_acc;
    }
}

size_t fold_smem_bytes(int K, int D)
{
    const size_t Q = 2 * (size_t)D + 1;
    return (2 * K * Q + CH * (2 * (size_t)D + K + 3) + 1) * 4;
}

}  // namespace

extern "C" int launch_stats_fold(
    const void* gconsts, const void* miv, const void* iv, const void* feats,
    const void* pdf_ids, const void* weights, const void* state_pdf,
    void* local, void* ll_out, void* frames_out,
    int B, int S, int T, int K, int D, void* stream)
{
    const size_t smem = fold_smem_bytes(K, D);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        stats_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0 || S == 0) return 0;
    stats_fold_kernel<<<B * S, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)gconsts, (const float*)miv, (const float*)iv,
        (const float*)feats, (const int32_t*)pdf_ids, (const float*)weights,
        (const int32_t*)state_pdf, (float*)local, (float*)ll_out,
        (float*)frames_out, S, T, K, D);
    return (int)cudaGetLastError();
}
