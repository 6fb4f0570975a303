// Exact Viterbi alignment over incoming-arc tables for Hopper (sm_90a):
// the graphs that do not fit a band.
//
// Replaces khg_tpu/align/pallas_viterbi.py::_viterbi_kernel (called
// through viterbi_align_batch_pallas).  Each state s has M incoming-arc
// slots (source in_src, pdf in_pdf, cost in_cost, transition id
// in_tid; padding slots cost BIG), and one frame of the DP is
//
//   score[m] = (alpha[in_src[s, m]] + in_cost[s, m]) - scale * ll[b, t, in_pdf[s, m]]
//   alpha'   = min(min_m score[m], BIG);  bp = smallest m attaining it
//
// followed by a first-match argmin over alpha + final and a backtrace
// that emits transition ids.
//
// What bounds it on the H100: the serial frame chain (frame t+1 needs
// every alpha of frame t), as for the banded kernel: an utterance's time
// is nf dependent frames, each an exchange through shared memory and a
// barrier, a sweep over M arcs, then an nf-step pointer chase.  The
// bytes (arc tables, the loglike entries read, backpointers) are small.
//
// Design: one block per utterance, threads over states.  The arc
// tables (source, pdf, cost) stay in shared memory for the whole
// utterance and alpha is double-buffered there (one barrier per frame).
// The acoustic term is a direct gather from the frame's loglike row per
// arc (the TPU kernel's one-hot GEMM select, and the state_pdf
// shortcut, are not needed).  int8 backpointers go to a global (B, T, S)
// scratch that one thread reads back for the backtrace.  Frames at or
// past nf are not run: the TPU kernel runs them and keeps alpha, which
// is the same result.  Shared memory: 3 S M + 2 S + 2 nt words (see
// viterbi_smem_bytes; align/viterbi_kernel.py mirrors it).
//
// Bitwise parity with the plain version (align/viterbi_kernel.py, the
// eager DP): the same f32 operations in the same order, written with
// __fadd_rn/__fmul_rn/__fsub_rn so nvcc cannot contract them into an
// FMA; a strict < keeps the first minimal arc and the first minimal end
// state, as torch.min does.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#define KHG_BIG 1.0e30f

namespace {

int block_threads(int S)
{
    int nt = ((S + 31) / 32) * 32;
    return nt > 1024 ? 1024 : nt;
}

size_t viterbi_smem_bytes(int S, int M, int nt)
{
    return (3 * (size_t)S * M + 2 * (size_t)S + 2 * (size_t)nt) * 4;
}

__global__ void viterbi_kernel(
    const int32_t* __restrict__ in_src,      // (B, S, M)
    const int32_t* __restrict__ in_pdf,      // (B, S, M)
    const float* __restrict__ in_cost,       // (B, S, M)
    const int32_t* __restrict__ in_tid,      // (B, S, M)
    const float* __restrict__ init_cost,     // (B, S)
    const float* __restrict__ final_cost,    // (B, S)
    const float* __restrict__ loglikes,      // (B, T, P)
    const int32_t* __restrict__ num_frames,  // (B,)
    int8_t* __restrict__ bp,                 // (B, T, S) scratch
    int32_t* __restrict__ tids,              // (B, T) out
    float* __restrict__ total_cost,          // (B,) out
    int S, int M, int T, int P, float scale)
{
    extern __shared__ float smem[];
    const int SM = S * M;
    float* cost_s = smem;                                    // S*M
    int* src_s = reinterpret_cast<int*>(cost_s + SM);        // S*M
    int* pdf_s = src_s + SM;                                 // S*M
    float* alpha_a = reinterpret_cast<float*>(pdf_s + SM);   // S
    float* alpha_b = alpha_a + S;                            // S
    float* red_v = alpha_b + S;                              // blockDim
    int* red_i = reinterpret_cast<int*>(red_v + blockDim.x); // blockDim

    const int b = blockIdx.x;
    const int tx = threadIdx.x;
    const int nt = blockDim.x;
    int nf = num_frames[b];
    if (nf > T) nf = T;
    if (nf < 0) nf = 0;

    const size_t tab = (size_t)b * SM;
    for (int i = tx; i < SM; i += nt) {
        cost_s[i] = in_cost[tab + i];
        src_s[i] = in_src[tab + i];
        pdf_s[i] = in_pdf[tab + i];
    }
    for (int s = tx; s < S; s += nt) alpha_a[s] = init_cost[(size_t)b * S + s];
    __syncthreads();

    const float* llb = loglikes + (size_t)b * T * P;
    int8_t* bpb = bp + (size_t)b * T * S;
    float* cur = alpha_a;
    float* nxt = alpha_b;
    for (int t = 0; t < nf; ++t) {
        const float* llt = llb + (size_t)t * P;
        for (int s = tx; s < S; s += nt) {
            float best = INFINITY;
            int arg = 0;
            for (int m = 0; m < M; ++m) {
                const int x = s * M + m;
                const float c = __fsub_rn(
                    __fadd_rn(cur[src_s[x]], cost_s[x]),
                    __fmul_rn(scale, llt[pdf_s[x]]));
                if (c < best) {  // strict: the first arc attaining the min
                    best = c;
                    arg = m;
                }
            }
            nxt[s] = fminf(best, KHG_BIG);
            bpb[(size_t)t * S + s] = (int8_t)arg;
        }
        __syncthreads();
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    // first-match argmin of alpha + final over s
    float lbest = INFINITY;
    int larg = S;
    for (int s = tx; s < S; s += nt) {
        const float tot = __fadd_rn(cur[s], final_cost[(size_t)b * S + s]);
        if (tot < lbest) {
            lbest = tot;
            larg = s;
        }
    }
    red_v[tx] = lbest;
    red_i[tx] = larg;
    for (int t = nf + tx; t < T; t += nt) tids[(size_t)b * T + t] = 0;
    __syncthreads();
    if (tx != 0) return;
    float bv = red_v[0];
    int bi = red_i[0];
    for (int i = 1; i < nt; ++i) {
        const float v = red_v[i];
        const int ii = red_i[i];
        if (v < bv || (v == bv && ii < bi)) {
            bv = v;
            bi = ii;
        }
    }
    total_cost[b] = bv;
    int v = bi;
    for (int t = nf - 1; t >= 0; --t) {
        const int x = v * M + bpb[(size_t)t * S + v];
        tids[(size_t)b * T + t] = in_tid[tab + x];
        v = src_s[x];
    }
}

}  // namespace

extern "C" int launch_viterbi(
    const void* in_src, const void* in_pdf, const void* in_cost,
    const void* in_tid, const void* init_cost, const void* final_cost,
    const void* loglikes, const void* num_frames, void* bp, void* tids,
    void* total_cost, int B, int S, int M, int T, int P, float scale,
    void* stream)
{
    const int nt = block_threads(S);
    const size_t smem = viterbi_smem_bytes(S, M, nt);
    if (M >= 128 || smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0 || S == 0) return 0;
    viterbi_kernel<<<B, nt, smem, (cudaStream_t)stream>>>(
        (const int32_t*)in_src, (const int32_t*)in_pdf,
        (const float*)in_cost, (const int32_t*)in_tid,
        (const float*)init_cost, (const float*)final_cost,
        (const float*)loglikes, (const int32_t*)num_frames, (int8_t*)bp,
        (int32_t*)tids, (float*)total_cost, S, M, T, P, scale);
    return (int)cudaGetLastError();
}
