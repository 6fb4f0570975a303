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
// Every other shape (M >= 128, or tables beyond a block's shared
// memory: S > ~4,000 at M = 4, the HCLG loop states of a dense decode)
// takes the generic kernel: the same DP, one block per utterance and
// threads over states, but the arc tables are read from global memory
// through the read-only path on every frame, alpha is double-buffered
// in shared memory while 2 S floats fit there and in a (B, 2, S) global
// scratch beyond (one barrier per frame orders it either way), and the
// backpointers are int8 for M < 128, int16 for M < 32,768 and int32
// beyond.  The choice is made from the shape alone (viterbi_plan in
// align/viterbi_kernel.py mirrors it).
//
// Bitwise parity with the plain version (align/viterbi_kernel.py, the
// eager DP): the same f32 operations in the same order, written with
// __fadd_rn/__fmul_rn/__fsub_rn so nvcc cannot contract them into an
// FMA; a strict < keeps the first minimal arc and the first minimal end
// state, as torch.min does.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include "banded_common.cuh"

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

// The generic kernel: arc tables in global memory, alpha in shared
// memory (ALPHA_SMEM) or in the (B, 2, S) scratch, BP-wide backpointers.
// The arithmetic, the order of the arcs and both argmins are those of
// viterbi_kernel, so the two give the same bits.
template <typename BP, bool ALPHA_SMEM>
__global__ void viterbi_generic_kernel(
    const int32_t* __restrict__ in_src,      // (B, S, M)
    const int32_t* __restrict__ in_pdf,      // (B, S, M)
    const float* __restrict__ in_cost,       // (B, S, M)
    const int32_t* __restrict__ in_tid,      // (B, S, M)
    const float* __restrict__ init_cost,     // (B, S)
    const float* __restrict__ final_cost,    // (B, S)
    const float* __restrict__ loglikes,      // (B, T, P)
    const int32_t* __restrict__ num_frames,  // (B,)
    BP* __restrict__ bp,                     // (B, T, S) scratch
    float* __restrict__ alpha_ws,            // (B, 2, S) scratch (global alpha)
    int32_t* __restrict__ tids,              // (B, T) out
    float* __restrict__ total_cost,          // (B,) out
    int S, int M, int T, int P, float scale)
{
    extern __shared__ float smem[];
    __shared__ float red_v[32];
    __shared__ int red_i[32];

    const int b = blockIdx.x;
    const int tx = threadIdx.x;
    const int nt = blockDim.x;
    int nf = num_frames[b];
    if (nf > T) nf = T;
    if (nf < 0) nf = 0;

    float* cur = ALPHA_SMEM ? smem : alpha_ws + (size_t)b * 2 * S;
    float* nxt = cur + S;
    const size_t tab = (size_t)b * S * M;
    for (int s = tx; s < S; s += nt) cur[s] = init_cost[(size_t)b * S + s];
    __syncthreads();

    const float* llb = loglikes + (size_t)b * T * P;
    BP* bpb = bp + (size_t)b * T * S;
    for (int t = 0; t < nf; ++t) {
        const float* llt = llb + (size_t)t * P;
        for (int s = tx; s < S; s += nt) {
            const size_t row = tab + (size_t)s * M;
            float best = INFINITY;
            int arg = 0;
            for (int m = 0; m < M; ++m) {
                const int src = __ldg(in_src + row + m);
                const float a = ALPHA_SMEM ? cur[src] : __ldcg(cur + src);
                const float c = __fsub_rn(
                    __fadd_rn(a, __ldg(in_cost + row + m)),
                    __fmul_rn(scale, __ldg(llt + __ldg(in_pdf + row + m))));
                if (c < best) {  // strict: the first arc attaining the min
                    best = c;
                    arg = m;
                }
            }
            nxt[s] = fminf(best, KHG_BIG);
            bpb[(size_t)t * S + s] = (BP)arg;
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
        const float a = ALPHA_SMEM ? cur[s] : __ldcg(cur + s);
        const float tot = __fadd_rn(a, final_cost[(size_t)b * S + s]);
        if (tot < lbest) {
            lbest = tot;
            larg = s;
        }
    }
    for (int t = nf + tx; t < T; t += nt) tids[(size_t)b * T + t] = 0;
    khg::block_argmin(lbest, larg, red_v, red_i);
    if (tx != 0) return;
    total_cost[b] = lbest;
    int v = larg;
    for (int t = nf - 1; t >= 0; --t) {
        const size_t x = tab + (size_t)v * M + bpb[(size_t)t * S + v];
        tids[(size_t)b * T + t] = in_tid[x];
        v = in_src[x];
    }
}

// alpha of the generic kernel stays in shared memory while its two rows
// fit beside the static argmin scratch
bool generic_alpha_in_smem(int S)
{
    return (size_t)8 * S <= khg::SMEM_LIMIT - 256;
}

// a launch_viterbi call's arguments
struct Args {
    const void *in_src, *in_pdf, *in_cost, *in_tid, *init_cost, *final_cost,
        *loglikes, *num_frames;
    void *bp, *alpha_ws, *tids, *total_cost;
    int B, S, M, T, P;
    float scale;
};

template <typename BP, bool ALPHA_SMEM>
int launch_generic(const Args& a, cudaStream_t stream)
{
    const size_t smem = ALPHA_SMEM ? (size_t)8 * a.S : 0;
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_generic_kernel<BP, ALPHA_SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (a.B == 0 || a.S == 0) return 0;
    viterbi_generic_kernel<BP, ALPHA_SMEM><<<a.B, block_threads(a.S), smem, stream>>>(
        (const int32_t*)a.in_src, (const int32_t*)a.in_pdf,
        (const float*)a.in_cost, (const int32_t*)a.in_tid,
        (const float*)a.init_cost, (const float*)a.final_cost,
        (const float*)a.loglikes, (const int32_t*)a.num_frames, (BP*)a.bp,
        (float*)a.alpha_ws, (int32_t*)a.tids, (float*)a.total_cost, a.S, a.M,
        a.T, a.P, a.scale);
    return (int)cudaGetLastError();
}

template <typename BP>
int launch_generic_bp(const Args& a, cudaStream_t stream)
{
    if (generic_alpha_in_smem(a.S)) return launch_generic<BP, true>(a, stream);
    if (a.alpha_ws == nullptr && a.B > 0 && a.S > 0) return (int)cudaErrorInvalidValue;
    return launch_generic<BP, false>(a, stream);
}

}  // namespace

// One entry point for both kernels: the shared-memory kernel where the
// tables fit a block and M < 128 (int8 backpointers), the generic one
// otherwise, with int8 / int16 / int32 backpointers for M < 128 / M <
// 32,768 / beyond.  bp must be (B, T, S) of that type; alpha_ws a (B, 2,
// S) float scratch where the generic kernel keeps alpha in global
// memory (8 S > 232,448 - 256 bytes), else unused.
extern "C" int launch_viterbi(
    const void* in_src, const void* in_pdf, const void* in_cost,
    const void* in_tid, const void* init_cost, const void* final_cost,
    const void* loglikes, const void* num_frames, void* bp, void* alpha_ws,
    void* tids, void* total_cost, int B, int S, int M, int T, int P,
    float scale, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    if (M < 1) return (int)cudaErrorInvalidValue;
    const int nt = block_threads(S);
    const size_t smem = viterbi_smem_bytes(S, M, nt);
    if (M >= 128 || smem > khg::SMEM_LIMIT) {
        const Args a{in_src, in_pdf, in_cost, in_tid, init_cost, final_cost,
                     loglikes, num_frames, bp, alpha_ws, tids, total_cost,
                     B, S, M, T, P, scale};
        if (M < 128) return launch_generic_bp<int8_t>(a, st);
        if (M < 32768) return launch_generic_bp<int16_t>(a, st);
        return launch_generic_bp<int32_t>(a, st);
    }
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0 || S == 0) return 0;
    viterbi_kernel<<<B, nt, smem, st>>>(
        (const int32_t*)in_src, (const int32_t*)in_pdf,
        (const float*)in_cost, (const int32_t*)in_tid,
        (const float*)init_cost, (const float*)final_cost,
        (const float*)loglikes, (const int32_t*)num_frames, (int8_t*)bp,
        (int32_t*)tids, (float*)total_cost, S, M, T, P, scale);
    return (int)cudaGetLastError();
}
