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
// Compiled path (M = 1..8 arc slots, S <= 512 states), the design of
// the banded kernel's compiled path (banded_viterbi.cu): one block per
// utterance, one thread per state.
// - Each thread holds its M slots (source, cost, pdf) in registers for
//   the whole utterance; M is a template parameter, so no padded slot
//   is swept (a padded slot of cost BIG could win the first-match
//   argmin among unreachable arcs and change a backpointer).
// - The acoustic terms ll[b, t, pdf[m]] are loaded two frames ahead
//   into registers: they do not depend on alpha, so no global latency
//   lies on the frame chain.
// - alpha is double-buffered at fixed shared offsets, the frame loop
//   unrolled by two; one barrier per frame.
// - int8 backpointers are staged in shared memory per chunk of CH
//   frames and written out with 16-byte stores (rows padded to Sp
//   bytes, S rounded up to 16); the last two chunks never leave shared
//   memory.
// - The final argmin is a shuffle tree with ties to the lowest state.
//   In the backtrace thread 0 chases through the staged chunks (a
//   shared read of the backpointer, then of the source table, per
//   frame) while the other warps load the next-earlier chunk back and
//   write the previous chunk's tids.
// Every other shape (M > 8, or S > 512: the HCLG loop states of a dense
// decode) takes the generic kernel: the same DP, one block per
// utterance and threads over states, but the arc tables are read from
// global memory through the read-only path on every frame, alpha is
// double-buffered in shared memory while 2 S floats fit there and in a
// (B, 2, S) global scratch beyond (one barrier per frame orders it
// either way), and the backpointers are int8 for M < 128, int16 for
// M < 32,768 and int32 beyond.  The choice is made from the shape alone
// (viterbi_plan in align/viterbi_kernel.py mirrors it).  Frames at or
// past nf are not run: the TPU kernel runs them and keeps alpha, which
// is the same result.
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

constexpr int FAST_S = khg::FAST_MAX_S;
constexpr int MAX_M = 8;  // arc slots compiled
constexpr int CH = khg::BP_CHUNK;  // frames per backpointer chunk

__host__ __device__ int padded_states(int S) { return (S + 15) / 16 * 16; }

// Dynamic shared memory of a compiled-path block: alpha [2][FAST_S] f32
// at fixed offsets, the staged backpointers [2 * CH][Sp] i8, the source
// table [S][M] i32, the chase's path [2][2][CH] i32 and the argmin
// scratch [2][32].  align/viterbi_kernel.py::viterbi_smem_bytes mirrors
// it.
size_t compiled_smem_bytes(int S, int M) {
    return (size_t)2 * FAST_S * 4 + (size_t)2 * CH * padded_states(S)
           + (size_t)S * M * 4 + 4 * CH * 4 + 64 * 4;
}

template <int M>
__global__ void __launch_bounds__(FAST_S) viterbi_compiled(
    const int32_t* __restrict__ in_src,      // (B, S, M)
    const int32_t* __restrict__ in_pdf,      // (B, S, M)
    const float* __restrict__ in_cost,       // (B, S, M)
    const int32_t* __restrict__ in_tid,      // (B, S, M)
    const float* __restrict__ init_cost,     // (B, S)
    const float* __restrict__ final_cost,    // (B, S)
    const float* __restrict__ loglikes,      // (B, T, P)
    const int32_t* __restrict__ num_frames,  // (B,)
    int8_t* __restrict__ bp,                 // (B, T, Sp) scratch
    int32_t* __restrict__ tids,              // (B, T) out
    float* __restrict__ total_cost,          // (B,) out
    int S, int T, int P, float scale)
{
    extern __shared__ __align__(16) unsigned char smem_fast[];
    const int Sp = padded_states(S);
    float* alpha0 = reinterpret_cast<float*>(smem_fast);          // [FAST_S]
    float* alpha1 = alpha0 + FAST_S;                               // [FAST_S]
    int8_t* stage = reinterpret_cast<int8_t*>(alpha1 + FAST_S);   // [2 * CH][Sp]
    int* srcs = reinterpret_cast<int*>(stage + 2 * CH * Sp);       // [S][M]
    int* path = srcs + S * M;                                      // [2][2][CH]
    float* red_v = reinterpret_cast<float*>(path + 4 * CH);        // [32]
    int* red_i = reinterpret_cast<int*>(red_v + 32);               // [32]

    const int b = blockIdx.x;
    const int tx = threadIdx.x;
    const int nt = blockDim.x;
    const bool live = tx < S;
    const int s = live ? tx : 0;
    int nf = num_frames[b];
    if (nf > T) nf = T;
    if (nf < 0) nf = 0;

    int src[M], pdf[M];
    float cost[M];
    const size_t row = ((size_t)b * S + s) * M;
#pragma unroll
    for (int m = 0; m < M; ++m) {
        src[m] = in_src[row + m];
        pdf[m] = in_pdf[row + m];
        cost[m] = in_cost[row + m];
        if (live) srcs[s * M + m] = src[m];
    }
    const float fin = final_cost[(size_t)b * S + s];
    const float* llb = loglikes + (size_t)b * T * P;
    if (live) alpha0[s] = init_cost[(size_t)b * S + s];
    // the acoustic terms of frames 0 and 1; each frame's registers then
    // take the frame two on
    float ac0[M], ac1[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
        ac0[m] = (live && nf > 0) ? llb[pdf[m]] : 0.f;
        ac1[m] = (live && nf > 1) ? llb[(size_t)P + pdf[m]] : 0.f;
    }
    __syncthreads();

    int8_t* gbp = bp + (size_t)b * T * Sp;
    auto step = [&](int t, const float* cur, float* nxt, float (&acr)[M]) {
        float ac[M];
#pragma unroll
        for (int m = 0; m < M; ++m) ac[m] = acr[m];
        if (live && t + 2 < nf) {
            const float* llr = llb + (size_t)(t + 2) * P;
#pragma unroll
            for (int m = 0; m < M; ++m) acr[m] = llr[pdf[m]];
        }
        float best = INFINITY;
        int arg = 0;
#pragma unroll
        for (int m = 0; m < M; ++m) {
            const float c = __fsub_rn(__fadd_rn(cur[src[m]], cost[m]),
                                      __fmul_rn(scale, ac[m]));
            if (c < best) {  // strict: the first arc attaining the min
                best = c;
                arg = m;
            }
        }
        if (live) {
            nxt[s] = fminf(best, KHG_BIG);
            stage[(t & (2 * CH - 1)) * Sp + s] = (int8_t)arg;
        }
        __syncthreads();
        khg::flush_chunk(t, nf, stage, gbp, Sp);
    };
    int t = 0;
    for (; t + 1 < nf; t += 2) {
        step(t, alpha0, alpha1, ac0);
        step(t + 1, alpha1, alpha0, ac1);
    }
    if (t < nf) step(t, alpha0, alpha1, ac0);
    const float* last = (nf & 1) ? alpha1 : alpha0;

    // first-match argmin of alpha + final over s
    float bv = INFINITY;
    int bi = S;
    if (live) {
        const float tot = __fadd_rn(last[s], fin);
        if (tot < bv) {
            bv = tot;
            bi = s;
        }
    }
    khg::block_argmin(bv, bi, red_v, red_i);
    int32_t* tb = tids + (size_t)b * T;
    for (int i = nf + tx; i < T; i += nt) tb[i] = 0;
    if (tx == 0) total_cost[b] = bv;

    // backtrace: a frame's arc is (state, slot), and the slot's source
    // comes from the shared table
    const int32_t* tidb = in_tid + (size_t)b * S * M;
    khg::backtrace_chunks(
        bi, nf, stage, gbp, Sp, path, tb,
        [&](int v, int m) { return srcs[v * M + m]; },
        [&](int v, int m) { return tidb[v * M + m]; });
}

// The generic kernel: arc tables in global memory, alpha in shared
// memory (ALPHA_SMEM) or in the (B, 2, S) scratch, BP-wide backpointers.
// The arithmetic, the order of the arcs and both argmins are those of
// viterbi_compiled, so the two give the same bits.
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

template <int M>
int launch_compiled(const Args& a, cudaStream_t stream)
{
    const size_t smem = compiled_smem_bytes(a.S, M);
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_compiled<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (a.B == 0 || a.S == 0) return 0;
    viterbi_compiled<M><<<a.B, ((a.S + 31) / 32) * 32, smem, stream>>>(
        (const int32_t*)a.in_src, (const int32_t*)a.in_pdf,
        (const float*)a.in_cost, (const int32_t*)a.in_tid,
        (const float*)a.init_cost, (const float*)a.final_cost,
        (const float*)a.loglikes, (const int32_t*)a.num_frames, (int8_t*)a.bp,
        (int32_t*)a.tids, (float*)a.total_cost, a.S, a.T, a.P, a.scale);
    return (int)cudaGetLastError();
}

}  // namespace

// One entry point for both kernels: the compiled one where M <= 8 and S
// <= 512 (bp a (B, T, Sp) int8 scratch, Sp = S rounded up to 16), the
// generic one otherwise, with int8 / int16 / int32 backpointers for M <
// 128 / M < 32,768 / beyond (bp (B, T, S) of that type); alpha_ws a (B,
// 2, S) float scratch where the generic kernel keeps alpha in global
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
    const Args a{in_src, in_pdf, in_cost, in_tid, init_cost, final_cost,
                 loglikes, num_frames, bp, alpha_ws, tids, total_cost,
                 B, S, M, T, P, scale};
    if (S <= FAST_S && M <= MAX_M) {
        switch (M) {
            case 1: return launch_compiled<1>(a, st);
            case 2: return launch_compiled<2>(a, st);
            case 3: return launch_compiled<3>(a, st);
            case 4: return launch_compiled<4>(a, st);
            case 5: return launch_compiled<5>(a, st);
            case 6: return launch_compiled<6>(a, st);
            case 7: return launch_compiled<7>(a, st);
            case 8: return launch_compiled<8>(a, st);
            default: break;
        }
    }
    if (M < 128) return launch_generic_bp<int8_t>(a, st);
    if (M < 32768) return launch_generic_bp<int16_t>(a, st);
    return launch_generic_bp<int32_t>(a, st);
}
