// Banded (offset-plane) Viterbi alignment for Hopper (sm_90a).
//
// Replaces khg_tpu/align/pallas_banded.py::_banded_kernel (called
// through viterbi_align_banded).  After SCC-topological renumbering
// every arc into state s comes from s - off[p] for a small static set
// of plane offsets, so one frame of the DP is
//
//   cand[p]  = alpha[(s - off[p]) mod S] + plane_cost[p][s]
//   best     = min_p cand[p];  bp = smallest p attaining best
//   alpha'   = min(best - scale * ll[b, t, pdf(s)], BIG)
//
// followed by a first-match argmin over the final costs and a
// backtrace that emits transition ids.  The external-acoustic (sac)
// mode is the same kernel on a (B, T, S) lattice with an identity
// state_pdf.
//
// What bounds it on the H100: the frame recursion is serial (frame t+1
// needs every alpha of frame t), so an utterance's time is nf frames of
// a dependent plane sweep plus an nf-step pointer chase; the bytes
// (plane tables, loglikes, backpointers) are small next to that.  With
// two utterances per SM, a frame's instructions across the SM's 16
// warps are the limit, so nothing that is fixed for the utterance (a
// plane's offset, cost or wrapped source index) is re-read per frame.
//
// Compiled path (DK = 16, 20 or 32 planes, S <= 512 states): one block
// per utterance, one thread per state.
// - Each thread holds its DK plane costs and source indices
//   (s - off[p]) mod S in registers for the whole utterance.  A frame is
//   DK shared reads and adds and a first-match min (strict `<` in plane
//   order; a min tree measured slower).
// - alpha is double-buffered at fixed shared offsets and the frame loop
//   is unrolled by two, so each read is a register plus an immediate;
//   one barrier per frame.
// - The acoustic term ll[b, t, pdf(s)] (a lattice row in sac mode) is
//   loaded two frames ahead into registers, so no global latency lies
//   on the frame chain (a cp.async ring in shared memory cost a third
//   of the frame loop, tools/kernel_split.py).
// - Backpointers are staged in shared memory per chunk of CH frames and
//   written out with 16-byte stores (rows padded to Sp bytes, S rounded
//   up to 16); the last two chunks never leave shared memory.
// - The final argmin is a shuffle tree that breaks ties to the lowest
//   state.  In the backtrace thread 0 chases through the staged chunks
//   (a shared read of the backpointer, then of its offset, per frame)
//   while the other warps load the next-earlier chunk back and write
//   the previous chunk's tids.
// Generic path (any other DK < 128, or S > 512): plane costs and
// offsets in shared memory, a loop over states, the acoustic term
// gathered in the frame, backpointers in global memory and a
// single-thread backtrace over them.  Frames at or past nf are not run
// at all: the TPU kernel runs them and keeps alpha, which is the same
// result.
//
// Bitwise parity with the plain version: the add, the scale product
// and the subtraction use __fadd_rn/__fmul_rn/__fsub_rn so nvcc cannot
// contract them into an FMA.

#include "banded_common.cuh"

#include <math.h>

#define KHG_BIG 1.0e30f

namespace {

constexpr int FAST_S = khg::FAST_MAX_S;
constexpr int CH = khg::BP_CHUNK;  // frames per backpointer chunk

__host__ __device__ int padded_states(int S) { return (S + 15) / 16 * 16; }

// Dynamic shared memory of a compiled-path block: alpha [2][FAST_S] f32
// at fixed offsets, the staged backpointers [2 * CH][Sp] i8, the
// offsets [DK] i32, the chase's path [2][2][CH] i32 and the argmin
// scratch [2][32].  align/banded_kernel.py::kernel_smem_bytes mirrors it.
size_t fast_smem_bytes(int DK, int S) {
    return (size_t)2 * FAST_S * 4 + (size_t)2 * CH * padded_states(S)
           + (size_t)DK * 4 + 4 * CH * 4 + 64 * 4;
}

// ... and of a generic block: the plane costs, two alpha buffers, the
// offsets and the argmin scratch
size_t generic_smem_bytes(int DK, int S, int nt) {
    return (size_t)DK * S * 4 + 2 * (size_t)S * 4 + (size_t)DK * 4 + (size_t)nt * 8;
}

// first-match min over the planes: (best, smallest plane attaining it)
template <int DK>
__device__ __forceinline__ int min_plane(const float* cur, const float (&cost)[DK],
                                         const int (&src)[DK], float& best) {
    best = INFINITY;
    int arg = 0;
#pragma unroll
    for (int p = 0; p < DK; ++p) {
        const float c = __fadd_rn(cur[src[p]], cost[p]);
        if (c < best) {  // strict: the first plane attaining the min
            best = c;
            arg = p;
        }
    }
    return arg;
}

template <int DK>
__global__ void __launch_bounds__(FAST_S) banded_viterbi_fast(
    const float* __restrict__ plane_cost,    // (B, DK, S)
    const int32_t* __restrict__ plane_tid,   // (B, DK, S)
    const int32_t* __restrict__ state_pdf,   // (B, S)
    const float* __restrict__ init_cost,     // (B, S)
    const float* __restrict__ final_cost,    // (B, S)
    const float* __restrict__ loglikes,      // (B, T, P)
    const int32_t* __restrict__ num_frames,  // (B,)
    const int32_t* __restrict__ offsets,     // (DK,)
    int8_t* __restrict__ bp,                 // (B, T, Sp) scratch
    int32_t* __restrict__ tids,              // (B, T) out
    float* __restrict__ total_cost,          // (B,) out
    int S, int T, int P, float scale)
{
    extern __shared__ __align__(16) unsigned char smem_fast[];
    const int Sp = padded_states(S);
    float* alpha0 = reinterpret_cast<float*>(smem_fast);      // [FAST_S]
    float* alpha1 = alpha0 + FAST_S;                           // [FAST_S]
    int8_t* stage = reinterpret_cast<int8_t*>(alpha1 + FAST_S);  // [2 * CH][Sp]
    int* offs = reinterpret_cast<int*>(stage + 2 * CH * Sp);   // [DK]
    int* path = offs + DK;                                     // [2][2][CH]
    float* red_v = reinterpret_cast<float*>(path + 4 * CH);    // [32]
    int* red_i = reinterpret_cast<int*>(red_v + 32);           // [32]

    const int b = blockIdx.x;
    const int tx = threadIdx.x;
    const int nt = blockDim.x;
    const bool live = tx < S;
    const int s = live ? tx : 0;
    int nf = num_frames[b];
    if (nf > T) nf = T;
    if (nf < 0) nf = 0;

    float cost[DK];
    int src[DK];
#pragma unroll
    for (int p = 0; p < DK; ++p) {
        int o = offsets[p] % S;
        if (o < 0) o += S;  // shift normalised into [0, S)
        if (tx == 0) offs[p] = o;
        const int sr = s - o;
        src[p] = sr < 0 ? sr + S : sr;
        cost[p] = plane_cost[((size_t)b * DK + p) * S + s];
    }
    const float fin = final_cost[(size_t)b * S + s];
    const float* llb = loglikes + (size_t)b * T * P + state_pdf[(size_t)b * S + s];
    if (live) alpha0[s] = init_cost[(size_t)b * S + s];
    // the acoustic terms of frames 0 and 1; each frame's register then
    // takes the frame two on
    float ac0 = 0.f, ac1 = 0.f;
    if (live && nf > 0) ac0 = llb[0];
    if (live && nf > 1) ac1 = llb[P];
    __syncthreads();

    int8_t* gbp = bp + (size_t)b * T * Sp;
    auto step = [&](int t, const float* cur, float* nxt, float& acr) {
        const float ac = acr;
        if (live && t + 2 < nf) acr = llb[(size_t)(t + 2) * P];
        float best;
        const int arg = min_plane<DK>(cur, cost, src, best);
        if (live) {
            nxt[s] = fminf(__fsub_rn(best, __fmul_rn(scale, ac)), KHG_BIG);
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

    // backtrace: a frame's arc is (state, plane), and a plane steps back
    // by its offset
    const int32_t* ptb = plane_tid + (size_t)b * DK * S;
    khg::backtrace_chunks(
        bi, nf, stage, gbp, Sp, path, tb,
        [&](int v, int p) {
            v -= offs[p];
            return v < 0 ? v + S : v;
        },
        [&](int v, int p) { return ptb[(size_t)p * S + v]; });
}

__global__ void banded_viterbi_generic(
    const float* __restrict__ plane_cost,    // (B, DK, S)
    const int32_t* __restrict__ plane_tid,   // (B, DK, S)
    const int32_t* __restrict__ state_pdf,   // (B, S)
    const float* __restrict__ init_cost,     // (B, S)
    const float* __restrict__ final_cost,    // (B, S)
    const float* __restrict__ loglikes,      // (B, T, P)
    const int32_t* __restrict__ num_frames,  // (B,)
    const int32_t* __restrict__ offsets,     // (DK,)
    int8_t* __restrict__ bp,                 // (B, T, S) scratch
    int32_t* __restrict__ tids,              // (B, T) out
    float* __restrict__ total_cost,          // (B,) out
    int DK, int S, int T, int P, float scale)
{
    extern __shared__ float smem[];
    float* cost_s = smem;                          // DK * S
    float* alpha_a = cost_s + (size_t)DK * S;      // S
    float* alpha_b = alpha_a + S;                  // S
    int* offs_s = reinterpret_cast<int*>(alpha_b + S);       // DK
    float* red_v = reinterpret_cast<float*>(offs_s + DK);    // blockDim
    int* red_i = reinterpret_cast<int*>(red_v + blockDim.x); // blockDim

    const int b = blockIdx.x;
    const int tx = threadIdx.x;
    const int nt = blockDim.x;
    int nf = num_frames[b];
    if (nf > T) nf = T;
    if (nf < 0) nf = 0;

    const float* pc = plane_cost + (size_t)b * DK * S;
    for (int i = tx; i < DK * S; i += nt) cost_s[i] = pc[i];
    for (int i = tx; i < DK; i += nt) {
        int o = offsets[i] % S;
        offs_s[i] = o < 0 ? o + S : o;  // shift normalised into [0, S)
    }
    for (int s = tx; s < S; s += nt) alpha_a[s] = init_cost[(size_t)b * S + s];
    __syncthreads();

    const int32_t* spdf = state_pdf + (size_t)b * S;
    const float* llb = loglikes + (size_t)b * T * P;
    int8_t* bpb = bp + (size_t)b * T * S;
    float* cur = alpha_a;
    float* nxt = alpha_b;
    for (int t = 0; t < nf; ++t) {
        const float* llt = llb + (size_t)t * P;
        for (int s = tx; s < S; s += nt) {
            float best = INFINITY;
            int arg = 0;
            for (int p = 0; p < DK; ++p) {
                int src = s - offs_s[p];
                if (src < 0) src += S;
                const float c = __fadd_rn(cur[src], cost_s[p * S + s]);
                if (c < best) {  // strict: the first plane attaining the min
                    best = c;
                    arg = p;
                }
            }
            const float ac = llt[spdf[s]];
            nxt[s] = fminf(__fsub_rn(best, __fmul_rn(scale, ac)), KHG_BIG);
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
    for (int i = 1; i < nt; ++i) khg::take_min(bv, bi, red_v[i], red_i[i]);
    total_cost[b] = bv;
    int v = bi;
    const int32_t* ptb = plane_tid + (size_t)b * DK * S;
    for (int t = nf - 1; t >= 0; --t) {
        const int p = bpb[(size_t)t * S + v];
        tids[(size_t)b * T + t] = ptb[(size_t)p * S + v];
        v -= offs_s[p];
        if (v < 0) v += S;
    }
}

template <int DK>
int launch_fast(const void* plane_cost, const void* plane_tid, const void* state_pdf,
                const void* init_cost, const void* final_cost, const void* loglikes,
                const void* num_frames, const void* offsets, void* bp, void* tids,
                void* total_cost, int B, int S, int T, int P, float scale,
                cudaStream_t stream)
{
    const int nt = ((S + 31) / 32) * 32;
    const size_t smem = fast_smem_bytes(DK, S);
    cudaError_t err = cudaFuncSetAttribute(
        banded_viterbi_fast<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return 0;
    banded_viterbi_fast<DK><<<B, nt, smem, stream>>>(
        (const float*)plane_cost, (const int32_t*)plane_tid,
        (const int32_t*)state_pdf, (const float*)init_cost,
        (const float*)final_cost, (const float*)loglikes,
        (const int32_t*)num_frames, (const int32_t*)offsets, (int8_t*)bp,
        (int32_t*)tids, (float*)total_cost, S, T, P, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// bp: a (B, T, Sp) int8 scratch, Sp = S rounded up to 16
extern "C" int launch_banded_viterbi(
    const void* plane_cost, const void* plane_tid, const void* state_pdf,
    const void* init_cost, const void* final_cost, const void* loglikes,
    const void* num_frames, const void* offsets, void* bp, void* tids,
    void* total_cost, int B, int DK, int S, int T, int P, float scale,
    void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
#define KHG_FAST(N)                                                            \
    return launch_fast<N>(plane_cost, plane_tid, state_pdf, init_cost,         \
                          final_cost, loglikes, num_frames, offsets, bp, tids, \
                          total_cost, B, S, T, P, scale, st)
    if (S <= FAST_S) {
        switch (DK) {
            case 16: KHG_FAST(16);
            case 20: KHG_FAST(20);
            case 32: KHG_FAST(32);
            default: break;
        }
    }
#undef KHG_FAST
    int nt = ((S + 31) / 32) * 32;
    if (nt > 1024) nt = 1024;
    const size_t smem = generic_smem_bytes(DK, S, nt);
    cudaError_t err = cudaFuncSetAttribute(
        banded_viterbi_generic, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return 0;
    banded_viterbi_generic<<<B, nt, smem, st>>>(
        (const float*)plane_cost, (const int32_t*)plane_tid,
        (const int32_t*)state_pdf, (const float*)init_cost,
        (const float*)final_cost, (const float*)loglikes,
        (const int32_t*)num_frames, (const int32_t*)offsets, (int8_t*)bp,
        (int32_t*)tids, (float*)total_cost, DK, S, T, P, scale);
    return (int)cudaGetLastError();
}
