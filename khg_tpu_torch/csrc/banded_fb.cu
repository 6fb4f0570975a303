// Banded (offset-plane) forward-backward for Hopper (sm_90a).
//
// Replaces khg_tpu/align/pallas_banded_fb.py::_fb_fwd_kernel and
// ::_fb_bwd_kernel (called through forward_backward_banded).  After
// SCC-topological renumbering every arc into state s comes from
// s - off[d] for a small static set of plane offsets (normalised into
// [0, S) here), and with the per-state acoustic term
// sac[t][s] = scale * ll[b, t, pdf(s)] one frame of Baum-Welch is, in
// the log domain with negated costs nc[d][s] = -plane_cost[d][s],
//
//   forward   alpha'[s] = max(lse_d(alpha[s - off[d]] + nc[d][s]) + sac[t][s], NEG_BIG)
//   posterior post_d[s] = exp(min((alpha[s - off[d]] + nc[d][s])
//                                 + ((beta'[s] + sac[t][s]) - logZ), 0))
//   backward  beta[s]   = lse_d((beta' + sac[t])[s + off[d]] + nc[d][s + off[d]])
//
// where lse_d keeps khg_tpu's floor (a maximum at or below NEG_BIG/2
// gives NEG_BIG; never below NEG_BIG).  The beta recursion reads the
// out-plane cost straight from the in-plane at s + off[d], so the TPU
// kernel's pre-rolled, plane-flipped copy of the costs is not built.
//
// What bounds it on the H100: frame t+1 needs every alpha (beta) of
// frame t, so an utterance's time is a chain of nf dependent frames,
// each an exchange through shared memory, a barrier, a max and a sum
// over DK planes, an expf per plane and one logf.  The bytes are small
// next to that chain (at the main-path shapes the whole alpha history,
// 256 utts x 512 frames x 256 states x 4 B = 134 MB, is written once
// and read once: ~0.08 ms at 3.35 TB/s).
//
// Design: one thread block per utterance, one thread per state, alpha
// double-buffered in shared memory (one barrier per frame).  The forward
// kernel writes every alpha to global memory for the backward kernel,
// instead of the TPU kernel's per-chunk checkpoints and recomputation:
// that would add a second forward sweep to the backward kernel's serial
// chain to save bytes that are not the limit here.  log Z sums the
// states' terms in order, as the plain version sums.  Frames at or past
// nf are not run: alpha and beta stay as they are and their posteriors
// are written as 0.
//
// Both kernels have a compiled path for the band widths of the main
// paths (banded_fb_fwd_fast, banded_fb_bwd_fast) that keeps the
// per-state tables in registers and the acoustic terms and the next
// alpha rows off the frame chain, and a generic path (the first port's
// layout, tables in shared memory) for every other shape.  Each thread
// owns its state's plane-posterior sums, so no atomics.
//
// Shared memory: forward, compiled path 16 S + 128 bytes, generic path
// (DK * S + 2 * S) floats + DK ints (smem_bytes below, nbuf = 1);
// backward, compiled path 4 S (2 PF_FB + 4) bytes, generic path
// (DK * S + 4 * S) floats + DK ints, plus DK * S floats of
// plane-posterior sums where they fit.  align/banded_fb.py mirrors them
// (fb_fwd_smem_bytes, fb_kernel_smem_bytes).
//
// Parity with the plain version (align/banded_fb.py): the adds use
// __fadd_rn/__fsub_rn/__fmul_rn so nvcc cannot contract them into FMAs,
// planes and states are summed one after another in index order, and
// expf/logf are the precise ones (no fast math).

#include "banded_common.cuh"

#include <math.h>

#define KHG_NEG_BIG (-1.0e30f)
#define KHG_HALF_NEG_BIG (-5.0e29f)

namespace {

// floored log-sum-exp from the maximum m and sum(exp(c - m_safe))
__device__ __forceinline__ float lse_finish(float m, float sum, float m_safe) {
    const float out = (m > KHG_HALF_NEG_BIG) ? __fadd_rn(logf(sum), m_safe)
                                             : KHG_NEG_BIG;
    return fmaxf(out, KHG_NEG_BIG);
}

__device__ __forceinline__ float safe_max(float m) {
    return (m > KHG_HALF_NEG_BIG) ? m : 0.f;
}

// Compiled forward path (DK = 16, 20 or 32 planes, S <= 512 states):
// one thread per state, which holds for the whole utterance, in
// registers, its negated in-plane costs nc[d][s] and its source index.
// Alpha is double-buffered in shared memory and stored twice over (2S
// floats), so s - off[d] + S needs no wrap.  Each frame puts the DK
// candidates in registers once, then takes their max and their in-order
// sum; the acoustic term arrives two frames ahead in registers; one
// barrier per frame.  A warp whose every lane has m <= NEG_BIG/2 skips
// the sum, which lse_finish does not read there.  log Z: a block max by
// shuffles, one expf per state in parallel, then one thread's in-order
// sum of the S terms (the plain version's order).
template <int DK>
__global__ void __launch_bounds__(khg::FAST_MAX_S) banded_fb_fwd_fast(
    const float* __restrict__ plane_cost,    // (B, DK, S)
    const int32_t* __restrict__ state_pdf,   // (B, S)
    const float* __restrict__ init_cost,     // (B, S)
    const float* __restrict__ final_cost,    // (B, S)
    const float* __restrict__ loglikes,      // (B, T, P)
    const int32_t* __restrict__ num_frames,  // (B,)
    const int32_t* __restrict__ offsets,     // (DK,)
    float* __restrict__ alphas,              // (B, T, S) out: alpha before frame t
    float* __restrict__ log_z,               // (B,) out
    int S, int T, int P, float scale)
{
    extern __shared__ __align__(16) float smem_fb[];
    float* abuf = smem_fb;            // [2][2S]
    float* red = abuf + 4 * S;        // 32 warp maxima

    const int b = blockIdx.x;
    const int tx = threadIdx.x;
    const bool live = tx < S;
    const int s = live ? tx : 0;
    int nf = num_frames[b];
    if (nf > T) nf = T;
    if (nf < 0) nf = 0;

    const float* pc = plane_cost + (size_t)b * DK * S;
    float nc[DK];
    int src[DK];  // s - off[d] + S
#pragma unroll
    for (int d = 0; d < DK; ++d) {
        int o = offsets[d] % S;
        if (o < 0) o += S;
        src[d] = s + S - o;
        nc[d] = -pc[(size_t)d * S + s];
    }
    float a = KHG_NEG_BIG;
    if (live) {
        a = fmaxf(-init_cost[(size_t)b * S + s], KHG_NEG_BIG);
        abuf[s] = a;
        abuf[s + S] = a;
    }
    const float* llb = loglikes + (size_t)b * T * P + state_pdf[(size_t)b * S + s];
    float ac0 = (live && nf > 0) ? llb[0] : 0.f;
    float ac1 = (live && nf > 1) ? llb[(size_t)P] : 0.f;
    float* ab = alphas + (size_t)b * T * S + s;
    __syncthreads();

    for (int t = 0; t < nf; ++t) {
        const float* in = abuf + (t & 1) * 2 * S;
        float* out = abuf + ((t & 1) ^ 1) * 2 * S;
        if (live) ab[(size_t)t * S] = a;
        const float ac = ac0;
        ac0 = ac1;
        if (live && t + 2 < nf) ac1 = llb[(size_t)(t + 2) * P];
        float c[DK];
        float m = -INFINITY;
#pragma unroll
        for (int d = 0; d < DK; ++d) {
            c[d] = __fadd_rn(in[src[d]], nc[d]);
            m = fmaxf(m, c[d]);
        }
        const float ms = safe_max(m);
        float sum = 0.f;  // read by lse_finish only where m > NEG_BIG/2
        if (__any_sync(0xffffffffu, m > KHG_HALF_NEG_BIG)) {
#pragma unroll
            for (int d = 0; d < DK; ++d) sum = __fadd_rn(sum, expf(__fsub_rn(c[d], ms)));
        }
        const float sac = __fmul_rn(scale, ac);
        a = fmaxf(__fadd_rn(lse_finish(m, sum, ms), sac), KHG_NEG_BIG);
        if (live) {
            out[s] = a;
            out[s + S] = a;
        }
        __syncthreads();
    }

    // log Z = lse_s(alpha + final): the max over the block, then each
    // state's term, summed in state order by one thread
    const float v = live ? __fadd_rn(a, fmaxf(-final_cost[(size_t)b * S + s], KHG_NEG_BIG))
                         : -INFINITY;
    float m = v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((tx & 31) == 0) red[tx >> 5] = m;
    __syncthreads();
    m = red[0];
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) m = fmaxf(m, red[i]);
    const float ms = safe_max(m);
    float* terms = abuf + ((nf & 1) ^ 1) * 2 * S;  // the buffer not holding the last alpha
    if (live) terms[s] = expf(__fsub_rn(v, ms));
    __syncthreads();
    if (tx == 0) {
        float sum = 0.f;
        for (int i = 0; i < S; ++i) sum = __fadd_rn(sum, terms[i]);
        log_z[b] = lse_finish(m, sum, ms);
    }
}

// Generic forward path (any other DK, or S > 512): the first port's
// kernel, with the negated plane costs and the offsets in shared memory.
__global__ void __launch_bounds__(1024) banded_fb_fwd_generic(
    const float* __restrict__ plane_cost,    // (B, DK, S)
    const int32_t* __restrict__ state_pdf,   // (B, S)
    const float* __restrict__ init_cost,     // (B, S)
    const float* __restrict__ final_cost,    // (B, S)
    const float* __restrict__ loglikes,      // (B, T, P)
    const int32_t* __restrict__ num_frames,  // (B,)
    const int32_t* __restrict__ offsets,     // (DK,)
    float* __restrict__ alphas,              // (B, T, S) out: alpha before frame t
    float* __restrict__ log_z,               // (B,) out
    int DK, int S, int T, int P, float scale)
{
    extern __shared__ float smem[];
    float* nc = smem;                                    // DK * S
    float* abuf = nc + (size_t)DK * S;                   // 2 * S
    int* offs = reinterpret_cast<int*>(abuf + 2 * S);    // DK

    const int b = blockIdx.x;
    const int s = threadIdx.x;
    const int nt = blockDim.x;
    const bool live = s < S;
    int nf = num_frames[b];
    if (nf > T) nf = T;
    if (nf < 0) nf = 0;

    const float* pc = plane_cost + (size_t)b * DK * S;
    for (int i = s; i < DK * S; i += nt) nc[i] = -pc[i];
    for (int i = s; i < DK; i += nt) {
        const int o = offsets[i] % S;
        offs[i] = o < 0 ? o + S : o;
    }
    float a = KHG_NEG_BIG;
    int pdf = 0;
    if (live) {
        a = fmaxf(-init_cost[(size_t)b * S + s], KHG_NEG_BIG);
        abuf[s] = a;
        pdf = state_pdf[(size_t)b * S + s];
    }
    __syncthreads();

    const float* llb = loglikes + (size_t)b * T * P;
    float* ab = alphas + (size_t)b * T * S;
    int cur = 0;
    for (int t = 0; t < nf; ++t) {
        const float* in = abuf + cur * S;
        float* out = abuf + (cur ^ 1) * S;
        if (live) {
            ab[(size_t)t * S + s] = a;
            float m = -INFINITY;
            for (int d = 0; d < DK; ++d) {
                int src = s - offs[d];
                if (src < 0) src += S;
                m = fmaxf(m, __fadd_rn(in[src], nc[d * S + s]));
            }
            const float ms = safe_max(m);
            float sum = 0.f;
            for (int d = 0; d < DK; ++d) {
                int src = s - offs[d];
                if (src < 0) src += S;
                const float c = __fadd_rn(in[src], nc[d * S + s]);
                sum = __fadd_rn(sum, expf(__fsub_rn(c, ms)));
            }
            const float sac = __fmul_rn(scale, llb[(size_t)t * P + pdf]);
            a = fmaxf(__fadd_rn(lse_finish(m, sum, ms), sac), KHG_NEG_BIG);
            out[s] = a;
        }
        __syncthreads();
        cur ^= 1;
    }

    // log Z = lse_s(alpha + final), summed over the states in order; the
    // alpha buffer not holding the last alpha is free after the barrier
    float* red = abuf + (cur ^ 1) * S;
    if (live) {
        red[s] = __fadd_rn(a, fmaxf(-final_cost[(size_t)b * S + s], KHG_NEG_BIG));
    }
    __syncthreads();
    if (s == 0) {
        float m = -INFINITY;
        for (int i = 0; i < S; ++i) m = fmaxf(m, red[i]);
        const float ms = safe_max(m);
        float sum = 0.f;
        for (int i = 0; i < S; ++i) sum = __fadd_rn(sum, expf(__fsub_rn(red[i], ms)));
        log_z[b] = lse_finish(m, sum, ms);
    }
}

// Compiled backward path (DK = 16 or 20 planes, S <= 512 states): one
// thread per state, which holds for the whole utterance, in registers,
// its in-plane and out-plane negated costs nc[d][s] and
// nc[d][s + off[d]], its source index and its DK plane-posterior sums
// (written once at the end; each cell still adds its frames in
// descending t).  The alpha row of frame t arrives PF_FB - 1 frames
// ahead by cp.async into a shared ring (16-byte copies by S/4 threads
// where S is a multiple of 4; 4-byte copies per element cost 40% of the
// kernel, tools/kernel_split.py), and the thread's acoustic term one
// frame ahead into a register.  Alpha rows and beta' + sac are stored
// twice over (2S floats), so s - off[d] + S and s + off[d] need no
// wrap.  One barrier per frame.  A warp skips a frame's posterior expfs
// where they are all +0 in every lane, and the beta sum where no lane
// reads it.
constexpr int PF_FB = 4;
// expf is +0 below this (the least denormal is e^-103.3), and adding
// +0 leaves a sum of non-negative terms as it is: a warp whose plane
// posteriors of a frame all lie below it in every lane skips their
// expf and adds (states away from every likely path), and a warp whose
// every beta is floored (m <= NEG_BIG/2, the sum unread) skips the sum.
// The outputs stay bit-equal to the plain version's.
constexpr float EXP_ZERO = -110.f;

// dynamic shared memory of a compiled backward block: the alpha ring
// [PF_FB][2S] and beta' + sac [2][2S]
size_t bwd_fast_smem_bytes(int S) { return (size_t)4 * S * (2 * PF_FB + 4); }

template <int DK>
__global__ void __launch_bounds__(khg::FAST_MAX_S) banded_fb_bwd_fast(
    const float* __restrict__ plane_cost,    // (B, DK, S)
    const int32_t* __restrict__ state_pdf,   // (B, S)
    const float* __restrict__ final_cost,    // (B, S)
    const float* __restrict__ loglikes,      // (B, T, P)
    const int32_t* __restrict__ num_frames,  // (B,)
    const int32_t* __restrict__ offsets,     // (DK,)
    const float* __restrict__ alphas,        // (B, T, S)
    const float* __restrict__ log_z,         // (B,)
    float* __restrict__ spost,               // (B, T, S) out
    float* __restrict__ apost,               // (B, DK, S) out
    int S, int T, int P, float scale)
{
    extern __shared__ __align__(16) float smem_fb[];
    float* aring = smem_fb;                  // [PF_FB][2S]
    float* bbuf = aring + PF_FB * 2 * S;     // [2][2S]

    const int b = blockIdx.x;
    const int tx = threadIdx.x;
    const bool live = tx < S;
    const int s = live ? tx : 0;
    int nf = num_frames[b];
    if (nf > T) nf = T;
    if (nf < 0) nf = 0;

    const float* pc = plane_cost + (size_t)b * DK * S;
    float ncin[DK], ncout[DK], ap[DK];
    int src[DK];  // s - off[d] + S; the out-plane's s + off[d] is 2s + S - src[d]
#pragma unroll
    for (int d = 0; d < DK; ++d) {
        int o = offsets[d] % S;
        if (o < 0) o += S;
        src[d] = s + S - o;
        const int dst = s + o < S ? s + o : s + o - S;
        ncin[d] = -pc[(size_t)d * S + s];
        ncout[d] = -pc[(size_t)d * S + dst];
        ap[d] = 0.f;
    }
    const int two_s = 2 * s + S;
    float beta = fmaxf(-final_cost[(size_t)b * S + s], KHG_NEG_BIG);
    const float* llb = loglikes + (size_t)b * T * P + state_pdf[(size_t)b * S + s];
    const float* ab = alphas + (size_t)b * T * S;
    float* spb = spost + (size_t)b * T * S + s;
    if (live) {
        for (int t = nf; t < T; ++t) spb[(size_t)t * S] = 0.f;
    }
    const float lz = log_z[b];

    // the alpha row of iteration i (frame nf - 1 - i) into ring slot
    // i % PF_FB, twice
    const bool vec = (S & 3) == 0;
    auto issue = [&](int i) {
        const int t = nf - 1 - i;
        if (t >= 0) {
            float* a = aring + (i % PF_FB) * 2 * S;
            const float* row = ab + (size_t)t * S;
            if (vec) {
                if (tx < S / 4) {
                    khg::cp_async16(a + 4 * tx, row + 4 * tx);
                    khg::cp_async16(a + S + 4 * tx, row + 4 * tx);
                }
            } else if (live) {
                khg::cp_async4(a + s, row + s);
                khg::cp_async4(a + S + s, row + s);
            }
        }
        khg::cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < PF_FB - 1; ++i) issue(i);
    float ac_next = (live && nf > 0) ? llb[(size_t)(nf - 1) * P] : 0.f;

    for (int i = 0; i < nf; ++i) {
        const int t = nf - 1 - i;
        const int slot = i % PF_FB;
        khg::cp_async_wait<PF_FB - 2>();  // this thread's copies of frame t
        float* bk = bbuf + (i & 1) * 2 * S;
        const float ac = ac_next;
        if (live && t > 0) ac_next = llb[(size_t)(t - 1) * P];
        const float bplus = __fadd_rn(beta, __fmul_rn(scale, ac));
        if (live) {
            bk[s] = bplus;
            bk[s + S] = bplus;
        }
        __syncthreads();
        issue(i + PF_FB - 1);  // into the slot that iteration i - 1 read
        // posteriors of the arcs into s
        const float* al = aring + slot * 2 * S;
        const float rest = __fsub_rn(bplus, lz);
        float x[DK];
        float xm = -INFINITY;
#pragma unroll
        for (int d = 0; d < DK; ++d) {
            x[d] = fminf(__fadd_rn(__fadd_rn(al[src[d]], ncin[d]), rest), 0.f);
            xm = fmaxf(xm, x[d]);
        }
        float sp = 0.f;
        if (__any_sync(0xffffffffu, !(xm < EXP_ZERO))) {
#pragma unroll
            for (int d = 0; d < DK; ++d) {
                const float p = expf(x[d]);
                sp = __fadd_rn(sp, p);
                ap[d] = __fadd_rn(ap[d], p);
            }
        }
        if (live) spb[(size_t)t * S] = sp;
        // beta through the arcs out of s: s -> s + off[d]
        float c[DK];
        float m = -INFINITY;
#pragma unroll
        for (int d = 0; d < DK; ++d) {
            c[d] = __fadd_rn(bk[two_s - src[d]], ncout[d]);
            m = fmaxf(m, c[d]);
        }
        const float ms = safe_max(m);
        float sum = 0.f;  // read by lse_finish only where m > NEG_BIG/2
        if (__any_sync(0xffffffffu, m > KHG_HALF_NEG_BIG)) {
#pragma unroll
            for (int d = 0; d < DK; ++d) sum = __fadd_rn(sum, expf(__fsub_rn(c[d], ms)));
        }
        beta = lse_finish(m, sum, ms);
    }
    if (live) {
        float* apb = apost + (size_t)b * DK * S + s;
#pragma unroll
        for (int d = 0; d < DK; ++d) apb[(size_t)d * S] = ap[d];
    }
}

// Generic backward path (any other DK, or S > 512): the negated plane
// costs and the offsets in shared memory, alpha_t and beta' + sac
// double-buffered there, and each thread's plane-posterior sums in
// shared memory when the block has room for them (``ap_smem``), else in
// the output array in global memory, which no other thread touches.
__global__ void __launch_bounds__(1024) banded_fb_bwd_generic(
    const float* __restrict__ plane_cost,    // (B, DK, S)
    const int32_t* __restrict__ state_pdf,   // (B, S)
    const float* __restrict__ final_cost,    // (B, S)
    const float* __restrict__ loglikes,      // (B, T, P)
    const int32_t* __restrict__ num_frames,  // (B,)
    const int32_t* __restrict__ offsets,     // (DK,)
    const float* __restrict__ alphas,        // (B, T, S)
    const float* __restrict__ log_z,         // (B,)
    float* __restrict__ spost,               // (B, T, S) out
    float* __restrict__ apost,               // (B, DK, S) out
    int DK, int S, int T, int P, float scale, int ap_smem)
{
    extern __shared__ float smem[];
    float* nc = smem;                                    // DK * S
    float* abuf = nc + (size_t)DK * S;                   // 2 * S: alpha_t
    float* pbuf = abuf + 2 * S;                          // 2 * S: beta' + sac_t
    int* offs = reinterpret_cast<int*>(pbuf + 2 * S);    // DK
    float* aps = reinterpret_cast<float*>(offs + DK);    // DK * S if ap_smem

    const int b = blockIdx.x;
    const int s = threadIdx.x;
    const int nt = blockDim.x;
    const bool live = s < S;
    int nf = num_frames[b];
    if (nf > T) nf = T;
    if (nf < 0) nf = 0;

    const float* pc = plane_cost + (size_t)b * DK * S;
    for (int i = s; i < DK * S; i += nt) nc[i] = -pc[i];
    for (int i = s; i < DK; i += nt) {
        const int o = offsets[i] % S;
        offs[i] = o < 0 ? o + S : o;
    }

    float* spb = spost + (size_t)b * T * S;
    float* apb = apost + (size_t)b * DK * S;
    float* acc = (ap_smem ? aps : apb) + s;  // this state's plane sums, stride S
    float beta = KHG_NEG_BIG;
    int pdf = 0;
    if (live) {
        beta = fmaxf(-final_cost[(size_t)b * S + s], KHG_NEG_BIG);
        pdf = state_pdf[(size_t)b * S + s];
        for (int t = nf; t < T; ++t) spb[(size_t)t * S + s] = 0.f;
        for (int d = 0; d < DK; ++d) acc[(size_t)d * S] = 0.f;
    }
    const float lz = log_z[b];
    __syncthreads();

    const float* llb = loglikes + (size_t)b * T * P;
    const float* ab = alphas + (size_t)b * T * S;
    int k = 0;
    for (int t = nf - 1; t >= 0; --t) {
        float* al = abuf + k * S;
        float* bp = pbuf + k * S;
        float bplus = 0.f;
        if (live) {
            al[s] = ab[(size_t)t * S + s];
            bplus = __fadd_rn(beta, __fmul_rn(scale, llb[(size_t)t * P + pdf]));
            bp[s] = bplus;
        }
        __syncthreads();
        if (live) {
            // posteriors of the arcs into s
            const float rest = __fsub_rn(bplus, lz);
            float sp = 0.f;
            for (int d = 0; d < DK; ++d) {
                int src = s - offs[d];
                if (src < 0) src += S;
                const float lp = __fadd_rn(
                    __fadd_rn(al[src], nc[d * S + s]), rest);
                const float p = expf(fminf(lp, 0.f));
                sp = __fadd_rn(sp, p);
                float* cell = acc + (size_t)d * S;
                *cell = __fadd_rn(*cell, p);
            }
            spb[(size_t)t * S + s] = sp;
            // beta through the arcs out of s: s -> s + off[d]
            float m = -INFINITY;
            for (int d = 0; d < DK; ++d) {
                int dst = s + offs[d];
                if (dst >= S) dst -= S;
                m = fmaxf(m, __fadd_rn(bp[dst], nc[d * S + dst]));
            }
            const float ms = safe_max(m);
            float sum = 0.f;
            for (int d = 0; d < DK; ++d) {
                int dst = s + offs[d];
                if (dst >= S) dst -= S;
                const float c = __fadd_rn(bp[dst], nc[d * S + dst]);
                sum = __fadd_rn(sum, expf(__fsub_rn(c, ms)));
            }
            beta = lse_finish(m, sum, ms);
        }
        k ^= 1;
    }
    if (ap_smem && live) {
        for (int d = 0; d < DK; ++d) apb[(size_t)d * S + s] = aps[(size_t)d * S + s];
    }
}

int threads_for(int S) { return ((S + 31) / 32) * 32; }

// nbuf S-float buffers, each double-buffered, beside the plane costs
size_t smem_bytes(int DK, int S, int nbuf) {
    return ((size_t)DK * S + 2 * (size_t)nbuf * S) * 4 + (size_t)DK * 4;
}

template <int DK>
int launch_bwd_fast(const void* plane_cost, const void* state_pdf, const void* final_cost,
                    const void* loglikes, const void* num_frames, const void* offsets,
                    const void* alphas, const void* log_z, void* spost, void* apost,
                    int B, int S, int T, int P, float scale, cudaStream_t stream)
{
    const size_t smem = bwd_fast_smem_bytes(S);
    cudaError_t err = cudaFuncSetAttribute(
        banded_fb_bwd_fast<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return 0;
    banded_fb_bwd_fast<DK><<<B, threads_for(S), smem, stream>>>(
        (const float*)plane_cost, (const int32_t*)state_pdf,
        (const float*)final_cost, (const float*)loglikes,
        (const int32_t*)num_frames, (const int32_t*)offsets,
        (const float*)alphas, (const float*)log_z, (float*)spost,
        (float*)apost, S, T, P, scale);
    return (int)cudaGetLastError();
}

// dynamic shared memory of a compiled forward block: alpha [2][2S] and
// 32 warp maxima for log Z
size_t fwd_fast_smem_bytes(int S) { return (size_t)16 * S + 128; }

template <int DK>
int launch_fwd_fast(const void* plane_cost, const void* state_pdf, const void* init_cost,
                    const void* final_cost, const void* loglikes, const void* num_frames,
                    const void* offsets, void* alphas, void* log_z,
                    int B, int S, int T, int P, float scale, cudaStream_t stream)
{
    const size_t smem = fwd_fast_smem_bytes(S);
    cudaError_t err = cudaFuncSetAttribute(
        banded_fb_fwd_fast<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return 0;
    banded_fb_fwd_fast<DK><<<B, threads_for(S), smem, stream>>>(
        (const float*)plane_cost, (const int32_t*)state_pdf,
        (const float*)init_cost, (const float*)final_cost,
        (const float*)loglikes, (const int32_t*)num_frames,
        (const int32_t*)offsets, (float*)alphas, (float*)log_z,
        S, T, P, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int launch_banded_fb_fwd(
    const void* plane_cost, const void* state_pdf, const void* init_cost,
    const void* final_cost, const void* loglikes, const void* num_frames,
    const void* offsets, void* alphas, void* log_z, int B, int DK, int S,
    int T, int P, float scale, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
#define KHG_FAST(N)                                                        \
    return launch_fwd_fast<N>(plane_cost, state_pdf, init_cost, final_cost, \
                              loglikes, num_frames, offsets, alphas, log_z, \
                              B, S, T, P, scale, st)
    if (S <= khg::FAST_MAX_S) {
        switch (DK) {
            case 16: KHG_FAST(16);
            case 20: KHG_FAST(20);
            case 32: KHG_FAST(32);
            default: break;
        }
    }
#undef KHG_FAST
    const int nt = threads_for(S);
    if (nt > 1024) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(DK, S, 1);
    cudaError_t err = cudaFuncSetAttribute(
        banded_fb_fwd_generic, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return 0;
    banded_fb_fwd_generic<<<B, nt, smem, st>>>(
        (const float*)plane_cost, (const int32_t*)state_pdf,
        (const float*)init_cost, (const float*)final_cost,
        (const float*)loglikes, (const int32_t*)num_frames,
        (const int32_t*)offsets, (float*)alphas, (float*)log_z,
        DK, S, T, P, scale);
    return (int)cudaGetLastError();
}

extern "C" int launch_banded_fb_bwd(
    const void* plane_cost, const void* state_pdf, const void* final_cost,
    const void* loglikes, const void* num_frames, const void* offsets,
    const void* alphas, const void* log_z, void* spost, void* apost,
    int B, int DK, int S, int T, int P, float scale, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
#define KHG_FAST(N)                                                       \
    return launch_bwd_fast<N>(plane_cost, state_pdf, final_cost, loglikes, \
                              num_frames, offsets, alphas, log_z, spost,   \
                              apost, B, S, T, P, scale, st)
    if (S <= khg::FAST_MAX_S) {
        switch (DK) {
            case 16: KHG_FAST(16);
            case 20: KHG_FAST(20);
            default: break;
        }
    }
#undef KHG_FAST
    const int nt = threads_for(S);
    if (nt > 1024) return (int)cudaErrorInvalidValue;
    size_t smem = smem_bytes(DK, S, 2);
    const int ap_smem = smem + (size_t)DK * S * 4 <= khg::SMEM_LIMIT;
    if (ap_smem) smem += (size_t)DK * S * 4;
    cudaError_t err = cudaFuncSetAttribute(
        banded_fb_bwd_generic, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return 0;
    banded_fb_bwd_generic<<<B, nt, smem, st>>>(
        (const float*)plane_cost, (const int32_t*)state_pdf,
        (const float*)final_cost, (const float*)loglikes,
        (const int32_t*)num_frames, (const int32_t*)offsets,
        (const float*)alphas, (const float*)log_z, (float*)spost,
        (float*)apost, DK, S, T, P, scale, ap_smem);
    return (int)cudaGetLastError();
}
