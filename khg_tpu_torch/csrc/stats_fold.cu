// Wide-model stats fold for Hopper (sm_90a): each frame's first graph
// state of its aligned pdf rescored, its component posteriors, and
// [occ | post*x | post*x^2] summed per pdf.
//
// Replaces khg_tpu/stats/pallas_fold.py::_fold_kernel (called through
// accumulate_am_stats_fold_pallas), together with the (B, S) -> P
// scatter that runs outside it there.  For the frames t of utterance b
// with w[b, t] > 0 whose pdf p = pdf_ids[b, t] is on a state of
// state_pdf[b] (a frame of an absent pdf drops out of every output),
// with s the FIRST state of p (states of one pdf share their model
// rows):
//
//   sc[k]         = [x, x^2][t] . [miv, -1/2 iv][p, k] + max(g[p, k], -1e30)
//   post[k]       = exp(sc[k] - max) / sum * w;  lse = max + log(sum)
//   out[p, k, :] += post[k] * [1, x[t], x[t]^2]
//   ll[b, s]     += lse * w;  frames[b, s] += w
//
// What bounds it on the H100: bytes, barely.  The function moves the
// model rows of the pdfs on the graphs' states in and the (P, K, 2D+1)
// stats out (~45 MB at P = 2051, K = 32, D = 80) and does ~20k flops
// per frame (K dots of 2D for the scores, K (2D+1) multiply-adds for
// the fold): ~0.4 GFLOP for 64 x 300 frames, ~0.006 ms at the fp32
// peak against ~0.015 ms of bytes.  The fold's sums are serial per
// output entry (below), so the pdf with the most frames sets a chain.
//
// Design: five launches, no atomics on floats, so reruns are
// bit-identical.  A segment is the frames of one (utterance, state).
//   1. match (one block per utterance): each frame's first state of its
//      pdf, its rank among its segment's frames in time order, and the
//      segments' frame counts.
//   2. group (one block): the non-empty segments grouped by pdf, in
//      ascending utterance (warp-level match_any over the segments in
//      (b, s) order), and each segment's first position in the list of
//      all frames sorted by (pdf, b, t); the used pdfs and their ranges.
//   3. place (one block per utterance): each frame's index at its
//      sorted position; 0 in ll and frames of the states without frames.
//   4. score (one block per 64 sorted positions): per run of one pdf,
//      its model rows in shared memory and one thread per (8 frames,
//      component) scores, reading x 16 bytes at a time; one thread per
//      frame the max, sum and log Z; then the posteriors.  Writes the
//      posteriors, the rows [x, first-frame flag] and w, lse*w at the
//      sorted positions.  Where a pdf's K model rows and one position's
//      scores do not fit a block (K > 358 at D = 80), the scores go to
//      the posteriors' place in the float workspace and the model rows
//      are staged in chunks of components (score_plan): any K.
//   5. fold (persistent blocks that take items from a counter: each
//      used pdf's slices of (row entry q, group of 4 components) pairs,
//      the pdfs with the most frames first, then the segments, then the
//      unused pdfs' zero rows, stores that fill the SMs the longest
//      chains leave idle): each thread walks its pdf's frames in sorted
//      order, 32 at a time, three chunks in flight by cp.async into
//      shared memory (per frame one x, squared for the x^2 entries, and
//      one 16-byte read of 4 posteriors for 4 output entries), and
//      writes its entries once; a segment item sums its frames' lse*w
//      and w in time order into ll and frames.
// Scoring frames grouped by pdf reads a pdf's 20 KB of model rows once
// per run of up to 64 sorted frames, not once per frame (~0.4 GB of L2
// reads at the main path's shapes), and every score block has the same
// work, whatever the segments' lengths.
//
// The sums keep the order of the first port's kernel and its sorted
// segment sum, so the outputs are the same to the bit: per segment a
// serial sum over its frames in time order from 0 (a + p * x, not
// contracted), and per pdf the segments' sums added in ascending
// utterance; the scores, max, sum and posteriors use that kernel's
// expressions (an fmaf dot in q order, z += expf(r - max) as nvcc
// contracts it, expf(r - max) / z * w).  ll and frames keep their
// (B, S) layout (0 on states that take no frame) for torch.sum.
//
// Scratch (stats/fold_kernel.py allocates it and mirrors the layouts and
// the shared-memory requests): an int workspace (fold_ws) and a float
// one (fold_fws): the sorted rows (B T, XR), XR = D+1 rounded up to 4
// floats (x and the first-frame flag), the sorted posteriors (B T, K),
// lse*w and w (B T each).

#include "banded_common.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;      // match, place and fold blocks
constexpr int GROUP_THREADS = 1024;
constexpr int CH = 32;            // frames per staged fold chunk
constexpr int NSTAGE = 3;         // fold chunks in flight
constexpr int STATE_TILE = 4096;  // states ranked per pass of the match block
constexpr int PDF_TILE = 8192;    // pdfs per pass of the group block
constexpr int ZERO_PDFS = 8;      // unused pdfs per zero item of the fold

struct Ws {
    int32_t* fsid;       // (B T) first state of the frame's pdf, -1 if dropped
    int32_t* frank;      // (B T) rank of the frame in its segment
    int32_t* order;      // (B T) b T + t of each sorted position
    int32_t* seg_cnt;    // (B S) frames per segment
    int32_t* seg_goff;   // (B S) segment start in the sorted frame list
    int32_t* seglist;    // (B S) segments (b S + s) by pdf, b ascending
    int32_t* pdf_nseg;   // (P) segments per pdf
    int32_t* used_pdf;   // (U) U = min(P, B S)
    int32_t* used_sbase; // (U) first segment in seglist
    int32_t* used_fbase; // (U) first frame in the sorted list
    int32_t* used_fcnt;  // (U) frames
    int32_t* uorder;     // (U) used pdfs, most frames first (roughly)
    int32_t* hdr;        // [0] used pdfs, [1] sorted frames, [2] segments,
                         // [3] the fold's next item, [4] its finished blocks
};

__host__ __device__ inline Ws fold_ws(void* base, int B, int S, int T, int P) {
    int32_t* p = (int32_t*)base;
    const size_t BT = (size_t)B * T, BS = (size_t)B * S;
    const size_t U = (size_t)P < BS ? (size_t)P : BS;
    Ws w;
    w.fsid = p; p += BT;
    w.frank = p; p += BT;
    w.order = p; p += BT;
    w.seg_cnt = p; p += BS;
    w.seg_goff = p; p += BS;
    w.seglist = p; p += BS;
    w.pdf_nseg = p; p += P;
    w.used_pdf = p; p += U;
    w.used_sbase = p; p += U;
    w.used_fbase = p; p += U;
    w.used_fcnt = p; p += U;
    w.uorder = p; p += U;
    w.hdr = p;
    return w;
}

// the float workspace: sorted rows, posteriors, lse * w and w
struct Fws {
    float* rows;   // (B T, XR) x | first-frame flag
    float* post;   // (B T, K)
    float* lw;     // (B T)
    float* w;      // (B T)
};

// a sorted row: the frame's x (D floats), its first-frame flag, padding
// to 16 bytes
__host__ __device__ inline int row_floats(int D) { return (D + 1 + 3) & ~3; }

__host__ __device__ inline Fws fold_fws(void* base, int B, int T, int K, int D) {
    const size_t BT = (size_t)B * T;
    Fws f;
    f.rows = (float*)base;
    f.post = f.rows + BT * row_floats(D);
    f.lw = f.post + BT * K;
    f.w = f.lw + BT;
    return f;
}

__device__ __forceinline__ unsigned lanemask_lt() {
    return (1u << (threadIdx.x & 31)) - 1u;
}

// inclusive scan of v over the block (all threads call it); *total gets
// the block's sum; warp_s holds 32 ints
__device__ int block_scan(int v, int* total, int* warp_s) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += n;
    }
    if (lane == 31) warp_s[wid] = v;
    __syncthreads();
    if (wid == 0) {
        int x = lane < nw ? warp_s[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int n = __shfl_up_sync(0xffffffffu, x, o);
            if (lane >= o) x += n;
        }
        warp_s[lane] = x;
    }
    __syncthreads();
    if (wid > 0) v += warp_s[wid - 1];
    *total = warp_s[nw - 1];
    __syncthreads();
    return v;
}

// 1. match: one block per utterance
__global__ void __launch_bounds__(THREADS) fold_match_kernel(
    const int32_t* __restrict__ pdf_ids,    // (B, T)
    const float* __restrict__ weights,      // (B, T)
    const int32_t* __restrict__ state_pdf,  // (B, S)
    Ws w, int S, int T)
{
    __shared__ int cnt_s[STATE_TILE];
    const int b = blockIdx.x;
    const int tx = threadIdx.x;
    const int32_t* sp = state_pdf + (size_t)b * S;
    const size_t bt = (size_t)b * T, bs = (size_t)b * S;

    for (int t = tx; t < T; t += THREADS) {
        int sid = -1;
        if (weights[bt + t] > 0.f) {
            const int p = pdf_ids[bt + t];
            for (int s = 0; s < S; s += 4) {  // 4 loads in flight a step
                int v[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) v[r] = s + r < S ? __ldg(sp + s + r) : INT_MIN;
                int hit = -1;
#pragma unroll
                for (int r = 3; r >= 0; --r) {
                    if (v[r] == p) hit = s + r;
                }
                if (hit >= 0) {
                    sid = hit;
                    break;
                }
            }
        }
        w.fsid[bt + t] = sid;
    }
    __syncthreads();
    for (int s0 = 0; s0 < S; s0 += STATE_TILE) {
        const int st = min(STATE_TILE, S - s0);
        for (int i = tx; i < st; i += THREADS) cnt_s[i] = 0;
        __syncthreads();
        if (tx < 32) {  // ranks in time order, 32 frames a step
            for (int t0 = 0; t0 < T; t0 += 32) {
                const int t = t0 + tx;
                const int sid = t < T ? w.fsid[bt + t] : -1;
                const int key = (sid >= s0 && sid < s0 + st) ? sid - s0 : -1;
                const unsigned mask = __match_any_sync(0xffffffffu, key);
                const unsigned lt = mask & lanemask_lt();
                const int base = key >= 0 ? cnt_s[key] : 0;
                __syncwarp();
                if (key >= 0 && lt == 0) cnt_s[key] = base + __popc(mask);
                __syncwarp();
                if (key >= 0) w.frank[bt + t] = base + __popc(lt);
            }
        }
        __syncthreads();
        for (int i = tx; i < st; i += THREADS) w.seg_cnt[bs + s0 + i] = cnt_s[i];
        __syncthreads();
    }
}

// 2. group: one block
__global__ void __launch_bounds__(GROUP_THREADS) fold_group_kernel(
    const int32_t* __restrict__ state_pdf,  // (B, S)
    Ws w, int BS, int P)
{
    __shared__ int run_s[PDF_TILE];
    __shared__ int ent_s[GROUP_THREADS];
    __shared__ int key_s[GROUP_THREADS];
    __shared__ int warp_s[32];
    const int tx = threadIdx.x;

    const int nt = GROUP_THREADS;
    int nseg = 0, nused = 0;  // the same in every thread

    for (int p0 = 0; p0 < P; p0 += PDF_TILE) {
        const int pt = min(PDF_TILE, P - p0);
        for (int i = tx; i < pt; i += nt) run_s[i] = 0;
        __syncthreads();
        for (int e0 = tx; e0 < BS; e0 += 4 * nt) {  // 4 loads in flight a thread
            int c[4], p[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int e = e0 + r * nt;
                c[r] = e < BS ? w.seg_cnt[e] : 0;
                p[r] = e < BS ? state_pdf[e] - p0 : -1;
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                if (c[r] > 0 && p[r] >= 0 && p[r] < pt) atomicAdd(&run_s[p[r]], 1);
            }
        }
        __syncthreads();
        // segments per pdf -> each pdf's first slot in seglist; used pdfs
        for (int i0 = 0; i0 < pt; i0 += nt) {
            const int i = i0 + tx;
            const int v = i < pt ? run_s[i] : 0;
            int total, ftotal;
            const int incl = block_scan(v, &total, warp_s);
            const int fincl = block_scan(v > 0, &ftotal, warp_s);
            if (i < pt) {
                w.pdf_nseg[p0 + i] = v;
                run_s[i] = nseg + incl - v;
                if (v > 0) {
                    const int u = nused + fincl - 1;
                    w.used_pdf[u] = p0 + i;
                    w.used_sbase[u] = nseg + incl - v;
                }
            }
            nseg += total;
            nused += ftotal;
        }
        __syncthreads();
        // place the tile's segments in (b, s) order
        for (int e0 = 0; e0 < BS; e0 += nt) {
            const int e = e0 + tx;
            const int c = e < BS ? w.seg_cnt[e] : 0;
            const int p = e < BS ? state_pdf[e] - p0 : -1;
            const int key = (c > 0 && p >= 0 && p < pt) ? p : -1;
            int n;
            const int pos = block_scan(key >= 0, &n, warp_s);
            if (key >= 0) {
                ent_s[pos - 1] = e;
                key_s[pos - 1] = key;
            }
            __syncthreads();
            if (tx < 32) {
                for (int j0 = 0; j0 < n; j0 += 32) {
                    const int j = j0 + tx;
                    const int k = j < n ? key_s[j] : -1;
                    const unsigned mask = __match_any_sync(0xffffffffu, k);
                    const unsigned lt = mask & lanemask_lt();
                    const int base = k >= 0 ? run_s[k] : 0;
                    __syncwarp();
                    if (k >= 0 && lt == 0) run_s[k] = base + __popc(mask);
                    __syncwarp();
                    if (k >= 0) w.seglist[base + __popc(lt)] = ent_s[j];
                }
            }
            __syncthreads();
        }
    }
    // each segment's first position in the frames sorted by (pdf, b, t)
    int nframes = 0;
    for (int i0 = 0; i0 < nseg; i0 += nt) {
        const int i = i0 + tx;
        const int seg = i < nseg ? w.seglist[i] : -1;
        const int c = seg >= 0 ? w.seg_cnt[seg] : 0;
        int total;
        const int incl = block_scan(c, &total, warp_s);
        if (seg >= 0) w.seg_goff[seg] = nframes + incl - c;
        nframes += total;
    }
    __syncthreads();
    for (int u = tx; u < nused; u += nt) {
        w.used_fbase[u] = w.seg_goff[w.seglist[w.used_sbase[u]]];
    }
    __syncthreads();
    // the fold takes its items in uorder: the used pdfs by descending
    // power of two of their frames, so the longest chains start first
    // (which block takes which item changes no result)
    int* bucket_s = warp_s;  // 32 counters, then cursors
    if (tx < 32) bucket_s[tx] = 0;
    __syncthreads();
    for (int u = tx; u < nused; u += nt) {
        const int nf = (u + 1 < nused ? w.used_fbase[u + 1] : nframes) - w.used_fbase[u];
        w.used_fcnt[u] = nf;
        atomicAdd(&bucket_s[__clz(nf)], 1);
    }
    __syncthreads();
    if (tx < 32) {
        const int c = bucket_s[tx];
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int n = __shfl_up_sync(0xffffffffu, incl, o);
            if (tx >= o) incl += n;
        }
        bucket_s[tx] = incl - c;
    }
    __syncthreads();
    for (int u = tx; u < nused; u += nt) {
        w.uorder[atomicAdd(&bucket_s[__clz(w.used_fcnt[u])], 1)] = u;
    }
    if (tx == 0) {
        w.hdr[0] = nused;
        w.hdr[1] = nframes;
        w.hdr[2] = nseg;
        w.hdr[3] = 0;
        w.hdr[4] = 0;
    }
}

// 3. place: a block per utterance
__global__ void __launch_bounds__(THREADS) fold_place_kernel(
    Ws w,
    float* __restrict__ ll_out,      // (B, S) out: states without frames
    float* __restrict__ frames_out,  // (B, S) out
    int S, int T)
{
    const int tx = threadIdx.x;
    const int b = blockIdx.x;
    const size_t bt = (size_t)b * T, bs = (size_t)b * S;
    for (int t = tx; t < T; t += THREADS) {
        const int sid = w.fsid[bt + t];
        if (sid >= 0) w.order[w.seg_goff[bs + sid] + w.frank[bt + t]] = (int)(bt + t);
    }
    for (int s = tx; s < S; s += THREADS) {
        if (w.seg_cnt[bs + s] == 0) {
            ll_out[bs + s] = 0.f;
            frames_out[bs + s] = 0.f;
        }
    }
}

// sorted positions a score block takes (fewer where its rows would not
// fit), and frames a score thread scores at once, for one component
constexpr int SCORE_CH = 64;
constexpr int SCORE_FRAMES = 8;
constexpr int SCORE_THREADS = 256;

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int score_chunk(int K, int D) {
    const size_t fixed = (size_t)K * (2 * D + 1) * 4;
    if (fixed >= khg::SMEM_LIMIT) return 0;
    const size_t fit = (khg::SMEM_LIMIT - fixed) / ((size_t)(pad4(D) + K + 7) * 4);
    return fit < (size_t)SCORE_CH ? (int)fit : SCORE_CH;
}

// a score block: sorted positions (chs), components staged at once (kc),
// and where the scores live.  The whole pdf with its scores in shared
// memory where one position fits beside its K model rows (score_chunk);
// otherwise up to 64 positions' rows in at most half the block (at
// least one), the scores in the float workspace, and the model rows in
// chunks of what fits beside them.
struct ScorePlan {
    int chs, kc;
    bool scores_in_smem;
};

__host__ inline ScorePlan score_plan(int K, int D) {
    const int whole = score_chunk(K, D);
    if (whole >= 1) return {whole, K, true};
    const size_t row = (size_t)(2 * D + 1) * 4, pos = (size_t)(pad4(D) + 7) * 4;
    size_t chs = khg::SMEM_LIMIT / 2 / pos;
    if (chs > (size_t)SCORE_CH) chs = SCORE_CH;
    if (chs < 1) chs = 1;
    if (chs * pos + row > khg::SMEM_LIMIT) return {0, 0, false};
    size_t kc = (khg::SMEM_LIMIT - chs * pos) / row;
    if (kc > (size_t)K) kc = K;
    return {(int)chs, (int)kc, false};
}

// loads a thread keeps in flight while staging rows into shared memory
constexpr int STAGE_BATCH = 8;

// the model rows of components [k0, k0 + nk) of pdf into m_s (nk rows
// of miv | -iv/2 | g); they are contiguous, read STAGE_BATCH elements a
// thread at a time
__device__ __forceinline__ void stage_model(
    float* m_s, const float* __restrict__ gconsts, const float* __restrict__ miv,
    const float* __restrict__ iv, int pdf, int k0, int nk, int K, int D)
{
    const int Q2 = 2 * D + 1;
    const int n = nk * D;
    const int nt = blockDim.x;
    const float* mp = miv + ((size_t)pdf * K + k0) * D;
    const float* ip = iv + ((size_t)pdf * K + k0) * D;
    for (int i0 = threadIdx.x; i0 < n; i0 += STAGE_BATCH * nt) {
        float a[STAGE_BATCH], c[STAGE_BATCH];
#pragma unroll
        for (int r = 0; r < STAGE_BATCH; ++r) {
            const int i = i0 + r * nt;
            a[r] = i < n ? mp[i] : 0.f;
            c[r] = i < n ? ip[i] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < STAGE_BATCH; ++r) {
            const int i = i0 + r * nt;
            if (i < n) {
                const int k = i / D;
                const int q = i - k * D;
                m_s[k * Q2 + q] = a[r];
                m_s[k * Q2 + D + q] = -0.5f * c[r];
            }
        }
    }
    for (int k = threadIdx.x; k < nk; k += nt) {
        m_s[k * Q2 + 2 * D] = fmaxf(gconsts[(size_t)pdf * K + k0 + k], -1.0e30f);  // -inf padding -> finite
    }
}

// SCORE_FRAMES dots of one component: [x, x^2] . mr in q order, each an
// fmaf chain from 0; x rows are 16-byte aligned, read 4 floats at a time
template <bool SQUARE>
__device__ __forceinline__ void score_dots(float (&dot)[SCORE_FRAMES],
                                           const float* const (&xr)[SCORE_FRAMES],
                                           const float* mr, int D)
{
    const int D4 = D & ~3;
    for (int q = 0; q < D4; q += 4) {
        const float m0 = mr[q], m1 = mr[q + 1], m2 = mr[q + 2], m3 = mr[q + 3];
#pragma unroll
        for (int r = 0; r < SCORE_FRAMES; ++r) {
            float4 x = *reinterpret_cast<const float4*>(xr[r] + q);
            if (SQUARE) {
                x.x = __fmul_rn(x.x, x.x);
                x.y = __fmul_rn(x.y, x.y);
                x.z = __fmul_rn(x.z, x.z);
                x.w = __fmul_rn(x.w, x.w);
            }
            dot[r] = fmaf(x.x, m0, dot[r]);
            dot[r] = fmaf(x.y, m1, dot[r]);
            dot[r] = fmaf(x.z, m2, dot[r]);
            dot[r] = fmaf(x.w, m3, dot[r]);
        }
    }
    for (int q = D4; q < D; ++q) {
        const float m = mr[q];
#pragma unroll
        for (int r = 0; r < SCORE_FRAMES; ++r) {
            const float x = SQUARE ? __fmul_rn(xr[r][q], xr[r][q]) : xr[r][q];
            dot[r] = fmaf(x, m, dot[r]);
        }
    }
}

// 4. score: one block per chs sorted positions, kc components' model
// rows staged at once; the scores in shared memory or (sc_in_smem = 0)
// at the posteriors' place in the float workspace.
__global__ void __launch_bounds__(SCORE_THREADS) fold_score_kernel(
    const float* __restrict__ gconsts,      // (P, K)
    const float* __restrict__ miv,          // (P, K, D)
    const float* __restrict__ iv,           // (P, K, D)
    const float* __restrict__ feats,        // (B, T, D)
    const int32_t* __restrict__ pdf_ids,    // (B, T)
    const float* __restrict__ weights,      // (B, T)
    Ws w, Fws f, int chs, int kc, int sc_in_smem, int K, int D)
{
    extern __shared__ __align__(16) float smem_score[];
    const int D2 = 2 * D;
    const int Q2 = D2 + 1;                  // model row: miv | -iv/2 | g
    const int XD = pad4(D);
    const int XR = row_floats(D);
    const int tx = threadIdx.x;
    const int lane = tx & 31, wid = tx >> 5;
    constexpr int NW = SCORE_THREADS / 32;
    const int CHS = chs;
    const int p0 = blockIdx.x * CHS;

    float* xs = smem_score;                 // CHS * XD frame rows (16-byte aligned)
    float* m_s = xs + CHS * XD;             // kc * Q2
    float* ws = m_s + (size_t)kc * Q2;      // CHS weights (after CHS * K scores)
    float* sc = f.post + (size_t)p0 * K;    // CHS * K
    if (sc_in_smem) {
        sc = ws;
        ws += CHS * K;
    }
    float* lw = ws + CHS;                   // CHS lse * w
    float* mz = lw + CHS;                   // CHS maxima
    float* zz = mz + CHS;                   // CHS sums
    int* fid_s = reinterpret_cast<int*>(zz + CHS);  // CHS frame indices b T + t
    int* pdf_s = fid_s + CHS;               // CHS pdfs
    int* first_s = pdf_s + CHS;             // CHS: a segment's first frame

    const int nfr = w.hdr[1];
    if (p0 >= nfr) return;
    const int nc = min(CHS, nfr - p0);
    for (int j = tx; j < nc; j += SCORE_THREADS) {
        const int fid = w.order[p0 + j];
        fid_s[j] = fid;
        pdf_s[j] = pdf_ids[fid];
        ws[j] = weights[fid];
        first_s[j] = w.frank[fid] == 0;
    }
    __syncthreads();
    // the frames' rows and the first run's model rows, loads in flight
    // together
    for (int i0 = tx; i0 < nc * D; i0 += STAGE_BATCH * SCORE_THREADS) {
        float v[STAGE_BATCH];
#pragma unroll
        for (int r = 0; r < STAGE_BATCH; ++r) {
            const int i = i0 + r * SCORE_THREADS;
            const int j = i / D;
            v[r] = i < nc * D ? feats[(size_t)fid_s[j] * D + (i - j * D)] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < STAGE_BATCH; ++r) {
            const int i = i0 + r * SCORE_THREADS;
            const int j = i / D;
            if (i < nc * D) xs[j * XD + (i - j * D)] = v[r];
        }
    }
    stage_model(m_s, gconsts, miv, iv, pdf_s[0], 0, min(kc, K), K, D);
    // runs of one pdf: its model rows (kc components at a time), then
    // its frames' scores, each thread SCORE_FRAMES frames of one component
    for (int ja = 0; ja < nc;) {
        const int pdf = pdf_s[ja];
        int jb = ja + 1;
        while (jb < nc && pdf_s[jb] == pdf) ++jb;
        const int ngroups = (jb - ja + SCORE_FRAMES - 1) / SCORE_FRAMES;
        for (int k0 = 0; k0 < K; k0 += kc) {
            const int nk = min(kc, K - k0);
            if (ja > 0 || k0 > 0) {
                __syncthreads();  // the previous model rows are free
                stage_model(m_s, gconsts, miv, iv, pdf, k0, nk, K, D);
            }
            __syncthreads();
            for (int tile = tx; tile < ngroups * nk; tile += SCORE_THREADS) {
                const int g = tile / nk;
                const int k = tile - g * nk;
                const float* mr = m_s + (size_t)k * Q2;
                const float* xr[SCORE_FRAMES];
                float dot[SCORE_FRAMES];
#pragma unroll
                for (int r = 0; r < SCORE_FRAMES; ++r) {
                    xr[r] = xs + min(ja + g * SCORE_FRAMES + r, jb - 1) * XD;
                    dot[r] = 0.f;
                }
                score_dots<false>(dot, xr, mr, D);
                score_dots<true>(dot, xr, mr + D, D);
#pragma unroll
                for (int r = 0; r < SCORE_FRAMES; ++r) {
                    const int j = ja + g * SCORE_FRAMES + r;
                    if (j < jb) sc[j * K + k0 + k] = dot[r] + mr[D2];
                }
            }
        }
        ja = jb;
    }
    __syncthreads();
    for (int j = tx; j < nc; j += SCORE_THREADS) {
        const float* r = sc + j * K;
        float mx = r[0];
        for (int k = 1; k < K; ++k) mx = fmaxf(mx, r[k]);
        float z = 0.f;
        for (int k = 0; k < K; ++k) z += expf(r[k] - mx);
        mz[j] = mx;
        zz[j] = z;
        lw[j] = (mx + logf(z)) * ws[j];
    }
    __syncthreads();
    for (int j = wid; j < nc; j += NW) {
        float* pr = f.post + (size_t)(p0 + j) * K;
        for (int k = lane; k < K; k += 32) pr[k] = expf(sc[j * K + k] - mz[j]) / zz[j] * ws[j];
        // the sorted row [x, first-frame flag, 0...]
        float* rr = f.rows + (size_t)(p0 + j) * XR;
        for (int q = lane; q < XR; q += 32) {
            rr[q] = q < D ? xs[j * XD + q] : (q == D && first_s[j]) ? 1.f : 0.f;
        }
    }
    for (int j = tx; j < nc; j += SCORE_THREADS) {
        f.lw[p0 + j] = lw[j];
        f.w[p0 + j] = ws[j];
    }
}

// groups of 4 components a fold slice spans, at most (times 4: the
// posteriors a staged frame holds), and frames a fold block stages at a
// time: CH, fewer for rows that long would not fit two buffers
__host__ __device__ inline int fold_nk(int K, int Q) {
    const int nk = 4 * ((THREADS - 1) / Q + 2);
    const int k4 = (K + 3) & ~3;
    return nk < k4 ? nk : k4;
}

__host__ __device__ inline int fold_chunk(int K, int D) {
    const size_t per_frame = NSTAGE * (size_t)(row_floats(D) + fold_nk(K, 2 * D + 1)) * 4;
    const size_t fit = khg::SMEM_LIMIT / per_frame;
    return fit < (size_t)CH ? (int)fit : CH;
}

// 5. fold: persistent blocks over the items.  A fold thread owns one
// row entry q of 4 consecutive components: per frame one x, one 16-byte
// read of the 4 posteriors, 4 multiplies and 4 adds
__global__ void __launch_bounds__(THREADS) fold_fold_kernel(
    Ws w, Fws f,
    float* __restrict__ out,         // (P, K, Q) out
    float* __restrict__ ll_out,      // (B, S) out
    float* __restrict__ frames_out,  // (B, S) out
    int P, int K, int D, int chunk)
{
    extern __shared__ __align__(16) float smem_fold[];
    const int Q = 2 * D + 1;
    const int XR = row_floats(D);
    const int nkm = fold_nk(K, Q);
    float* xb = smem_fold;                   // [NSTAGE][chunk * XR]
    float* pb = xb + NSTAGE * chunk * XR;    // [NSTAGE][chunk * nkm]
    const int tx = threadIdx.x;
    const int npairs = (K + 3) / 4 * Q;      // (group of 4 components, q)
    const int nslices = (npairs + THREADS - 1) / THREADS;
    const int span = (npairs + nslices - 1) / nslices;
    const int nused = w.hdr[0];
    const int nfold = nused * nslices;
    const int nseg_items = nfold + w.hdr[2];
    const int nitems = nseg_items + (P + ZERO_PDFS - 1) / ZERO_PDFS;
    __shared__ int item_s;

    for (;;) {  // items taken in turn from a counter (an int atomic)
        if (tx == 0) item_s = atomicAdd(&w.hdr[3], 1);
        __syncthreads();
        const int it = item_s;
        __syncthreads();
        if (it >= nitems) break;
        if (it >= nseg_items) {  // the zero rows of unused pdfs
            const int KQ = K * Q;
            const int z0 = (it - nseg_items) * ZERO_PDFS;
            for (int p = z0; p < min(P, z0 + ZERO_PDFS); ++p) {
                if (w.pdf_nseg[p] != 0) continue;
                float* o = out + (size_t)p * KQ;
                if ((KQ & 3) == 0) {
                    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
                    for (int i = tx; i < KQ / 4; i += THREADS) reinterpret_cast<float4*>(o)[i] = z;
                } else {
                    for (int i = tx; i < KQ; i += THREADS) o[i] = 0.f;
                }
            }
            continue;
        }
        if (it >= nfold) {  // a segment: Σ lse * w and Σ w in time order
            const int seg = w.seglist[it - nfold];
            const int g0 = w.seg_goff[seg];
            const int n = w.seg_cnt[seg];
            const int cap = chunk * XR;      // frames a piece stages
            float* lws = xb;
            float* wws = xb + cap;
            float ll_acc = 0.f, fr_acc = 0.f;
            for (int j0 = 0; j0 < n; j0 += cap) {
                const int nc = min(cap, n - j0);
                __syncthreads();
                for (int j = tx; j < nc; j += THREADS) {
                    lws[j] = f.lw[g0 + j0 + j];
                    wws[j] = f.w[g0 + j0 + j];
                }
                __syncthreads();
                if (tx == 0) {
                    for (int j = 0; j < nc; ++j) {
                        ll_acc += lws[j];
                        fr_acc += wws[j];
                    }
                }
            }
            if (tx == 0) {
                ll_out[seg] = ll_acc;
                frames_out[seg] = fr_acc;
            }
            __syncthreads();  // the staging buffer is reused
            continue;
        }
        const int u = w.uorder[it / nslices];
        const int i0 = (it % nslices) * span;
        const int i_end = min(i0 + span, npairs);
        const int g_lo = i0 / Q;
        const int k_lo = 4 * g_lo;
        const int nk = min(K, 4 * ((i_end - 1) / Q + 1)) - k_lo;
        const int idx = i0 + tx;
        const bool valid = idx < i_end;
        const int g = valid ? idx / Q : g_lo;
        const int q = valid ? idx - g * Q : 0;
        // row entry q: 1 (q = 0), x[q - 1] (q <= D) or x[q - 1 - D]^2
        const int xcol = q == 0 ? 0 : (q <= D ? q - 1 : q - 1 - D);
        const bool one = q == 0, square = q > D;
        const int poff = 4 * (g - g_lo);
        const int fb = w.used_fbase[u];
        const int nf = w.used_fcnt[u];
        const int nch = (nf + chunk - 1) / chunk;

        // chunk c of the pdf's frames into buffer c % NSTAGE
        auto issue = [&](int c) {
            if (c < nch) {
                const int f0 = fb + c * chunk;
                const int nc = min(chunk, nf - c * chunk);
                float* xd = xb + (c % NSTAGE) * chunk * XR;
                float* pd = pb + (c % NSTAGE) * chunk * nkm;
                const float* xsrc = f.rows + (size_t)f0 * XR;
                for (int i = tx; i < nc * XR / 4; i += THREADS) {
                    khg::cp_async16(xd + 4 * i, xsrc + 4 * i);
                }
                for (int i = tx; i < nc * nk; i += THREADS) {
                    const int j = i / nk;
                    const int c2 = i - j * nk;
                    khg::cp_async4(pd + j * nkm + c2, f.post + (size_t)(f0 + j) * K + k_lo + c2);
                }
            }
            khg::cp_async_commit();
        };

        float tot[4], part[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) tot[r] = part[r] = 0.f;
#pragma unroll
        for (int c = 0; c < NSTAGE - 1; ++c) issue(c);
        for (int c = 0; c < nch; ++c) {
            issue(c + NSTAGE - 1);
            khg::cp_async_wait<NSTAGE - 1>();
            __syncthreads();
            const int nc = min(chunk, nf - c * chunk);
            const float* xr = xb + (c % NSTAGE) * chunk * XR;
            const float* pr = pb + (c % NSTAGE) * chunk * nkm + poff;
            // bit j: frame j starts a segment (chunk <= 32 frames)
            const unsigned starts = __ballot_sync(
                0xffffffffu, (tx & 31) < nc && xr[(tx & 31) * XR + D] != 0.f);
            for (int j = 0; j < nc;) {
                if ((starts >> j) & 1u) {
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        tot[r] = __fadd_rn(tot[r], part[r]);
                        part[r] = 0.f;
                    }
                }
                const unsigned later = j + 1 < 32 ? starts >> (j + 1) : 0u;
                const int e = later ? min(nc, j + __ffs(later)) : nc;
#pragma unroll 4
                for (; j < e; ++j) {
                    const float xv = xr[j * XR + xcol];
                    const float x = one ? 1.f : square ? __fmul_rn(xv, xv) : xv;
                    const float4 p4 = *reinterpret_cast<const float4*>(pr + j * nkm);
                    part[0] = __fadd_rn(part[0], __fmul_rn(p4.x, x));
                    part[1] = __fadd_rn(part[1], __fmul_rn(p4.y, x));
                    part[2] = __fadd_rn(part[2], __fmul_rn(p4.z, x));
                    part[3] = __fadd_rn(part[3], __fmul_rn(p4.w, x));
                }
            }
            __syncthreads();  // buffer c % NSTAGE is refilled at c + NSTAGE
        }
        if (valid) {
            float* o = out + ((size_t)w.used_pdf[u] * K + 4 * g) * Q + q;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                if (4 * g + r < K) o[(size_t)r * Q] = __fadd_rn(tot[r], part[r]);
            }
        }
    }
    // the last block out resets the item counter, so the launch can be
    // repeated on the same workspace
    if (tx == 0 && atomicAdd(&w.hdr[4], 1) == (int)gridDim.x - 1) {
        w.hdr[3] = 0;
        w.hdr[4] = 0;
    }
}

size_t score_smem_bytes(int K, int D) {
    const ScorePlan sp = score_plan(K, D);
    const size_t ch = sp.chs;
    return (ch * pad4(D) + (size_t)sp.kc * (2 * D + 1)
            + ch * ((sp.scores_in_smem ? (size_t)K : 0) + 4)) * 4 + 3 * ch * 4;
}

size_t fold_smem_bytes(int K, int D) {
    return NSTAGE * (size_t)fold_chunk(K, D) * (row_floats(D) + fold_nk(K, 2 * D + 1)) * 4;
}

}  // namespace

// 1 - 3: each frame's segment, the segments grouped by pdf, each frame
// at its sorted position; the zero ll, frames of states without frames
extern "C" int launch_stats_fold_group(
    const void* pdf_ids, const void* weights, const void* state_pdf,
    void* iws, void* ll_out, void* frames_out,
    int B, int S, int T, int P, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const Ws w = fold_ws(iws, B, S, T, P);
    cudaError_t err;
    if (B > 0) {
        fold_match_kernel<<<B, THREADS, 0, st>>>(
            (const int32_t*)pdf_ids, (const float*)weights,
            (const int32_t*)state_pdf, w, S, T);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    fold_group_kernel<<<1, GROUP_THREADS, 0, st>>>((const int32_t*)state_pdf, w, B * S, P);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (B == 0) return 0;
    fold_place_kernel<<<B, THREADS, 0, st>>>(
        w, (float*)ll_out, (float*)frames_out, S, T);
    return (int)cudaGetLastError();
}

// 4: scores, posteriors and the sorted rows
extern "C" int launch_stats_fold_score(
    const void* gconsts, const void* miv, const void* iv, const void* feats,
    const void* pdf_ids, const void* weights, void* iws, void* fws,
    int B, int S, int T, int P, int K, int D, void* stream)
{
    const ScorePlan sp = score_plan(K, D);
    const size_t smem = score_smem_bytes(K, D);
    if (sp.chs < 1 || smem > khg::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fold_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (int)(((size_t)B * T + sp.chs - 1) / sp.chs);
    if (blocks == 0) return 0;
    fold_score_kernel<<<blocks, SCORE_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)gconsts, (const float*)miv, (const float*)iv,
        (const float*)feats, (const int32_t*)pdf_ids, (const float*)weights,
        fold_ws(iws, B, S, T, P), fold_fws(fws, B, T, K, D), sp.chs, sp.kc,
        sp.scores_in_smem ? 1 : 0, K, D);
    return (int)cudaGetLastError();
}

// 5: the (P, K, 2D+1) stats and the (B, S) sums
extern "C" int launch_stats_fold_fold(
    const void* iws, void* fws, void* out, void* ll_out, void* frames_out,
    int B, int S, int T, int P, int K, int D, void* stream)
{
    const int chunk = fold_chunk(K, D);
    if (chunk < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = fold_smem_bytes(K, D);
    cudaError_t err = cudaFuncSetAttribute(
        fold_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (P == 0 && B * S == 0) return 0;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fold_fold_kernel, THREADS, smem)) != cudaSuccess)
        return (int)err;
    fold_fold_kernel<<<sms * (per_sm > 0 ? per_sm : 1), THREADS, smem, (cudaStream_t)stream>>>(
        fold_ws((void*)iws, B, S, T, P), fold_fws(fws, B, T, K, D), (float*)out,
        (float*)ll_out, (float*)frames_out, P, K, D, chunk);
    return (int)cudaGetLastError();
}
