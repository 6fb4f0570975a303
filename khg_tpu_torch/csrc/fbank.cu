// Fused waveform -> log-mel fbank frontend for Hopper (sm_90a), on the
// tensor cores in split TF32.
//
// Replaces khg_tpu/features/pallas_fbank.py::_fbank_kernel (called
// through compute_fbank_pallas).  DC removal, pre-emphasis, windowing
// and the real DFT are linear maps on a frame, folded on the host (in
// f64) into two (frame_len, F) f32 matrices; per frame t of the
// reflect-padded wave
//
//   re, im  = frame_t @ M_re, frame_t @ M_im
//   power   = re^2 + im^2   (or its sqrt)
//   feats   = log(max(power @ mel^T, FLT_MIN))
//   energy  = log(max(sum f^2 - (sum f)^2 / frame_len, FLT_MIN))
//
// What bounds it on the H100: the tensor cores' operations.  The TPU
// kernel takes the two products on its matrix unit at
// Precision.HIGHEST, a multi-pass product of split operands; here they
// are wgmma TF32 products (m64n32k8, A from registers, B from shared
// memory) with f32 sums.  One TF32 product
// keeps ~11 bits and misses the f32 plain version by up to ~3 on
// integer WAV frames; three products of two-way splits still miss it by
// 1.5e-3 on full-mantissa frames.  Both operands are therefore split
// into three TF32 parts (hi, mid, lo; they sum to the f32 value), and
// the six products of frame part i and table part j with i + j <= 2 are
// taken: that reproduces the product of the f32 operands (what is left
// is the f32 rounding of the sums, as in the plain version).  A WAV's
// integer samples have no lo part: a block whose wave span has none
// skips the lo-frame product, which changes no bit.
//
// Design: one block of two warpgroups per (utterance, 64 frames).
// - The block's wave span ((frames - 1) * shift + kp samples) comes into
//   shared memory once, by 4-byte cp.async (a 44.1 kHz row of 441
//   samples is not 16-byte aligned), as rows of `shift` samples at a
//   padded stride = 4 (mod 8): frame t's sample k lies at
//   (t + k / shift) * stride + k % shift, so the 8 frames x 4 samples of
//   an A fragment fall in 32 different banks.
// - The table holds Re and Im of each bin that a mel filter weighs side
//   by side (column 2q Re, 2q + 1 Im), split into its three parts on the
//   host and laid out as wgmma's K-major B operand without swizzle (8
//   columns x 4 rows a core matrix).  Chunks of 64 columns (32 bins) run
//   in turn; within a chunk K runs over the frame in steps of 8, and the
//   table's stages (16 rows x 64 columns x 3 parts, 12 KB) come
//   through a three-stage cp.async ring, two stages in flight, one
//   barrier a stage.  Each warpgroup takes all 64 frames and half the
//   chunk's columns: each warp splits its 16 frames' A fragment in
//   registers (cvt.rna.tf32.f32, subtract, again), and the warpgroup
//   issues a k-step's five or six wgmmas at once, hi x hi into one
//   accumulator, the smaller products into another.
// - A chunk's epilogue: Re and Im of a bin sit in one thread's
//   accumulator pair (the D fragment's columns 2c, 2c + 1), so the power
//   is taken in registers and written to shared memory (bin-major); then
//   each (filter, frame) of the filters that the chunk feeds adds the
//   chunk's bins in the filter's nonzero range to its sum in shared
//   memory, a warp per filter and 32 frames.  No spectrum goes to device
//   memory.  After the last chunk come the log and the stores, and the
//   raw log energy from the wave span (a warp a frame).
//
// The host side (features/fbank_kernel.py: fbank_plan, kernel_tables,
// fragment_order) mirrors the shared-memory request and builds the
// table.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int KSTEPS = 2;                    // mma k-steps per ring stage
constexpr int STAGES = 3;                    // ring depth: two stages in flight
constexpr int STAGE_K = 8 * KSTEPS;          // table rows per stage
constexpr int CHUNK = 64;                    // table columns per chunk
constexpr int NT = CHUNK / 8;                // 8-column tiles per chunk
constexpr int STAGE_FLOATS = KSTEPS * 3 * NT * 64;
constexpr int PW_PAD = 8;                    // power row of a bin: frames + 8
constexpr size_t SMEM_LIMIT = 232448;
constexpr int FB = 64;                       // frames a block: wgmma's M
constexpr int B_LBO = 128;                   // table stage: core matrices along K
constexpr int B_SBO = 256;                   // ... and along N

__device__ __forceinline__ uint32_t to_tf32(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }

template <bool B>
struct Flag {
    static constexpr bool value = B;
};

// the third TF32 part of x (0 for an integer of up to 16 bits)
__device__ __forceinline__ uint32_t lo_part(float x)
{
    const float r1 = __fsub_rn(x, __uint_as_float(to_tf32(x)));
    return to_tf32(__fsub_rn(r1, __uint_as_float(to_tf32(r1))));
}

__device__ __forceinline__ void cp_wait_all_but_one()
{
    asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__host__ __device__ __forceinline__ int span_floats(int frames, int shift, int kp, int stride)
{
    const int rows = frames + (kp - 1) / shift;
    return (rows * stride + 3) / 4 * 4;  // the ring after it is 16-byte aligned
}

size_t smem_bytes(int frames, int shift, int kp, int stride, int M)
{
    return 4 * ((size_t)span_floats(frames, shift, kp, stride) + STAGES * STAGE_FLOATS +
                (size_t)(CHUNK / 2) * (frames + PW_PAD) + (size_t)M * (frames + 1));
}

// the descriptor of a K-major operand in shared memory without swizzle:
// core matrices of 8 rows x 16 bytes, B_LBO bytes apart along K and
// B_SBO bytes apart along N
__device__ __forceinline__ uint64_t b_desc(const float* p)
{
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(B_LBO >> 4) << 16) |
           ((uint64_t)(B_SBO >> 4) << 32);
}

// d += a * B on the warpgroup's 64 x 32 x 8 tile, a from registers
__device__ __forceinline__ void wgmma_tf32(float (&d)[4][4], const uint32_t (&a)[4],
                                           uint64_t desc)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// one k-step's products on the warpgroup's 64 frames x 32 columns: hi x
// hi into acc, the smaller ones into cor (LO: the frames have lo parts).
// st: the k-step's three table parts, 64 columns x 8 rows each.
template <bool LO>
__device__ __forceinline__ void products(float (&acc)[4][4], float (&cor)[4][4],
                                         const uint32_t (&ah)[4], const uint32_t (&am)[4],
                                         const uint32_t (&al)[4], const float* st)
{
    const uint64_t dh = b_desc(st), dm = b_desc(st + 512), dl = b_desc(st + 1024);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    wgmma_tf32(acc, ah, dh);
    wgmma_tf32(cor, ah, dl);
    wgmma_tf32(cor, am, dm);
    wgmma_tf32(cor, ah, dm);
    wgmma_tf32(cor, am, dh);
    if (LO) wgmma_tf32(cor, al, dh);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// two warpgroups, each on all 64 frames x half a chunk's columns
__global__ void __launch_bounds__(THREADS, 3) fbank_kernel(
    const float* __restrict__ wave,     // (B, L) reflect-padded samples
    const float* __restrict__ table,    // (kp/8, 3, ncols/16, 32, 4) TF32 parts
    const float* __restrict__ mel_w,    // (M, nbins) weights of the used bins
    const int2* __restrict__ mel_rng,   // (M) nonzero range [lo, hi) of each filter
    const int2* __restrict__ chunk_rng, // (ncols / CHUNK) filters [lo, hi) a chunk feeds
    float* __restrict__ feats,          // (B, T, M)
    float* __restrict__ energy,         // (B, T)
    int L, int T, int shift, int flen, int kp, int stride, int ncols, int nbins,
    int M, int remove_dc, int use_power, int use_log, float log_energy_floor)
{
    constexpr int WNT = NT / 2;           // 8-column tiles per warpgroup
    extern __shared__ float4 smem4[];
    float* span = reinterpret_cast<float*>(smem4);
    float* ring = span + span_floats(FB, shift, kp, stride);
    constexpr int PW_LD = FB + PW_PAD;    // = 8 (mod 32): no bank conflicts
    constexpr int MACC_LD = FB + 1;
    float* pw = ring + STAGES * STAGE_FLOATS;  // (CHUNK / 2, PW_LD) a chunk's power
    float* macc = pw + (CHUNK / 2) * PW_LD;    // (M, MACC_LD) mel sums

    const int b = blockIdx.y;
    const int t0 = blockIdx.x * FB;
    const int nt = min(FB, T - t0);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2;      // fragment row group
    const int q = lane & 3;       // thread in group
    const int wm = warp & 3;      // frames [wm * 16, +16) of its warpgroup's A
    const int wn = warp >> 2;     // warpgroup: tiles [wn * WNT, +WNT) of a chunk

    // the wave span, zero past the end of the row
    const int rows = FB + (kp - 1) / shift;
    {
        const float* src = wave + (size_t)b * L + (size_t)t0 * shift;
        const long avail = (long)L - (long)t0 * shift;
        for (int i = tid; i < rows * shift; i += THREADS) {
            const int r = i / shift;
            float* dst = span + r * stride + (i - r * shift);
            if (i < avail)
                cp_async4(dst, src + i);
            else
                *dst = 0.f;
        }
    }

    for (int i = tid; i < M * MACC_LD; i += THREADS) macc[i] = 0.f;

    const int nchunks = ncols / CHUNK;
    const int nst = kp / STAGE_K;
    const int total = nchunks * nst;
    const int nj = ncols / 8;
    // stage gs = (chunk, K stage): KSTEPS x 3 runs of NT tiles, each run
    // contiguous in the fragment-ordered table
    auto issue = [&](int gs) {
        const int c = gs / nst;
        const int s = gs - c * nst;
        float* dst = ring + (gs % STAGES) * STAGE_FLOATS;
        for (int i = tid; i < STAGE_FLOATS / 4; i += THREADS) {
            const int run = i / (NT * 16);
            const int w = i - run * (NT * 16);
            cp_async16(dst + run * NT * 64 + w * 4,
                       table + ((size_t)(s * KSTEPS * 3 + run) * nj + c * NT) * 64 + w * 4);
        }
    };
    issue(0);
    cp_commit();  // group 0: the span and the first stage
    if (total > 1) issue(1);
    cp_commit();

    // does any frame sample of the block have a third TF32 part?  (-0
    // counts as 0)  If none does, the lo-frame product is skipped: it
    // would add only zeros.
    cp_wait_all_but_one();
    __syncthreads();
    uint32_t any_lo = 0;
    for (int i = tid; i < rows * shift; i += THREADS) {
        const int r = i / shift;
        any_lo |= lo_part(span[r * stride + (i - r * shift)]) << 1;
    }
    const bool has_lo = __syncthreads_or(any_lo != 0);

    const float* frow = span + (wm * 16 + g) * stride;
    auto chunks = [&](auto lo_flag) {
    constexpr bool LO = decltype(lo_flag)::value;
    for (int c = 0; c < nchunks; ++c) {
        float acc[WNT][4], cor[WNT][4];
#pragma unroll
        for (int ni = 0; ni < WNT; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[ni][r] = cor[ni][r] = 0.f;
        // sample k = q (+4) of the frame: its column in its span row and
        // its offset from the frame's first sample
        int col_a = q, off_a = q;
        int col_b = q + 4, off_b = q + 4;
        for (int s = 0; s < nst; ++s) {
            const int gs = c * nst + s;
            cp_wait_all_but_one();  // stage gs has landed
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for wgmma
            __syncthreads();        // ... for all, and stage gs - 1 is done
            if (gs + 2 < total) issue(gs + 2);  // into the slot of gs - 1
            cp_commit();
            const float* st = ring + (gs % STAGES) * STAGE_FLOATS;
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk) {
                uint32_t ah[4], am[4], al[4] = {0, 0, 0, 0};
                {
                    const float x[4] = {frow[off_a], frow[8 * stride + off_a], frow[off_b],
                                        frow[8 * stride + off_b]};
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        ah[r] = to_tf32(x[r]);
                        const float r1 = __fsub_rn(x[r], __uint_as_float(ah[r]));
                        am[r] = to_tf32(r1);
                        if (LO) al[r] = to_tf32(__fsub_rn(r1, __uint_as_float(am[r])));
                    }
                }
                products<LO>(acc, cor, ah, am, al, st + kk * 3 * NT * 64 + wn * WNT * 64);
                // next k-step: 8 samples on, wrapping to the next span row
                col_a += 8;
                off_a += 8;
                if (col_a >= shift) {
                    col_a -= shift;
                    off_a += stride - shift;
                }
                col_b += 8;
                off_b += 8;
                if (col_b >= shift) {
                    col_b -= shift;
                    off_b += stride - shift;
                }
            }
        }

        // the chunk's power: D fragment columns 2q, 2q + 1 are Re, Im of
        // bin j * 4 + q of the chunk, rows g and g + 8
#pragma unroll
        for (int ni = 0; ni < WNT; ++ni) {
            const int bin = (wn * WNT + ni) * 4 + q;
            const int f0 = wm * 16 + g;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float re = __fadd_rn(acc[ni][2 * h], cor[ni][2 * h]);
                const float im = __fadd_rn(acc[ni][2 * h + 1], cor[ni][2 * h + 1]);
                const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
                pw[bin * PW_LD + f0 + 8 * h] = use_power ? p : sqrtf(p);
            }
        }
        __syncthreads();
        // each (filter, frame) of the filters this chunk feeds adds the
        // chunk's bins in the filter's nonzero range; a warp takes 32
        // frames of one filter (weights broadcast, power rows conflict-free)
        const int q0 = c * (CHUNK / 2);
        const int2 cr = chunk_rng[c];
        for (int i = tid; i < (cr.y - cr.x) * FB; i += THREADS) {
            const int m = cr.x + i / FB;
            const int t = i % FB;
            const int2 r = mel_rng[m];
            const int hi = min(r.y, q0 + CHUNK / 2);
            const float* w = mel_w + (size_t)m * nbins;
            float a = macc[m * MACC_LD + t];
            for (int k = max(r.x, q0); k < hi; ++k)
                a = fmaf(pw[(k - q0) * PW_LD + t], __ldg(w + k), a);
            macc[m * MACC_LD + t] = a;
        }
        // pw and macc are next touched after the next chunk's stage barriers
    }
    };
    if (has_lo)
        chunks(Flag<true>());
    else
        chunks(Flag<false>());
    __syncthreads();

    for (int i = tid; i < nt * M; i += THREADS) {
        const int t = i / M;
        float a = macc[(i - t * M) * MACC_LD + t];
        if (use_log) a = logf(fmaxf(a, FLT_MIN));
        feats[((size_t)b * T + t0) * M + i] = a;
    }

    // raw (post-DC, pre-window) log energy, a warp a frame
    for (int t = warp; t < nt; t += WARPS) {
        float s1 = 0.f, s2 = 0.f;
        for (int r = 0; r * shift < flen; ++r) {
            const float* row = span + (t + r) * stride;
            const int n = min(shift, flen - r * shift);
            for (int k = lane; k < n; k += 32) {
                const float v = row[k];
                s1 += v;
                s2 = fmaf(v, v, s2);
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
            s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (lane == 0) {
            const float e = remove_dc ? s2 - s1 * s1 * (1.0f / (float)flen) : s2;
            energy[(size_t)b * T + t0 + t] = fmaxf(logf(fmaxf(e, FLT_MIN)), log_energy_floor);
        }
    }
}

}  // namespace

extern "C" int launch_fbank(
    const void* wave, const void* table, const void* mel_w, const void* mel_rng,
    const void* chunk_rng, void* feats, void* energy, int B, int L, int T, int shift, int flen, int kp,
    int stride, int ncols, int nbins, int M, int remove_dc,
    int use_power, int use_log, float log_energy_floor, void* stream)
{
    if (shift < 8 || kp < flen || kp % STAGE_K ||
        ncols <= 0 || ncols % CHUNK || stride < shift || stride % 8 != 4 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(FB, shift, kp, stride, M);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0 || T == 0) return 0;
    dim3 grid((T + FB - 1) / FB, B);
    fbank_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)wave, (const float*)table, (const float*)mel_w,
        (const int2*)mel_rng, (const int2*)chunk_rng, (float*)feats, (float*)energy, L, T, shift, flen,
        kp, stride, ncols, nbins, M, remove_dc, use_power, use_log, log_energy_floor);
    return (int)cudaGetLastError();
}
