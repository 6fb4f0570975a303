"""Which shapes the banded kernels, the stats fold and the non-banded
Viterbi kernel take, on the CPU.

The banded Viterbi kernel (csrc/banded_viterbi.cu) and the banded
forward-backward kernels (csrc/banded_fb.cu) each have a compiled path
for the band widths of the main paths and a generic one for the rest.
Whether a batch goes to a kernel at all is decided from shapes alone
(``kernel_fits``, ``fb_kernel_fits``, ``fold_kernel_fits``): every shape
that the first ports' shared-memory formulas took must still be taken
(the fold now takes every K, staging a pdf's model rows in chunks of
components where they do not fit a score block whole),
and the Python mirrors of the launchers' shared-memory requests (and of
the stats fold's workspace, and of the fbank kernel's plan) must equal
the sizes worked out here from the .cu layouts.
"""

import pytest

from khg_tpu_torch.align.banded_fb import (
    fb_fwd_smem_bytes,
    fb_kernel_fits,
    fb_kernel_smem_bytes,
)
from khg_tpu_torch.align.banded_kernel import kernel_fits, kernel_smem_bytes
from khg_tpu_torch.align.viterbi_kernel import viterbi_plan, viterbi_smem_bytes
from khg_tpu_torch.features.fbank import FbankConfig
from khg_tpu_torch.features.fbank_kernel import (
    FRAMES,
    STAGE_K,
    fbank_cuda,
    fbank_plan,
    fbank_smem_bytes,
)
from khg_tpu_torch.gmm.fused_loglikes import (
    loglikes_grid,
    loglikes_smem_bytes,
    padded_width,
)
from khg_tpu_torch.stats.fold_kernel import (
    fold_chunk,
    fold_kernel_fits,
    fold_smem_bytes,
    fold_workspace_floats,
    fold_workspace_ints,
    score_plan,
    score_smem_bytes,
)

LIMIT = 232448  # shared memory a block may use on an H100 (bytes)


def viterbi_fits_before(DK, S):
    """The banded Viterbi kernel's acceptance before its redesign: int8
    backpointers and one block of plane costs, two alpha buffers, the
    offsets and an argmin scratch of 8 bytes a thread."""
    nt = min(1024, -(-S // 32) * 32)
    return DK < 128 and DK * S * 4 + 2 * S * 4 + DK * 4 + nt * 8 <= LIMIT


def fb_fits_before(DK, S):
    """The banded forward-backward kernels' acceptance before the
    redesign: one thread per state, and the backward block's negated
    costs, two double-buffered rows and the offsets."""
    return S <= 1024 and (DK * S + 4 * S) * 4 + DK * 4 <= LIMIT


PLANES = (1, 2, 5, 16, 20, 32, 33, 64, 100, 127, 128, 300)
STATES = (1, 31, 37, 64, 256, 512, 513, 1000, 1024, 1025, 2000, 2550, 4000, 18000)


@pytest.mark.parametrize("S", STATES)
@pytest.mark.parametrize("DK", PLANES)
def test_accepted_shapes_unchanged(DK, S):
    assert kernel_fits(DK, S) == viterbi_fits_before(DK, S)
    assert fb_kernel_fits(DK, S) == fb_fits_before(DK, S)
    if kernel_fits(DK, S):
        assert kernel_smem_bytes(DK, S) <= LIMIT
    if fb_kernel_fits(DK, S):
        assert fb_kernel_smem_bytes(DK, S) <= LIMIT


# (DK, S): bytes that launch_banded_viterbi requests.  Compiled path
# (DK 16, 20 or 32, S <= 512): alpha 2 x 512 f32 (4,096) + staged
# backpointers 2 x 32 rows of S padded to 16 bytes + offsets DK i32 +
# path 2 x 2 x 32 i32 (512) + argmin scratch 256.
# Generic path: plane costs DK x S f32 + alpha 2 x S f32 + offsets DK
# i32 + argmin scratch 8 bytes per thread (S rounded up to 32, at most
# 1,024 threads).
VITERBI_SMEM = {
    (20, 256): 4096 + 64 * 256 + 80 + 512 + 256,   # 21,328
    (32, 37): 4096 + 64 * 48 + 128 + 512 + 256,     # 8,064
    (16, 512): 4096 + 64 * 512 + 64 + 512 + 256,    # 37,696
    (20, 64): 4096 + 64 * 64 + 80 + 512 + 256,      # 9,040
    (20, 600): 20 * 600 * 4 + 8 * 600 + 80 + 608 * 8,         # 57,744
    (127, 37): 127 * 37 * 4 + 8 * 37 + 508 + 64 * 8,          # 20,112
    (1, 2000): 1 * 2000 * 4 + 8 * 2000 + 4 + 1024 * 8,        # 32,196
    (64, 256): 64 * 256 * 4 + 8 * 256 + 256 + 256 * 8,        # 69,888
}

# (DK, S): bytes that launch_banded_fb_bwd requests.  Compiled path (DK
# 16 or 20, S <= 512): alpha ring 4 x 2S f32 + beta' + acoustic 2 x 2S
# f32 = 48 S.  Generic path: negated costs DK x
# S f32 + 4 rows of S f32 + offsets DK i32, plus the plane-posterior
# sums DK x S f32 where the whole still fits.
FB_SMEM = {
    (20, 256): 48 * 256,                                        # 12,288
    (16, 37): 48 * 37,                                          # 1,776
    (20, 512): 48 * 512,                                        # 24,576
    (64, 300): (64 * 300 + 4 * 300) * 4 + 256 + 64 * 300 * 4,   # 158,656
    (128, 400): (128 * 400 + 4 * 400) * 4 + 512,                # 211,712
    (20, 600): (20 * 600 + 4 * 600) * 4 + 80 + 20 * 600 * 4,    # 105,680
    (32, 256): (32 * 256 + 4 * 256) * 4 + 128 + 32 * 256 * 4,   # 69,760
}


@pytest.mark.parametrize("DK,S", sorted(VITERBI_SMEM))
def test_viterbi_smem_mirror(DK, S):
    assert kernel_smem_bytes(DK, S) == VITERBI_SMEM[(DK, S)]


@pytest.mark.parametrize("DK,S", sorted(FB_SMEM))
def test_fb_smem_mirror(DK, S):
    assert fb_kernel_smem_bytes(DK, S) == FB_SMEM[(DK, S)]


# (DK, S): bytes that launch_banded_fb_fwd requests.  Compiled path (DK
# 16, 20 or 32, S <= 512): alpha 2 x 2S f32 + 32 f32 warp maxima =
# 16 S + 128.  Generic path: negated costs DK x S f32 + alpha 2 x S f32
# + offsets DK i32.
FB_FWD_SMEM = {
    (20, 256): 16 * 256 + 128,                  # 4,224
    (32, 100): 16 * 100 + 128,                  # 1,728
    (16, 37): 16 * 37 + 128,                    # 720
    (20, 513): (20 * 513 + 2 * 513) * 4 + 80,   # 45,224
    (24, 80): (24 * 80 + 2 * 80) * 4 + 96,      # 8,416
}


@pytest.mark.parametrize("DK,S", sorted(FB_FWD_SMEM))
def test_fb_fwd_smem_mirror(DK, S):
    assert fb_fwd_smem_bytes(DK, S) == FB_FWD_SMEM[(DK, S)]


@pytest.mark.parametrize("S", STATES)
@pytest.mark.parametrize("DK", PLANES)
def test_fb_fwd_request_fits(DK, S):
    """Every shape the forward-backward kernels take fits the forward
    launcher's request."""
    if fb_kernel_fits(DK, S):
        assert fb_fwd_smem_bytes(DK, S) <= LIMIT


def fold_fits_before(K, D):
    """The stats fold's acceptance before its redesign: one block per
    (utterance, state) with K model rows and accumulators of 2D+1
    floats and a 32-frame chunk's rows, scores, weights and indices."""
    return (2 * K * (2 * D + 1) + 32 * (2 * D + K + 3) + 1) * 4 <= LIMIT


FOLD_K = (1, 8, 13, 24, 32, 40, 64, 128, 512, 1040)
FOLD_D = (1, 13, 23, 39, 80, 100, 400, 852, 853, 1000)


@pytest.mark.parametrize("D", FOLD_D)
@pytest.mark.parametrize("K", FOLD_K)
def test_fold_accepted_shapes_unchanged(K, D):
    """Every (K, D) the first port took is still taken, and every other
    one here too (fold_kernel_fits is the launches' own limits, which
    every K meets up to D = 19,359); every shape fits both launches'
    requests."""
    assert fold_kernel_fits(K, D)
    assert score_plan(K, D)[0] >= 1 and fold_chunk(K, D) >= 1
    assert score_smem_bytes(K, D) <= LIMIT and fold_smem_bytes(K, D) <= LIMIT


def score_fits(K, D):
    """A whole-pdf score block's request, worked out from the .cu layout:
    K model rows of 2D+1 f32, and one frame's feature row (D rounded up
    to 4), K scores, 4 f32 and 3 i32."""
    return (K * (2 * D + 1) + ((D + 3) & ~3) + K + 4 + 3) * 4 <= LIMIT


# (D, largest K a score block takes whole): beyond it the score launch
# stages the model rows in chunks of components and keeps the scores in
# the float workspace
FOLD_K_MAX = {1: 14525, 13: 2074, 23: 1210, 39: 725, 80: 358, 100: 287,
              400: 71, 852: 33, 1000: 28, 2000: 14}


@pytest.mark.parametrize("D", sorted(FOLD_K_MAX))
def test_fold_routed_shapes(D):
    """The largest K each D scores whole is the whole-pdf block's limit;
    one more component (and a hundred times as many) goes to the chunked
    score block (scores in the workspace), which the kernels take too.  Shapes the first port
    refused (K = 200 at D = 80) score whole."""
    K = FOLD_K_MAX[D]
    assert score_plan(K, D) == (score_plan(K, D)[0], K, True) and score_fits(K, D)
    assert not score_plan(K + 1, D)[2] and not score_fits(K + 1, D)
    assert fold_kernel_fits(K + 1, D) and fold_kernel_fits(100 * K, D)
    assert not fold_fits_before(K, D)
    assert score_plan(200, 80) == (64, 200, True) and not fold_fits_before(200, 80)


# (K, D): (sorted positions, components staged at once, scores in shared
# memory) of a score block.  Whole pdf while one position fits beside its
# K model rows; otherwise positions' rows of (D rounded up to 4) + 7 f32
# in at most half of the block (64 at most, 1 at least) and model rows
# of 2D+1 f32 in the rest
SCORE_PLAN = {
    (32, 80): (64, 32, True),
    (358, 80): (1, 358, True),
    (359, 80): (64, (LIMIT - 64 * 87 * 4) // (161 * 4), False),        # 326
    (100_000, 80): (64, 326, False),
    (100, 1000): (LIMIT // 2 // (1007 * 4), 14, False),               # 28 positions
    (8, 19359): (1, 1, False),
    (8, 40000): (0, 0, False),
}


@pytest.mark.parametrize("K,D", sorted(SCORE_PLAN))
def test_fold_score_plan_mirror(K, D):
    assert score_plan(K, D) == SCORE_PLAN[(K, D)]
    assert fold_kernel_fits(K, D) == (SCORE_PLAN[(K, D)][0] >= 1)


# (K, D): bytes that csrc/stats_fold.cu's score and fold launchers
# request.  Score: a 64-frame block's feature rows (D rounded up to 4
# f32), K model rows of 2D+1 f32, scores (K), weights, log Z, maxima,
# sums (4) f32 a frame, and frame indices, pdfs, first-frame flags (3 x
# 64 i32); fewer frames where that would not fit.  Fold: three buffers
# of a chunk's sorted rows (D+1 rounded up to 4 f32) and the posteriors
# of the groups of 4 components a 256-pair slice spans (4 (255 // (2D+1)
# + 2), at most K rounded up to 4); chunks of 32 frames, fewer where
# three buffers would not fit.
FOLD_SMEM = {
    (32, 80): ((64 * 80 + 32 * 161 + 64 * (32 + 4)) * 4 + 768,    # 51,072
               3 * 32 * (84 + 12) * 4),                            # 36,864
    (8, 13): ((64 * 16 + 8 * 27 + 64 * (8 + 4)) * 4 + 768,        # 8,800
              3 * 32 * (16 + 8) * 4),                              # 9,216
    (40, 80): ((64 * 80 + 40 * 161 + 64 * (40 + 4)) * 4 + 768,    # 58,272
               3 * 32 * (84 + 12) * 4),                            # 36,864
    (1, 852): ((64 * 852 + 1 * 1705 + 64 * (1 + 4)) * 4 + 768,    # 226,980
               3 * 22 * (856 + 4) * 4),                            # 227,040: 22 frames
    (1040, 1): ((52 * 4 + 1040 * 3 + 52 * (1040 + 4)) * 4 + 624,  # 231,088: 52 frames
                3 * 32 * (4 + 348) * 4),                           # 135,168
    # chunked score blocks: no scores in shared memory
    (400, 80): ((64 * 80 + 326 * 161 + 64 * 4) * 4 + 768,         # 232,216
                3 * 32 * (84 + 12) * 4),                           # 36,864
    (5000, 13): ((64 * 16 + 2097 * 27 + 64 * 4) * 4 + 768,        # 232,364
                 3 * 32 * (16 + 44) * 4),                          # 23,040
    (100, 1000): ((28 * 1000 + 14 * 2001 + 28 * 4) * 4 + 336,     # 224,840
                  3 * 19 * (1004 + 8) * 4),                        # 230,736: 19 frames
}


@pytest.mark.parametrize("K,D", sorted(FOLD_SMEM))
def test_fold_smem_mirror(K, D):
    assert (score_smem_bytes(K, D), fold_smem_bytes(K, D)) == FOLD_SMEM[(K, D)]


# kernel B (csrc/loglikes.cu): a 4-stage ring of 16-column slices, each
# 128 rows and 8 components x 8 pdfs of 4-value f32 vectors (bf16 is
# converted on its way in); a running max and sum for each of 256
# threads x 4 rows; per pdf its real components' gconsts and indices (K
# each) and their count
LOGLIKES_SMEM = {
    8: 4 * 4 * (128 + 8 * 8) * 16 + 2 * 4 * 256 * 4 + 2 * 8 * 8 * 4 + 32,     # 57,888
    24: 4 * 4 * (128 + 8 * 8) * 16 + 2 * 4 * 256 * 4 + 2 * 8 * 24 * 4 + 32,   # 58,912
    32: 4 * 4 * (128 + 8 * 8) * 16 + 2 * 4 * 256 * 4 + 2 * 8 * 32 * 4 + 32,   # 59,424
    2735: 57344 + 2 * 8 * 2735 * 4 + 32,                                        # 232,416
}


@pytest.mark.parametrize("K", sorted(LOGLIKES_SMEM))
def test_loglikes_smem_mirror(K):
    """loglikes_smem_bytes mirrors the launcher's request; at the main
    paths' K three blocks fit an SM's 228 KB (each reserving 1 KB), and
    K = 2,735 is the most a block takes."""
    assert loglikes_smem_bytes(K) == LOGLIKES_SMEM[K]
    assert loglikes_smem_bytes(K) <= LIMIT
    if K <= 32:
        assert 3 * (loglikes_smem_bytes(K) + 1024) <= 228 * 1024
    else:
        assert loglikes_smem_bytes(K + 1) > LIMIT


@pytest.mark.parametrize("N,P,grid", [(19200, 2051, (150, 257)), (131072, 50, (1024, 7)),
                                      (4096, 2051, (32, 257)), (333, 21, (3, 3)),
                                      (1, 1, (1, 1))])
def test_loglikes_grid_mirror(N, P, grid):
    """Blocks of 128 rows x 8 pdfs: phase 7's batch, the D=23 check,
    the D=80 check, and tiles cut short."""
    assert loglikes_grid(N, P) == grid


@pytest.mark.parametrize("d2,width", [(2, 48), (26, 48), (46, 48), (48, 48), (78, 80),
                                      (160, 160), (200, 320), (1706, 1760)])
def test_loglikes_widths_take_the_kernel(d2, width):
    """The wrapper's widths are multiples of the kernel's 16-column
    slice."""
    assert padded_width(d2) == width and width % 16 == 0


@pytest.mark.parametrize("B,S,T,P", [(64, 64, 300, 2051), (2, 5, 7, 3), (3, 0, 4, 9)])
def test_fold_workspace_mirror(B, S, T, P):
    """fold_ws's layout: fsid, frank, order (B T each); seg_cnt,
    seg_goff, seglist (B S each); pdf_nseg (P); used_pdf, used_sbase,
    used_fbase, used_fcnt, uorder (min(P, B S) each); an 8-int header.
    fold_fws's: per frame a row of D+1 floats rounded up to 4, K
    posteriors, lse*w and w (here K = 32, D = 80: 84 + 32 + 2)."""
    U = min(P, B * S)
    assert fold_workspace_ints(B, S, T, P) == 3 * B * T + 3 * B * S + P + 5 * U + 8
    assert fold_workspace_floats(B, T, 32, 80) == B * T * (84 + 32 + 2)


# (S, M): bytes that launch_viterbi requests for its compiled kernel:
# alpha 2 x 512 f32 (4,096) + staged backpointers 2 x 32 rows of S
# padded to 16 bytes + the source table S x M i32 + path 2 x 2 x 32 i32
# (512) + argmin scratch 256
NONBANDED_SMEM = {
    (256, 4): 4096 + 64 * 256 + 256 * 4 * 4 + 512 + 256,   # 25,344
    (1, 1): 4096 + 64 * 16 + 1 * 1 * 4 + 512 + 256,        # 5,892
    (33, 5): 4096 + 64 * 48 + 33 * 5 * 4 + 512 + 256,      # 8,596
    (512, 8): 4096 + 64 * 512 + 512 * 8 * 4 + 512 + 256,   # 54,016
}


@pytest.mark.parametrize("S,M", sorted(NONBANDED_SMEM))
def test_nonbanded_viterbi_smem_mirror(S, M):
    """The compiled kernel takes these shapes, (512, 8) its largest, and
    each block fits."""
    assert viterbi_plan(S, M)[0] == "compiled"
    assert viterbi_smem_bytes(S, M) == NONBANDED_SMEM[(S, M)] <= LIMIT


# (sample rate, mel bins): bytes that launch_fbank requests for a block
# of 64 frames: the wave span, rows = 64 + (kp - 1) // shift of a stride
# padded to 4 (mod 8), rounded up to 4 floats; three ring stages of 2
# k-steps x 3 parts x 64 columns x 8 rows; a chunk's power, 32 bins x
# (64 + 8); the mel sums, M x (64 + 1).
FBANK_SMEM = {
    (8000, 23): 4 * (66 * 84 + 3 * 3072 + 32 * 72 + 23 * 65),           # 74,236
    (16000, 80): 4 * (66 * 164 + 3 * 3072 + 32 * 72 + 80 * 65),         # 110,176
    (22050, 80): 4 * (66 * 220 + 3 * 3072 + 32 * 72 + 80 * 65),         # 124,960
    (22050, 128): 4 * (66 * 220 + 3 * 3072 + 32 * 72 + 128 * 65),       # 137,440
    (44100, 80): 4 * (66 * 444 + 3 * 3072 + 32 * 72 + 80 * 65),         # 184,096
    (48000, 23): 4 * (66 * 484 + 3 * 3072 + 32 * 72 + 23 * 65),         # 179,836
    (48000, 80): 4 * (66 * 484 + 3 * 3072 + 32 * 72 + 80 * 65),         # 194,656
    (48000, 128): 4 * (66 * 484 + 3 * 3072 + 32 * 72 + 128 * 65),       # 207,136
}


@pytest.mark.parametrize("rate,M", sorted(FBANK_SMEM))
def test_fbank_plan_mirror(rate, M):
    """fbank_plan's bytes equal the launcher's layout, and
    fbank_smem_bytes is the formula the plan applies."""
    plan = fbank_plan(FbankConfig(sample_rate=rate, num_mel_bins=M))
    assert plan.smem == FBANK_SMEM[(rate, M)]
    shift = FbankConfig(sample_rate=rate).frame_shift
    assert plan.smem == fbank_smem_bytes(FRAMES, shift, plan.kp, plan.stride, M)
    assert plan.stride % 8 == 4 and 0 <= plan.stride - shift < 8
    assert plan.kp % STAGE_K == 0 and plan.rows == FRAMES + (plan.kp - 1) // shift


@pytest.mark.parametrize("M", [23, 40, 80, 128])
@pytest.mark.parametrize("rate", [8000, 11025, 16000, 22050, 32000, 44100, 48000])
def test_fbank_plan_fits(rate, M):
    """Every rate from 8 to 48 kHz (25 ms frames, FFT sizes 256 to 2,048)
    fits one block's shared memory."""
    assert fbank_plan(FbankConfig(sample_rate=rate, num_mel_bins=M)).smem <= LIMIT


@pytest.mark.parametrize("rate", [96000, 192000])
def test_fbank_beyond_plan_raises_before_launch(monkeypatch, rate):
    """A config beyond the plan (25 ms frames at 96 kHz need 321,376
    bytes, at 192 kHz 574,816) raises ValueError from fbank_cuda before
    the kernel library is touched."""
    import torch

    from khg_tpu_torch import kernels

    def no_launch():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(kernels, "lib", no_launch)
    cfg = FbankConfig(sample_rate=rate)
    with pytest.raises(ValueError, match="shared memory"):
        fbank_plan(cfg)
    with pytest.raises(ValueError, match="shared memory"):
        fbank_cuda(torch.zeros((1, cfg.frame_length)), cfg, 1)
