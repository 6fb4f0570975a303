"""The hand-written CUDA kernels against their plain PyTorch versions,
on the card, at small and ragged shapes the main path does not reach
(pdf and row tiles cut short, padding components, bf16 operands,
feature rows of every compiled width and wider, states not a multiple
of a warp, utterances of zero frames or too short to align, a last
frame chunk cut short, the banded kernels' compiled plane counts and
their generic paths up to 127 planes (Viterbi) or 128 planes and 1,024
states (forward-backward), tied candidates, utterance lengths on the
edges of their prefetch rings and backpointer chunks, utterances that
all fail, the banded forward kernel bit-equal to its plain version on
its compiled and generic paths, the stats fold with pdfs shared by
several states or absent from them, one pdf taking most frames, a pdf
on a state of only some utterances, all frames weighted 0, K not a
multiple of 32 or too many to score whole (K up to 2,500), the non-banded Viterbi
with 1 to 200 incoming arcs per state and up to 30,000 states, on both
sides of its compiled kernel's limits and its backpointer chunks' edges,
the fbank kernel at FFT sizes 256 to 2,048, on full-mantissa and
integer-valued rows and on speed-perturbed waves, MFCC on the fbank
kernel, and align_and_accumulate on the incoming-arc Viterbi kernel).

These tests need an NVIDIA card and skip without one.  They import
only the port, so they run where khg_tpu and jax are not installed;
tests/conftest.py imports jax, so on such a machine run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from khg_tpu_torch.align.banded import band_renumber, pack_banded
from khg_tpu_torch.align.banded_fb import (
    banded_fb_cuda,
    banded_fb_plain,
    fb_kernel_fits,
    forward_backward_banded,
)
from khg_tpu_torch.align.banded_kernel import (
    BandedTables,
    banded_cuda,
    banded_plain,
    banded_sac_cuda,
    banded_sac_plain,
)
from khg_tpu_torch.align.forward_backward import (
    NEG_BIG,
    FBResult,
    gamma_from_state_posteriors,
    tid_counts_from_posteriors,
)
from khg_tpu_torch.align.packed import (
    BatchedGraphs,
    pack_graph,
    pack_graph_batch,
    uniform_dest_pdf,
)
from khg_tpu_torch.align.viterbi_kernel import viterbi_cuda, viterbi_plain
from khg_tpu_torch.features.fbank import FbankConfig, num_frames
from khg_tpu_torch.features.fbank_kernel import (
    FRAMES,
    _padded_wave,
    fbank_cuda,
    fbank_fused,
    fbank_plain,
)
from khg_tpu_torch.gmm.fused_loglikes import loglikes_cuda, loglikes_plain
from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
from khg_tpu_torch.lang.topo import generate_hmm_topo
from khg_tpu_torch.recipes.audiomnist import DIGITS, digits_lexicon
from khg_tpu_torch.recipes.corpus_train import compile_training_graphs
from khg_tpu_torch.recipes.steps import gmm_init_mono
from khg_tpu_torch.stats.accum import accumulate_am_stats_local
from khg_tpu_torch.stats.fold_kernel import accumulate_am_stats_fold, fold_cuda
from khg_tpu_torch.utils.convert import banded_to_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The CUDA device, or skip: the kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.set_num_threads(2)
    return torch.device("cuda")


def _model(rng, P, K, D, device):
    means = rng.standard_normal((P, K, D))
    var = rng.uniform(0.5, 2.0, (P, K, D))
    w = rng.dirichlet(np.ones(K), P)
    g = np.log(w) - 0.5 * (D * np.log(2 * np.pi) + np.log(var).sum(-1)
                           + (means ** 2 / var).sum(-1))
    iv = 1.0 / var
    nreal = rng.integers(1, K + 1, P)
    for p in range(P):  # padding components: gconst -inf, zero rows
        g[p, nreal[p]:] = -np.inf
        means[p, nreal[p]:] = 0.0
        iv[p, nreal[p]:] = 0.0
    return tuple(torch.as_tensor(x.astype(np.float32), device=device)
                 for x in (g, means * iv, iv))


@pytest.mark.parametrize("P,K,D,N", [(13, 5, 23, 301), (9, 8, 13, 128),
                                     (3, 2, 20, 17), (11, 32, 39, 200),
                                     (7, 32, 80, 150), (5, 8, 100, 70)],
                         ids=["D23", "D13", "D20", "D39", "D80", "D100-chunked"])
@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), ("bfloat16", 5e-2)])
def test_loglikes_kernel(cuda_device, P, K, D, N, dtype, tol):
    rng = np.random.default_rng(P * 100 + K)
    g, miv, iv = _model(rng, P, K, D, cuda_device)
    x = torch.as_tensor(rng.standard_normal((N, D)).astype(np.float32),
                        device=cuda_device)
    got = loglikes_cuda(g, miv, iv, x, compute_dtype=dtype)
    ref = loglikes_plain(g, miv, iv, x, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert got.shape == (N, P) and torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), ("bfloat16", 5e-2)])
def test_loglikes_kernel_ragged_tiles(cuda_device, dtype, tol):
    """N not a multiple of the kernel's 128-row tile, P not a multiple
    of its 8-pdf tile, K not a multiple of its 8-component chunk, and a
    pdf whose components are all padding (-inf, as logsumexp gives)."""
    rng = np.random.default_rng(7)
    P, K, D, N = 21, 12, 39, 333
    g, miv, iv = _model(rng, P, K, D, cuda_device)
    g[4] = -float("inf")
    miv[4] = 0.0
    iv[4] = 0.0
    x = torch.as_tensor(rng.standard_normal((N, D)).astype(np.float32),
                        device=cuda_device)
    got = loglikes_cuda(g, miv, iv, x, compute_dtype=dtype)
    ref = loglikes_plain(g, miv, iv, x, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert got.shape == (N, P)
    assert bool((got[:, 4] == -float("inf")).all())
    real = [p for p in range(P) if p != 4]
    assert torch.isfinite(got[:, real]).all()
    assert float((got[:, real] - ref[:, real]).abs().max()) <= tol


def _digit_graphs(seqs):
    lp = Lexiconp.from_lexicon(Lexicon(word2phones=digits_lexicon())).add_lex_disambig()
    topo = generate_hmm_topo(non_sil_phones=lp.get_non_sil_phone_ids(),
                             sil_phone=lp.get_sil_phone_id())
    feats = [np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)]
    tm, tree, _ = gmm_init_mono(topo, feats)
    graphs = compile_training_graphs(lp, tm, tree, seqs)
    return tm, [pack_graph(g, tm.id2pdf_array()) for g in graphs]


@pytest.mark.parametrize("states_pad", [8, 256])
def test_banded_kernel(cuda_device, states_pad):
    """Costs bit-equal and tids equal, including an utterance too short
    to align and one with zero frames."""
    seqs = [[DIGITS[d] for d in s] for s in
            ([1], [2, 3], [4, 5, 6], [7], [0, 9])]
    tm, packed = _digit_graphs(seqs)
    arrays = pack_graph_batch(packed, states_pad_to=states_pad, indeg_pad_to=2)
    ren, _ = band_renumber(arrays)
    banded, offsets = pack_banded(ren, uniform_dest_pdf(ren))
    tables = banded_to_torch(banded, cuda_device)
    rng = np.random.default_rng(7)
    nf = np.array([40, 75, 120, 2, 0], np.int32)
    P = int(tm.id2pdf_array().max()) + 1
    ll = torch.as_tensor(
        (-30 + 6 * rng.standard_normal((5, 128, P))).astype(np.float32),
        device=cuda_device,
    )
    nf_t = torch.as_tensor(nf, device=cuda_device)
    for scale in (0.1, 1.0):
        tk, ck = banded_cuda(tables, offsets, ll, nf_t, scale)
        tp, cp = banded_plain(tables, offsets, ll, nf_t, scale)
        torch.cuda.synchronize()
        assert torch.equal(ck, cp)
        assert torch.equal(tk, tp)
        assert bool(ck[3] >= 1e29) and bool(ck[:3].lt(1e29).all())


def test_banded_sac_kernel(cuda_device):
    """External-acoustic mode: a random per-state lattice in place of
    the loglikes; costs bit-equal and tids equal to the plain version,
    counted apart from the loglike mode."""
    from khg_tpu_torch import kernels

    seqs = [[DIGITS[d] for d in s] for s in ([3], [2, 8], [4, 5, 6], [7], [1, 9])]
    _tm, packed = _digit_graphs(seqs)
    arrays = pack_graph_batch(packed, states_pad_to=8, indeg_pad_to=2)
    ren, _ = band_renumber(arrays)
    banded, offsets = pack_banded(ren, uniform_dest_pdf(ren))
    tables = banded_to_torch(banded, cuda_device)
    B, S = tables.state_pdf.shape
    rng = np.random.default_rng(9)
    sac = torch.as_tensor((-25 + 6 * rng.standard_normal((B, 140, S))).astype(np.float32),
                          device=cuda_device)
    nf = torch.as_tensor(np.array([60, 90, 140, 2, 0], np.int32), device=cuda_device)
    before = kernels.LAUNCHES["banded_viterbi_sac"]
    tk, ck = banded_sac_cuda(tables, offsets, sac, nf, 0.1)
    tp, cp = banded_sac_plain(tables, offsets, sac, nf, 0.1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_viterbi_sac"] == before + 1
    assert torch.equal(ck, cp) and torch.equal(tk, tp)
    assert bool(ck[3] >= 1e29) and bool(ck[:3].lt(1e29).all())


# utterance lengths at the kernels' edges: none, one frame, either side
# of E's 4-frame alpha ring, of A's frame pairs and 2-frame acoustic
# prefetch, and of A's backpointer chunks (32 frames; the last two
# chunks stay in shared memory), and T
_EDGE_T = 130
_EDGE_FRAMES = (0, 1, 3, 4, 5, 7, 8, 9, 31, 32, 33, 63, 64, 65, 95, 96, 97, _EDGE_T)


def _band_offsets(DK):
    lo = min(4, DK // 2)
    return tuple(range(-lo, DK - lo))


def _tie_tables(rng, B, S, offsets, device):
    """Random plane tables whose costs take three values (plus BIG for
    the planes with no arc, ~half the cells), so that equal candidates
    are common; state 0 initial, a few final states."""
    DK = len(offsets)
    big = np.float32(1e30)
    real = rng.uniform(size=(B, DK, S)) < 0.5
    real[:, 0] = True
    cost = np.where(real, rng.choice([0.5, 1.0, 1.5], (B, DK, S)), big).astype(np.float32)
    tid = np.where(real, rng.integers(1, 200, (B, DK, S)), 0).astype(np.int32)
    init = np.full((B, S), big, np.float32)
    init[:, 0] = 0.0
    final = np.full((B, S), big, np.float32)
    final[:, rng.integers(0, S, 5)] = rng.choice([0.0, 0.5], (B, 5))
    return BandedTables(*[torch.as_tensor(x, device=device) for x in (
        cost, tid, rng.integers(0, 23, (B, S)).astype(np.int32), init, final)])


@pytest.mark.parametrize("mode", ["loglikes", "sac"])
@pytest.mark.parametrize("DK,S", [
    (16, 64), (20, 256), (32, 512), (20, 37), (32, 100), (16, 1),
    (20, 513), (1, 300), (127, 37), (5, 1100), (20, 1500),
], ids=["c16-S64", "c20-S256", "c32-S512", "c20-S37", "c32-S100", "c16-S1",
        "g20-S513", "g1-S300", "g127-S37", "g5-S1100", "g20-S1500"])
def test_banded_kernel_random(cuda_device, DK, S, mode):
    """Kernel A against its plain version on random tables with ties and
    planes without arcs, over the compiled plane counts (c) and the
    generic kernel (g: other DK, S above 512 and above 1,024 threads),
    states not a multiple of a warp, both modes, and utterance lengths
    at the kernel's edges: costs bit-equal, tids equal."""
    rng = np.random.default_rng(DK * 10_000 + S)
    offsets = _band_offsets(DK)
    B = len(_EDGE_FRAMES)
    tables = _tie_tables(rng, B, S, offsets, cuda_device)
    nf = torch.as_tensor(np.array(_EDGE_FRAMES, np.int32), device=cuda_device)
    width = S if mode == "sac" else 23
    ll = torch.as_tensor(rng.integers(-6, 1, (B, _EDGE_T, width)).astype(np.float32),
                         device=cuda_device)
    run, plain = ((banded_sac_cuda, banded_sac_plain) if mode == "sac"
                  else (banded_cuda, banded_plain))
    for scale in (1.0, 0.1):
        tk, ck = run(tables, offsets, ll, nf, scale)
        tp, cp = plain(tables, offsets, ll, nf, scale)
        torch.cuda.synchronize()
        assert torch.equal(ck, cp)
        assert torch.equal(tk, tp)
    assert not bool(tk[0].any())


def _fold_problem(rng, B, T, D, P, K, S, pad, device):
    """Random model (``pad`` padding components per pdf: gconst -inf),
    features, state pdfs with repeats, and an alignment drawn from each
    utterance's states, with fractional and zero weights, frames of a
    pdf absent from the states, and utterance 1 of zero frames."""
    g = rng.standard_normal((P, K)).astype(np.float32) - 5.0
    miv = rng.standard_normal((P, K, D)).astype(np.float32)
    iv = rng.uniform(0.5, 2.0, (P, K, D)).astype(np.float32)
    if pad:
        g[:, K - pad:] = -np.inf
        miv[:, K - pad:] = 0.0
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    sp = rng.integers(0, P // 2, (B, S)).astype(np.int32)
    sp[:, S // 2] = sp[:, 0]  # a pdf on two states
    pid = np.take_along_axis(sp, rng.integers(0, S, (B, T)), axis=1)
    pid[0, :5] = P - 1  # absent from every state list
    w = rng.uniform(0.0, 1.0, (B, T)).astype(np.float32)
    w[w < 0.2] = 0.0
    w[0, :5] = 1.0
    w[1] = 0.0
    return [torch.as_tensor(a, device=device)
            for a in (g, miv, iv, feats, pid.astype(np.int32), w, sp)]


@pytest.mark.parametrize("B,T,D,P,K,S,pad", [
    (3, 70, 13, 40, 8, 13, 0), (4, 50, 16, 61, 32, 21, 3), (2, 33, 80, 30, 32, 9, 5),
], ids=["K8-S13", "K32-S21-pad3", "D80-K32-S9"])
def test_stats_fold_kernel(cuda_device, B, T, D, P, K, S, pad):
    """The fold kernels against accumulate_am_stats_local on the card:
    occ, moments and tot_log_like within 2e-4, tot_frames within 1e-6;
    padding components exactly 0; a rerun bit-identical; states that
    repeat a pdf, and an utterance of zero weight, take no frame."""
    rng = np.random.default_rng(B * 100 + K)
    args = _fold_problem(rng, B, T, D, P, K, S, pad, cuda_device)
    got = accumulate_am_stats_fold(*args)
    ref = accumulate_am_stats_local(*args)
    again = accumulate_am_stats_fold(*args)
    out, ll, frames = fold_cuda(*args)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], ref[:3]):
        assert torch.allclose(a, b, rtol=2e-4, atol=2e-4)
    assert torch.allclose(got.tot_log_like, ref.tot_log_like, rtol=2e-4)
    assert torch.allclose(got.tot_frames, ref.tot_frames, rtol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if pad:
        assert float(got.occ[:, K - pad:].abs().max()) == 0.0
    assert torch.equal(out[..., 0], got.occ)
    assert float(ll[:, S // 2].abs().max()) == 0.0
    assert float(frames[:, S // 2].abs().max()) == 0.0
    assert float(frames[1].abs().max()) == 0.0 and float(ll[1].abs().max()) == 0.0


def _fold_case(case, rng, device):
    """The fold's edge cases: (B, T, D, P, K, S, pad) and the alignment."""
    B, T, D, P, K, S, pad = dict(
        heavy=(5, 97, 16, 50, 32, 12, 0), partial=(4, 64, 13, 40, 20, 10, 2),
        absent=(3, 45, 13, 30, 8, 7, 0), zero=(3, 40, 16, 30, 16, 8, 0),
        k13_d13=(3, 61, 13, 35, 13, 9, 1), k45_d80=(2, 37, 80, 25, 45, 6, 4),
        t_ragged=(3, 101, 23, 33, 24, 11, 0), k200_d80=(2, 37, 80, 25, 200, 6, 4),
        k400_d80=(2, 37, 80, 25, 400, 6, 4), k2500_d13=(2, 29, 13, 9, 2500, 5, 3),
    )[case]
    args = _fold_problem(rng, B, T, D, P, K, S, pad, device)
    g, miv, iv, x, pid, w, sp = args
    pid, w, sp = pid.clone(), w.clone(), sp.clone()
    if case == "heavy":  # one pdf takes most frames of every utterance
        sp[:, 3] = P - 2
        pid[:, 5:90] = P - 2
    elif case == "partial":  # a pdf on a state of only some utterances
        sp[:, 4] = sp[:, 0]
        sp[1::2, 4] = P - 3
        pid[1::2, 10:40] = P - 3
    elif case == "absent":  # w > 0 frames whose pdf no state has
        pid[:, ::3] = P - 1
        w[:, ::3] = 1.0
    elif case == "zero":  # every frame weighted 0
        w.zero_()
    return B, S, K, [g, miv, iv, x, pid, w, sp]


@pytest.mark.parametrize("case", ["heavy", "partial", "absent", "zero", "k13_d13",
                                  "k45_d80", "t_ragged", "k200_d80", "k400_d80",
                                  "k2500_d13"])
def test_stats_fold_kernel_cases(cuda_device, case):
    """The fold's load-imbalance path (one pdf with most frames), a pdf
    on a state of only some utterances, w > 0 frames of absent pdfs,
    all frames weighted 0, K not a multiple of 32 at D 13 and 80, T not
    a multiple of any chunk, K = 200 at D = 80 (beyond the first port's
    limit), and K = 400 at D = 80 and 2,500 at D = 13, whose model rows
    the score launch stages in two chunks of components (``score_plan``):
    one fold launch each, within 2e-4 of accumulate_am_stats_local,
    bit-identical on a rerun."""
    from khg_tpu_torch import kernels
    from khg_tpu_torch.stats.fold_kernel import score_plan

    rng = np.random.default_rng(len(case) * 7 + 3)
    B, S, K, args = _fold_case(case, rng, cuda_device)
    before = kernels.LAUNCHES["stats_fold"]
    got = accumulate_am_stats_fold(*args)
    _chs, kc, _in_smem = score_plan(K, args[1].shape[2])
    assert (kc < K) == (case in ("k400_d80", "k2500_d13"))
    assert kernels.LAUNCHES["stats_fold"] == before + 1
    again = accumulate_am_stats_fold(*args)
    ref = accumulate_am_stats_local(*args)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], ref[:3]):
        assert torch.allclose(a, b, rtol=2e-4, atol=2e-4)
    assert torch.allclose(got.tot_log_like, ref.tot_log_like, rtol=2e-4, atol=1e-6)
    assert torch.allclose(got.tot_frames, ref.tot_frames, rtol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if case == "zero":
        assert float(got.occ.abs().max()) == 0.0 and float(got.tot_frames) == 0.0
    if case == "absent":
        w, pid, sp = args[5], args[4], args[6]
        hit = (pid[:, :, None] == sp[:, None, :]).any(-1) & (w > 0)
        assert float(got.tot_frames) == pytest.approx(float(w[hit].sum()), rel=1e-6)


def _random_arcs(rng, B, S, M, P, device):
    """Random incoming-arc tables: state 0 initial, sources anywhere
    (earlier states more often), a share of padding slots at BIG,
    finals on the last states; utterance 2 has no final state."""
    big = np.float32(1e30)
    s = np.arange(S)[None, :, None]
    src = np.where(rng.uniform(size=(B, S, M)) < 0.7,
                   np.maximum(s - rng.integers(0, 3, (B, S, M)), 0),
                   rng.integers(0, S, (B, S, M)))
    real = rng.uniform(size=(B, S, M)) < 0.8
    real[:, :, 0] = True
    cost = np.where(real, rng.uniform(0.1, 3.0, (B, S, M)), big).astype(np.float32)
    tid = np.where(real, rng.integers(1, 90, (B, S, M)), 0).astype(np.int32)
    pdf = rng.integers(0, P, (B, S, M)).astype(np.int32)
    init = np.full((B, S), big, np.float32)
    init[:, 0] = 0.0
    final = np.full((B, S), big, np.float32)
    final[:, -3:] = rng.uniform(0.0, 1.0, (B, min(S, 3)))
    final[2] = big
    zeros = np.zeros((B, S, M), np.int32)
    return BatchedGraphs(*[torch.as_tensor(x, device=device) for x in (
        src.astype(np.int32), tid, pdf, cost, zeros, zeros, zeros,
        np.zeros((B, S, M), np.float32), init, final)])


_COMPILED_SM = [(S, M) for S in (1, 31, 32, 33, 512) for M in range(1, 9)]


@pytest.mark.parametrize("S,M", [(37, 1), (100, 3), (300, 8), (45, 5), (5000, 4),
                                 (64, 130), (300, 200), (30000, 2)]
                         + _COMPILED_SM + [(513, 4), (256, 9)])
def test_viterbi_kernel(cuda_device, S, M):
    """Costs bit-equal and tids equal to the eager DP, with a zero-frame
    utterance (3) and one with no final state (2, failed); on the
    compiled kernel (every M of 1 to 8 at S of 1, a warp less one, a
    warp, a warp and one, and 512) and on the generic one (S = 513 and M
    = 9 just past the compiled kernel; tables beyond shared memory at S =
    5,000; int16 backpointers at M = 130 and 200; alpha in global memory
    at S = 30,000)."""
    rng = np.random.default_rng(S * 10 + M)
    B, T, P = 5, 80, 29
    graphs = _random_arcs(rng, B, S, M, P, cuda_device)
    ll = torch.as_tensor((-20 + 5 * rng.standard_normal((B, T, P))).astype(np.float32),
                         device=cuda_device)
    nf = torch.as_tensor(np.array([80, 57, 40, 0, 13], np.int32), device=cuda_device)
    for scale in (0.1, 1.0):
        tk, ck = viterbi_cuda(graphs, ll, nf, scale)
        tp, cp = viterbi_plain(graphs, ll, nf, scale)
        torch.cuda.synchronize()
        assert torch.equal(ck, cp)
        assert torch.equal(tk, tp)
        assert bool(ck[2] >= 1e29)
        assert not bool(tk[3].any())


@pytest.mark.parametrize("S,M", [(33, 1), (33, 8), (256, 4), (512, 3)])
def test_viterbi_kernel_chunk_edges(cuda_device, S, M):
    """The compiled kernel's backpointer chunks (32 frames; the last two
    stay in shared memory, earlier ones go out and come back for the
    backtrace): utterances of 200 frames (4 chunks out), 96 (one out),
    64 and 65 (on a chunk's edge), 33, 1 and 0 frames, bit-equal."""
    rng = np.random.default_rng(S * 100 + M)
    B, T, P = 7, 200, 31
    graphs = _random_arcs(rng, B, S, M, P, cuda_device)
    ll = torch.as_tensor((-20 + 5 * rng.standard_normal((B, T, P))).astype(np.float32),
                         device=cuda_device)
    nf = torch.as_tensor(np.array([200, 96, 64, 65, 33, 1, 0], np.int32), device=cuda_device)
    tk, ck = viterbi_cuda(graphs, ll, nf, 0.1)
    tp, cp = viterbi_plain(graphs, ll, nf, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp)
    assert torch.equal(tk, tp)


def _fb_pair(tables, offsets, ll, nf, scale, num_tids):
    """(kernels' FBResult, plain FBResult) on the same inputs."""
    out = []
    for fn in (banded_fb_cuda, banded_fb_plain):
        log_z, spost, apost = fn(tables, offsets, ll, nf, scale)
        out.append(FBResult(
            log_z,
            gamma_from_state_posteriors(spost, tables.state_pdf, ll.shape[2]),
            tid_counts_from_posteriors(apost, tables.plane_tid, num_tids),
            log_z < NEG_BIG / 2,
        ))
    torch.cuda.synchronize()
    return out


def _assert_fb_close(k, p, ok=None):
    """log Z rtol 1e-5, gamma atol 1e-4, tid counts atol 1e-3 (where
    ``ok``), failures equal."""
    assert torch.equal(k.failed, p.failed)
    assert torch.allclose(k.log_z, p.log_z, rtol=1e-5, atol=0)
    ok = torch.ones_like(k.failed) if ok is None else ok
    assert float((k.gamma - p.gamma)[ok].abs().max()) <= 1e-4
    assert float((k.tid_counts - p.tid_counts)[ok].abs().max()) <= 1e-3


@pytest.mark.parametrize("states_pad", [8, 256])
def test_banded_fb_kernels(cuda_device, states_pad):
    """Digit training graphs packed for FB, including an utterance too
    short to align and one of zero frames."""
    seqs = [[DIGITS[d] for d in s] for s in
            ([1], [2, 3], [4, 5, 6], [7], [0, 9])]
    tm, packed = _digit_graphs(seqs)
    arrays = pack_graph_batch(packed, states_pad_to=states_pad,
                              indeg_pad_to=2, semiring="log")
    ren, _ = band_renumber(arrays)
    banded, offsets = pack_banded(ren, uniform_dest_pdf(ren), reject_parallel=True)
    tables = banded_to_torch(banded, cuda_device)
    assert fb_kernel_fits(len(offsets), tables.plane_cost.shape[2])
    rng = np.random.default_rng(8)
    P = int(tm.id2pdf_array().max()) + 1
    ll = torch.as_tensor(
        (-30 + 6 * rng.standard_normal((5, 128, P))).astype(np.float32),
        device=cuda_device,
    )
    nf = torch.as_tensor(np.array([40, 75, 120, 2, 0], np.int32),
                         device=cuda_device)
    for scale in (0.1, 1.0):
        k, p = _fb_pair(tables, offsets, ll, nf, scale, tm.num_transition_ids)
        assert k.failed.tolist() == [False, False, False, True, True]
        _assert_fb_close(k, p, ok=~p.failed)
    got = forward_backward_banded(tables, offsets, ll, nf,
                                  tm.num_transition_ids, 0.1)
    torch.cuda.synchronize()
    sums = got.gamma[:3].sum(-1)
    for i, n in enumerate((40, 75, 120)):
        assert torch.allclose(sums[i, :n], torch.ones_like(sums[i, :n]), atol=1e-3)
        assert float(sums[i, n:].abs().max()) == 0.0


def _random_banded(rng, B, S, offsets, P, device, density=0.4):
    """Random plane tables: arcs on a random share of the in-range plane
    cells, states padded with unreachable ones past S - 7."""
    DK = len(offsets)
    s = np.arange(S)[None, None, :]
    src = s - np.asarray(offsets)[None, :, None]
    real = ((rng.uniform(size=(B, DK, S)) < density) & (src >= 0) & (src < S - 7)
            & (s < S - 7))
    big = np.float32(1e30)
    cost = np.where(real, rng.uniform(0.1, 3.0, (B, DK, S)), big).astype(np.float32)
    tid = np.where(real, rng.integers(1, 60, (B, DK, S)), 0).astype(np.int32)
    init = np.full((B, S), big, np.float32)
    init[:, 0] = 0.0
    final = np.full((B, S), big, np.float32)
    final[:, S - 20 : S - 7] = rng.uniform(0.0, 2.0, (B, 13))
    return BandedTables(*[
        torch.as_tensor(x, device=device) for x in (
            cost, tid, rng.integers(0, P, (B, S)).astype(np.int32), init, final,
        )
    ])


@pytest.mark.parametrize("DK,S", [
    (20, 37), (64, 300), (20, 400), (128, 200), (16, 64), (16, 200), (20, 256),
], ids=["planes-20", "planes-64", "states-400", "planes-128", "c16-S64", "c16-S200",
        "c20-S256"])
def test_banded_fb_kernels_random(cuda_device, DK, S):
    """Random tables, from the main path's plane count to 128 planes
    and 400 states (a block of 13 warps): the compiled backward path (c:
    16 and 20 planes) and the generic one, with its plane-posterior sums
    in shared memory (up to 64 planes here) or in global memory (128).
    Close to the plain version in gamma and tid counts, and bit-equal in
    log Z and the state and plane posteriors."""
    rng = np.random.default_rng(DK * 1000 + S)
    offsets = tuple(range(-4, DK - 4))
    B, T, P = 6, 90, 23
    tables = _random_banded(rng, B, S, offsets, P, cuda_device)
    assert fb_kernel_fits(DK, S)
    ll = torch.as_tensor((-20 + 4 * rng.standard_normal((B, T, P))).astype(np.float32),
                         device=cuda_device)
    nf = torch.as_tensor(np.array([90, 61, 33, 90, 7, 50], np.int32),
                         device=cuda_device)
    k, p = _fb_pair(tables, offsets, ll, nf, 0.3, 60)
    assert not bool(p.failed[[0, 1, 2, 3, 5]].any())
    _assert_fb_close(k, p, ok=~p.failed)
    for a, b in zip(banded_fb_cuda(tables, offsets, ll, nf, 0.3),
                    banded_fb_plain(tables, offsets, ll, nf, 0.3)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("DK,S", [
    (16, 40), (20, 256), (16, 512), (20, 512), (20, 513), (32, 256), (16, 1024),
    (128, 400),
], ids=["c16-S40", "c20-S256", "c16-S512", "c20-S512", "g20-S513", "g32-S256",
        "g16-S1024", "g128-S400"])
def test_banded_fb_kernels_edge_frames(cuda_device, DK, S):
    """Utterance lengths at the backward kernel's edges (none, one
    frame, either side of its 4-frame prefetch ring, exactly T), on the
    compiled path (c: up to its 512 states) and the generic one (g: up
    to 1,024 states, plane sums in shared or, at 128 planes, in global
    memory): bit-equal to the plain versions in log Z, spost and apost,
    failed utterances included."""
    rng = np.random.default_rng(DK * 100 + S)
    offsets = tuple(range(-4, DK - 4))
    B = len(_EDGE_FRAMES)
    tables = _random_banded(rng, B, S, offsets, 23, cuda_device)
    ll = torch.as_tensor((-20 + 4 * rng.standard_normal((B, _EDGE_T, 23))).astype(np.float32),
                         device=cuda_device)
    nf = torch.as_tensor(np.array(_EDGE_FRAMES, np.int32), device=cuda_device)
    got = banded_fb_cuda(tables, offsets, ll, nf, 0.3)
    ref = banded_fb_plain(tables, offsets, ll, nf, 0.3)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert float(got[1][0].abs().max()) == 0.0 and float(got[2][0].abs().max()) == 0.0


def test_banded_fb_kernels_all_failed(cuda_device):
    """No state is final: every utterance fails, log Z is NEG_BIG, and
    the kernels still agree with the plain version on every output."""
    rng = np.random.default_rng(21)
    offsets = tuple(range(-4, 16))
    B, S, T, P = 4, 64, 40, 11
    tables = _random_banded(rng, B, S, offsets, P, cuda_device)
    tables = tables._replace(final_cost=torch.full_like(tables.final_cost, 1e30))
    ll = torch.as_tensor((-10 + 3 * rng.standard_normal((B, T, P))).astype(np.float32),
                         device=cuda_device)
    nf = torch.as_tensor(np.array([40, 12, 1, 0], np.int32), device=cuda_device)
    k, p = _fb_pair(tables, offsets, ll, nf, 1.0, 60)
    assert k.failed.all()
    assert bool((k.log_z == np.float32(NEG_BIG)).all())
    _assert_fb_close(k, p)


# forward lengths at the compiled kernel's edges: none, one frame,
# either side of its two-frame acoustic prefetch, and T
_FWD_T = 70
_FWD_FRAMES = (0, 1, 2, 3, 4, 5, 33, _FWD_T)


@pytest.mark.parametrize("DK,S,failed", [
    (16, 64, False), (20, 256, False), (32, 100, False), (20, 37, False),
    (16, 101, False), (20, 512, False), (20, 513, False), (24, 80, False),
    (20, 64, True), (32, 37, True),
], ids=["c16-S64", "c20-S256", "c32-S100", "c20-S37", "c16-S101", "c20-S512",
        "g20-S513", "g24-S80", "c20-failed", "c32-S37-failed"])
def test_banded_fb_fwd_bit_equal(cuda_device, DK, S, failed):
    """Kernel D's alphas (every frame below each utterance's length) and
    log Z bit-equal to banded_fb_fwd_plain, on the compiled path (c: 16,
    20 and 32 planes, S up to 512, S not a multiple of 4 or 32) and the
    generic one (g), at lengths 0, 1, either side of the prefetch
    distance and T, and with every utterance failed."""
    from khg_tpu_torch.align.banded_fb import banded_fb_fwd_cuda, banded_fb_fwd_plain

    rng = np.random.default_rng(DK * 1000 + S + failed)
    offsets = tuple(range(-4, DK - 4))
    B = len(_FWD_FRAMES)
    tables = _random_banded(rng, B, S, offsets, 23, cuda_device)
    if failed:
        tables = tables._replace(final_cost=torch.full_like(tables.final_cost, 1e30))
    ll = torch.as_tensor((-20 + 4 * rng.standard_normal((B, _FWD_T, 23))).astype(np.float32),
                         device=cuda_device)
    nf = torch.as_tensor(np.array(_FWD_FRAMES, np.int32), device=cuda_device)
    for scale in (0.3, 1.0):
        ak, zk = banded_fb_fwd_cuda(tables, offsets, ll, nf, scale)
        ap, zp = banded_fb_fwd_plain(tables, offsets, ll, nf, scale)
        torch.cuda.synchronize()
        assert torch.equal(zk, zp)
        for i, n in enumerate(_FWD_FRAMES):
            assert torch.equal(ak[i, :n], ap[i, :n])
    assert bool((zk < NEG_BIG / 2).all()) == failed


@pytest.mark.parametrize("kw", [
    dict(sample_rate=8000, num_mel_bins=23),
    dict(),
    dict(snip_edges=True, use_energy=True),
    dict(sample_rate=8000, num_mel_bins=23, use_power=False, energy_floor=1.0),
    dict(sample_rate=22050),
    dict(sample_rate=22050, snip_edges=True, use_energy=True),
    dict(sample_rate=22050, use_power=False, energy_floor=1.0),
    dict(sample_rate=16000, B=1),
    dict(sample_rate=22050, num_mel_bins=23, B=1),
    dict(sample_rate=44100),
    dict(sample_rate=44100, snip_edges=True, use_energy=True),
    dict(sample_rate=44100, num_mel_bins=23, B=1),
    dict(sample_rate=48000),
    dict(sample_rate=8000, num_mel_bins=23, integers=True),
    dict(sample_rate=48000, integers=True),
], ids=["8k", "16k", "snip-energy", "magnitude-floor", "22k", "22k-snip-energy",
        "22k-magnitude-floor", "16k-one-row", "22k-one-row", "44k", "44k-snip-energy",
        "44k-one-row", "48k", "8k-integers", "48k-integers"])
def test_fbank_kernel(cuda_device, kw):
    """Features and log energy within 1e-3 of the plain version, at FFT
    sizes 256 (8 kHz), 512 (16 kHz), 1,024 (22.05 kHz) and 2,048 (44.1
    and 48 kHz), on 0.77 s rows (frame counts that fill no whole block of
    FRAMES frames), of standard_normal x 300 (full f32 mantissas) or
    integers (as a WAV holds them: no third TF32 part); and the whole of
    fbank_fused (gather, kernel, energy column) against its CPU run."""
    kw = dict(kw)
    B = kw.pop("B", 3)
    integers = kw.pop("integers", False)
    cfg = FbankConfig(**kw)
    rng = np.random.default_rng(13)
    w = rng.standard_normal((B, int(cfg.sample_rate * 0.77))) * 300
    if integers:
        w = np.clip(np.round(w * 20), -32768, 32767)
    waves = torch.as_tensor(w.astype(np.float32), device=cuda_device)
    T = num_frames(cfg, waves.shape[-1])
    assert T % FRAMES
    padded = _padded_wave(waves, cfg, T)
    fk, ek = fbank_cuda(padded, cfg, T)
    fp, ep = fbank_plain(padded, cfg, T)
    torch.cuda.synchronize()
    assert fk.shape == (B, T, cfg.num_mel_bins)
    assert float((fk - fp).abs().max()) <= 1e-3
    assert float((ek - ep).abs().max()) <= 1e-3
    whole = fbank_fused(waves, cfg)
    assert float((whole.cpu() - fbank_fused(waves.cpu(), cfg)).abs().max()) <= 1e-3


def test_segment_sum_is_deterministic_on_card(cuda_device):
    """The stats segment sum adds in the same order on every run (the
    bit-exact resume contract), with heavy index collisions."""
    from khg_tpu_torch.stats.accum import segment_sum

    rng = np.random.default_rng(17)
    index = torch.as_tensor(rng.integers(0, 50, 200_000), device=cuda_device)
    src = torch.as_tensor(
        (1e3 * rng.standard_normal((200_000, 24, 2))).astype(np.float32),
        device=cuda_device,
    )
    runs = [segment_sum(src, index, 50) for _ in range(3)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    # against an f64 sum: each cell adds ~4,000 terms of ~1e3, so the
    # f32 sum is good to ~1e-5 of the cell's ~1e5 scale
    ref = torch.zeros((50, 24, 2), dtype=torch.float64, device=cuda_device)
    ref.index_add_(0, index, src.double())
    assert float((runs[0].double() - ref).abs().max()) <= 5.0


def _digit_system(seed):
    """A digit model (pdfs split to 1-20 components) with its transition
    model and tree, and the unigram digit HCLG's decoder."""
    from khg_tpu_torch.egs.audiomnist_10k import build_decoder, digit_lexiconp

    rng = np.random.default_rng(seed)
    lp = digit_lexiconp()
    topo = generate_hmm_topo(non_sil_phones=lp.get_non_sil_phone_ids(),
                             sil_phone=lp.get_sil_phone_id())
    feats = [rng.standard_normal((400, 23)).astype(np.float32)]
    tm, tree, am = gmm_init_mono(topo, feats)
    for p in range(am.num_pdfs):
        am.split_pdf(p, int(rng.integers(1, 21)), 0.5, rng=rng)
    return lp, tm, tree, am, build_decoder(lp, tm, tree)


def test_decode_dense_hclg_generic_kernel(cuda_device):
    """decode_dense over the unigram digit HCLG (161 states, 12 incoming
    arcs a state once packed: kernel G's generic route) at B = 1: the
    kernel's tids and cost bit-equal to viterbi_plain on the same packed
    tables, and decode_dense on the card equal to decode_dense on the
    CPU."""
    from khg_tpu_torch import kernels
    from khg_tpu_torch.align.viterbi_kernel import viterbi_plan
    from khg_tpu_torch.decode.decoder import decode_dense
    from khg_tpu_torch.utils.convert import batched_graphs_to_torch

    _lp, tm, _tree, _am, decoder = _digit_system(11)
    id2pdf = tm.id2pdf_array()
    packed = pack_graph_batch([pack_graph(decoder.fst, id2pdf)])
    B, S, M = packed.in_src.shape
    assert (B, S, M) == (1, 161, 12)
    assert viterbi_plan(S, M)[0] == "generic"
    rng = np.random.default_rng(12)
    graphs = batched_graphs_to_torch(packed, cuda_device)
    for T in (1, 37, 300):
        ll_np = (-30 + 6 * rng.standard_normal((T, tm.num_pdfs))).astype(np.float32)
        ll = torch.as_tensor(ll_np, device=cuda_device)[None]
        nf = torch.tensor([T], dtype=torch.int32, device=cuda_device)
        tk, ck = viterbi_cuda(graphs, ll, nf, 2.0)
        tp, cp = viterbi_plain(graphs, ll, nf, 2.0)
        torch.cuda.synchronize()
        assert torch.equal(ck, cp) and torch.equal(tk, tp)
        before = kernels.LAUNCHES["viterbi"]
        card = decode_dense(decoder.fst, ll_np, id2pdf, acoustic_scale=2.0,
                            device=cuda_device)
        assert kernels.LAUNCHES["viterbi"] == before + 1
        host = decode_dense(decoder.fst, ll_np, id2pdf, acoustic_scale=2.0,
                            device="cpu")
        assert card == host
        if T > 1:
            assert card is not None and card[0] == tk[0].cpu().tolist()
            assert card[2] == float(ck[0])


def test_score_held_out_kernel(cuda_device, monkeypatch):
    """score_held_out on the card (one kernel B launch per 128-frame
    bucket) against the same buckets scored by B's plain version on the
    card, at 1e-4 as test_loglikes_kernel holds B; every utterance keeps
    its own frames."""
    from khg_tpu_torch import kernels
    from khg_tpu_torch.egs.audiomnist_10k import score_held_out
    from khg_tpu_torch.gmm import fused_loglikes

    _lp, _tm, _tree, am, _decoder = _digit_system(13)
    rng = np.random.default_rng(14)
    lens = [1, 127, 128, 129, 300, 301, 512, 90, 64, 250, 257, 33]
    feats = [rng.standard_normal((n, 23)).astype(np.float32) for n in lens]
    before = kernels.LAUNCHES["fused_loglikes"]
    got = score_held_out(am, feats, cuda_device)
    buckets = {-(-n // 128) for n in lens}
    assert kernels.LAUNCHES["fused_loglikes"] == before + len(buckets)
    monkeypatch.setattr(fused_loglikes, "loglikes_fused", fused_loglikes.loglikes_plain)
    ref = score_held_out(am, feats, cuda_device)
    torch.cuda.synchronize()
    for n, g, r in zip(lens, got, ref):
        assert g.shape == (n, am.num_pdfs) and g.device.type == "cuda"
        assert torch.isfinite(g).all()
        assert float((g - r).abs().max()) <= 1e-4


def test_mfcc_on_fbank_kernel(cuda_device):
    """MFCC with kernel C's log-mel against the same cepstra from C's
    plain version on the card: within C's 1e-3 times the largest row L1
    norm of the lifted DCT matrix (the linear map after the log-mel);
    compute_mfcc_batch on a CUDA tensor launches C once."""
    from khg_tpu_torch import kernels
    from khg_tpu_torch.features.mfcc import (
        MfccConfig,
        _mfcc_from_logmel,
        compute_mfcc_batch,
        lifted_dct_matrix,
    )

    cfg = MfccConfig(fbank=FbankConfig(sample_rate=8000, num_mel_bins=23))
    fcfg = cfg.frontend_cfg()
    rng = np.random.default_rng(21)
    w = np.round(rng.standard_normal((5, 7001)) * 3000).astype(np.float32)
    waves = torch.as_tensor(w, device=cuda_device)
    T = num_frames(fcfg, waves.shape[-1])
    padded = _padded_wave(waves, fcfg, T)
    fk, ek = fbank_cuda(padded, fcfg, T)
    fp, ep = fbank_plain(padded, fcfg, T)
    got = _mfcc_from_logmel(torch.cat([ek[..., None], fk], -1), cfg)
    ref = _mfcc_from_logmel(torch.cat([ep[..., None], fp], -1), cfg)
    limit = 1e-3 * float(np.abs(lifted_dct_matrix(cfg)).sum(0).max())
    assert got.shape == (5, T, 13)
    assert float((got - ref).abs().max()) <= limit
    before = kernels.LAUNCHES["fbank"]
    whole = compute_mfcc_batch(waves, cfg)
    assert kernels.LAUNCHES["fbank"] == before + 1
    assert torch.equal(whole, got)


def test_fbank_kernel_on_resampled_waves(cuda_device):
    """Kernel C on speed-perturbed (resampled, non-integer) waves against
    its plain version at 1e-3: every block's wave span holds samples
    with a third TF32 part, so the kernel takes the sixth (lo-frame)
    product throughout."""
    from khg_tpu_torch.features.fbank_kernel import fbank_plan, split_tf32
    from khg_tpu_torch.features.resample import perturb_speed

    cfg = FbankConfig(sample_rate=8000, num_mel_bins=23)
    rng = np.random.default_rng(22)
    rows = []
    for f in (0.9, 1.1):
        for _ in range(3):
            w = np.round(rng.standard_normal(9000) * 2000).astype(np.float32)
            rows.append(perturb_speed(w, 8000, f, device=cuda_device)[:8000])
    waves = torch.as_tensor(np.stack(rows), device=cuda_device)
    T = num_frames(cfg, waves.shape[-1])
    padded = _padded_wave(waves, cfg, T)
    lo = split_tf32(padded.cpu().numpy())[2] != 0
    plan = fbank_plan(cfg)
    for t0 in range(0, T, FRAMES):
        span = lo[:, t0 * cfg.frame_shift:(t0 + plan.rows) * cfg.frame_shift]
        assert span.any(1).all()
    fk, ek = fbank_cuda(padded, cfg, T)
    fp, ep = fbank_plain(padded, cfg, T)
    torch.cuda.synchronize()
    assert float((fk - fp).abs().max()) <= 1e-3
    assert float((ek - ep).abs().max()) <= 1e-3


def test_align_and_accumulate_on_viterbi_kernel(cuda_device, monkeypatch):
    """EStepPipeline.align_and_accumulate (align_backend="xla": kernel
    G) against the same call with G's plain version on the card: equal
    alignments, likelihood and transition counts, GMM stats equal (the
    costs are bit-equal, so everything downstream is the same
    computation); one G launch per batch."""
    from khg_tpu_torch import kernels
    from khg_tpu_torch.align import viterbi_kernel
    from khg_tpu_torch.recipes.pipeline import EStepPipeline
    from khg_tpu_torch.recipes.yesno import make_synthetic_corpus, train_yesno
    from khg_tpu_torch.stats.accum import AccumAmDiagGmm

    lp, corpus = make_synthetic_corpus(num_utts=9, dim=6,
                                       rng=np.random.default_rng(23))
    res = train_yesno(lp, corpus, num_iters=2, total_gauss=20,
                      max_iter_inc=1, realign_iters="1", device="cpu")
    pipe = EStepPipeline(res.transition_model, acoustic_scale=0.1,
                         self_loop_scale=0.1, batch_size=4, device=cuda_device)
    packed = pipe.pack_graphs(res.graphs)

    def run():
        acc = AccumAmDiagGmm()
        acc.init(res.am, flags=0b1111)
        tr = res.transition_model.init_stats()
        out = pipe.align_and_accumulate(res.am, packed, corpus.feats, acc, tr)
        return out, acc, tr

    before = kernels.LAUNCHES["viterbi"]
    got, acc_k, tr_k = run()
    assert kernels.LAUNCHES["viterbi"] == before + 3
    monkeypatch.setattr(viterbi_kernel, "viterbi_cuda", viterbi_kernel.viterbi_plain)
    ref, acc_p, tr_p = run()
    assert got.num_error == 0 and got.alignments == ref.alignments
    assert got.tot_like == ref.tot_like
    np.testing.assert_array_equal(tr_k, tr_p)
    for p in range(res.am.num_pdfs):
        np.testing.assert_array_equal(acc_k.get_acc(p).occupancy,
                                      acc_p.get_acc(p).occupancy)
