"""GMM-EM training over CTC topology training graphs (PyTorch port of
khg_tpu/recipes/ctc_train.py).

BASELINE config #4 ("AudioMNIST with CTC topology training graphs
(ctc_topo.py) instead of 3-state HMM"): each CTC symbol — blank (0) and
the real tokens 1..vocab_size-1 — owns one DiagGmm pdf, the
per-utterance alignment graph is the blank-insertion CTC lattice
(lang/ctc.build_ctc_training_graph), and EM alternates exact batched
Viterbi alignment with the dense stats fold and the MLE update.

The host loop is khg_tpu's; the device work runs on ``device`` (None
means CUDA and raises without a card; "cpu" runs the plain versions):
scoring is the plain f32 product of gmm/likelihoods.py (khg_tpu scores
this loop outside any Pallas kernel too), and alignment is
align/viterbi.viterbi_align_batch, the Viterbi kernel (csrc/viterbi.cu)
on the card.  CTC lattices have in-degree at most 3, so the kernel
takes its compiled route.

There is no TransitionModel in this configuration: CTC graph arcs carry
zero weight (the reference's ctc_topo.py likewise emits an unweighted
topology, reference scripts/ctc_topo.py:10-58), so the M-step updates
only the GMMs; mixture split-up reuses the gmm_est machinery with the
transition flag off.  The EM loop shape mirrors the reference's HMM
recipe (reference egs/yesno/train.py:116-222) minus the
transition/boost-silence steps that do not exist under CTC.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from khg_tpu_torch.align.packed import pack_graph, pack_graph_batch
from khg_tpu_torch.align.viterbi import viterbi_align_batch
from khg_tpu_torch.fstlib.fst import equal_align
from khg_tpu_torch.gmm.am_gmm import AmDiagGmm
from khg_tpu_torch.gmm.likelihoods import component_scores
from khg_tpu_torch.lang.ctc import build_ctc_training_graph, ctc_id2pdf
from khg_tpu_torch.recipes.steps import _flat_start_gmm, _global_moments, gmm_est
from khg_tpu_torch.stats.accum import AccumAmDiagGmm, accumulate_am_stats
from khg_tpu_torch.utils.convert import batched_graphs_to_torch, model_to_torch
from khg_tpu_torch.utils.platform import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def ctc_flat_start(
    feats: Sequence[np.ndarray],
    vocab_size: int,
    perturb_factor: float = 0.01,
    rng: Optional[np.random.Generator] = None,
) -> AmDiagGmm:
    """Flat start: one 1-Gaussian pdf per CTC symbol (blank included).

    Every pdf starts at the global feature moments; a small perturbation
    breaks the flat-start ties exactly as the reference's monophone init
    does (gmm_init_mono's perturb_factor).
    """
    am = AmDiagGmm()
    am.init(_flat_start_gmm(*_global_moments(feats)), vocab_size)
    if perturb_factor != 0.0:
        if rng is None:
            rng = np.random.default_rng(0)
        for i in range(am.num_pdfs):
            am.get_pdf(i).perturb(perturb_factor, rng=rng)
    return am


def _batch_feats(
    feats: Sequence[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    B = len(feats)
    T = max(f.shape[0] for f in feats)
    D = feats[0].shape[1]
    out = np.zeros((B, T, D), dtype=np.float32)
    lens = np.zeros(B, dtype=np.int32)
    for i, f in enumerate(feats):
        out[i, : f.shape[0]] = f
        lens[i] = f.shape[0]
    return out, lens


def collapse_ctc_labels(labels: Sequence[int]) -> List[int]:
    """Collapse a per-frame SHIFTED CTC label path to its token sequence
    (drop blanks, dedupe runs) — the standard CTC decoding collapse."""
    out: List[int] = []
    prev = None
    for lab in labels:
        tok = int(lab) - 1  # unshift: graph ilabels are token+1
        if tok != 0 and tok != prev:
            out.append(tok)
        prev = tok
    return out


def train_ctc_gmm(
    feats: Sequence[np.ndarray],
    token_seqs: Sequence[Sequence[int]],
    vocab_size: int,
    num_passes: int = 8,
    acoustic_scale: float = 1.0,
    mixup: int = 0,
    mixup_pass: Optional[int] = None,
    perturb_factor: float = 0.01,
    seed: int = 0,
    am: Optional[AmDiagGmm] = None,
    device: DeviceLike = None,
) -> Tuple[AmDiagGmm, List[float], List[List[int]]]:
    """EM-train a CTC-topology GMM system; returns (am, avg-loglike
    trajectory, final per-utterance collapsed token hypotheses).

    Viterbi EM over the blank-insertion training graphs, all utterances
    in one batch: align (exact batched DP on ``device``) -> accumulate
    (dense stats fold) -> MLE update on the host.  ``mixup`` > 0 splits
    mixtures toward that total at ``mixup_pass`` (default: halfway),
    matching the reference recipe's mix-up timing (reference
    egs/yesno/train.py:199-206).  One generator seeded with ``seed``
    feeds the flat-start perturbation, pass 0's equal alignment and
    the mix-up, in khg_tpu's order.  Each pass logs its average
    log-likelihood, frame count and wall seconds.
    """
    assert len(feats) == len(token_seqs) and feats, "need utterances"
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    flat_started = am is None
    if am is None:
        am = ctc_flat_start(feats, vocab_size, perturb_factor, rng)
    assert am.num_pdfs == vocab_size

    id2pdf = ctc_id2pdf(vocab_size)
    id2pdf_t = torch.as_tensor(id2pdf.astype(np.int64), device=dev)
    fsts = [build_ctc_training_graph(list(t), vocab_size) for t in token_seqs]
    graphs = [pack_graph(g, id2pdf) for g in fsts]
    arrays = batched_graphs_to_torch(
        pack_graph_batch(graphs, states_pad_to=8, indeg_pad_to=1), dev
    )
    bfeats_np, lens_np = _batch_feats(feats)
    B, T, _ = bfeats_np.shape
    bfeats = torch.as_tensor(bfeats_np, device=dev)
    lens = torch.as_tensor(lens_np, device=dev)
    frame_mask = torch.arange(T, device=dev)[None, :] < lens[:, None].long()
    if mixup and mixup_pass is None:
        mixup_pass = num_passes // 2

    history: List[float] = []
    tids = None
    for it in range(num_passes):
        t0 = time.perf_counter()
        packed = am.pack(mix_pad_to=1)
        gconsts, miv, iv = model_to_torch(
            packed.gconsts, packed.means_invvars, packed.inv_vars, device=dev
        )
        scores = None
        if it == 0 and flat_started:
            # Pass 0 on a flat-started model: EQUAL alignment, not Viterbi.
            # Under the flat start every pdf scores (nearly) the same, so
            # the first Viterbi path is decided by the tie-breaking
            # perturbation and routinely lands EM in a permuted local
            # optimum (the blank pdf capturing a token's frames).  The
            # uniform-duration segmentation breaks the symmetry in the
            # right direction, exactly as align-equal-compiled does for
            # the reference's monophone flat start
            # (reference egs/yesno/train.py:116-133).
            tids_np = np.zeros((B, T), dtype=np.int32)
            failed_np = np.zeros(B, dtype=bool)
            for i, (g, f) in enumerate(zip(fsts, feats)):
                ea = equal_align(g, f.shape[0], rng)
                if ea is None:
                    failed_np[i] = True
                    continue
                tids_np[i, : f.shape[0]] = np.asarray(ea[0], dtype=np.int32)
            tids = torch.as_tensor(tids_np, device=dev)
            failed = torch.as_tensor(failed_np, device=dev)
        else:
            scores = component_scores(gconsts, miv, iv, bfeats)
            res = viterbi_align_batch(
                arrays, torch.logsumexp(scores, dim=-1), lens, id2pdf_t,
                acoustic_scale=acoustic_scale,
            )
            tids, failed = res.tids, res.failed
        n_failed = int(failed.sum())
        if n_failed:
            logger.warning("pass %d: %d utterances failed to align", it, n_failed)
        w = (frame_mask & ~failed[:, None]).to(torch.float32)
        stats = accumulate_am_stats(
            gconsts, miv, iv, bfeats, id2pdf_t[tids.long()], w, scores=scores,
        )
        del scores
        accs = AccumAmDiagGmm()
        accs.init(am, flags=7)  # means|variances|weights
        accs.add_dense(
            stats.occ.cpu().numpy(), stats.mean_acc.cpu().numpy(),
            stats.var_acc.cpu().numpy(), float(stats.tot_log_like),
            float(stats.tot_frames),
        )
        avg = accs.total_log_like / max(accs.total_frames, 1.0)
        history.append(avg)
        this_mixup = mixup if (mixup and it == mixup_pass) else 0
        gmm_est(am, accs, transition_model=None, transition_accs=None,
                mixup=this_mixup, update_flags="mvw", rng=rng)
        logger.info("CTC EM pass %d: avg loglike %.4f over %.0f frames (%.3f s)",
                    it, avg, accs.total_frames, time.perf_counter() - t0)

    tids_np = tids.cpu().numpy()
    hyps = [collapse_ctc_labels(tids_np[i, : lens_np[i]]) for i in range(B)]
    return am, history, hyps
