"""Sufficient-statistics accumulation (port of khg_tpu/stats/accum.py).

Host view: AccumDiagGmm / AccumAmDiagGmm with float64 0th/1st/2nd-order
stats, additive across shards — copied from khg_tpu unchanged.

Device path: ``accumulate_am_stats`` — given frame-aligned pdf-ids, one
pass computes per-component posteriors of each frame's pdf and reduces
the three stats tensors with a sorted segment sum over the pdf axis
(``segment_sum``), where khg_tpu used one-hot GEMMs (exact segment sums
on the TPU's MXU).  ``accumulate_transition_stats`` counts aligned
transition ids the same way.  ``accumulate_am_stats_soft`` is the
Baum-Welch variant: every frame weighted by its pdf posteriors.
``accumulate_am_stats_local`` is the wide-model (triphone-scale) fold:
posteriors and moments accumulate per graph state of each utterance,
then one segment sum scatters them to the pdf axis; on the card its
kernel is ``stats/fold_kernel.py``.  Replaces the reference's per-frame Eigen loop
(reference kaldi-hmm-gmm/csrc/mle-diag-gmm.cc:100-158,
mle-am-diag-gmm.cc:41-53).
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from khg_tpu_torch.est.flags import GMM_MEANS, GMM_VARIANCES, GMM_WEIGHTS, augment_gmm_flags
from khg_tpu_torch.gmm.am_gmm import AmDiagGmm
from khg_tpu_torch.gmm.diag_gmm import DiagGmm

logger = logging.getLogger(__name__)

# accumulate_am_stats: above this many BYTES of all-pdf score tensor
# (N, P, K) the per-frame gather path is used instead of building it
_SCORES_ALL_MAX_BYTES = 1 << 30


class AccumDiagGmm:
    """Per-pdf accumulator: occupancy (K,), mean (K,D), var (K,D) in f64."""

    def __init__(self, num_comp: int = 0, dim: int = 0, flags: int = 0):
        if num_comp > 0:
            self.resize(num_comp, dim, flags)
        else:
            self.num_comp = 0
            self.dim = 0
            self.flags = 0

    def resize(self, num_comp: int, dim: int, flags: int) -> None:
        assert num_comp > 0 and dim > 0
        self.num_comp = num_comp
        self.dim = dim
        self.flags = augment_gmm_flags(flags)
        self.occupancy = np.zeros(num_comp, dtype=np.float64)
        self.mean_accumulator = (
            np.zeros((num_comp, dim), dtype=np.float64)
            if self.flags & GMM_MEANS
            else np.zeros((0, 0))
        )
        self.variance_accumulator = (
            np.zeros((num_comp, dim), dtype=np.float64)
            if self.flags & GMM_VARIANCES
            else np.zeros((0, 0))
        )

    def set_zero(self) -> None:
        self.occupancy[:] = 0
        if self.flags & GMM_MEANS:
            self.mean_accumulator[:] = 0
        if self.flags & GMM_VARIANCES:
            self.variance_accumulator[:] = 0

    def scale(self, f: float) -> None:
        self.occupancy *= f
        if self.flags & GMM_MEANS:
            self.mean_accumulator *= f
        if self.flags & GMM_VARIANCES:
            self.variance_accumulator *= f

    def accumulate_for_component(
        self, data: np.ndarray, comp_index: int, weight: float
    ) -> None:
        self.occupancy[comp_index] += weight
        if self.flags & GMM_MEANS:
            self.mean_accumulator[comp_index] += data.astype(np.float64) * weight
        if self.flags & GMM_VARIANCES:
            self.variance_accumulator[comp_index] += (
                data.astype(np.float64) ** 2 * weight
            )

    def accumulate_from_posteriors(
        self, data: np.ndarray, posteriors: np.ndarray
    ) -> None:
        p = posteriors.astype(np.float64)
        self.occupancy += p
        if self.flags & GMM_MEANS:
            self.mean_accumulator += p[:, None] * data.astype(np.float64)[None, :]
        if self.flags & GMM_VARIANCES:
            self.variance_accumulator += (
                p[:, None] * (data.astype(np.float64) ** 2)[None, :]
            )

    def accumulate_from_diag(
        self, gmm: DiagGmm, data: np.ndarray, weight: float
    ) -> float:
        log_like, post = gmm.component_posteriors(data)
        self.accumulate_from_posteriors(data, post * weight)
        return log_like

    def add(self, scale: float, other: "AccumDiagGmm") -> None:
        self.occupancy += scale * other.occupancy
        if self.flags & GMM_MEANS:
            self.mean_accumulator += scale * other.mean_accumulator
        if self.flags & GMM_VARIANCES:
            self.variance_accumulator += scale * other.variance_accumulator

    def smooth_stats(self, tau: float) -> None:
        """Scale 1st/2nd-order stats so they appear to have (occ+tau) counts."""
        smoothing = (self.occupancy + tau) / self.occupancy
        self.mean_accumulator *= smoothing[:, None]
        self.variance_accumulator *= smoothing[:, None]
        self.occupancy += tau

    def smooth_with_accum(self, tau: float, src: "AccumDiagGmm") -> None:
        """Add tau virtual counts per component shaped like ``src``'s stats
        (mle-diag-gmm.cc:209-226).  Not valid for weight updates."""
        assert src.num_comp == self.num_comp and src.dim == self.dim
        for i in range(self.num_comp):
            if src.occupancy[i] != 0.0:
                self.occupancy[i] += tau
                self.mean_accumulator[i] += (
                    src.mean_accumulator[i] * tau / src.occupancy[i]
                )
                self.variance_accumulator[i] += (
                    src.variance_accumulator[i] * tau / src.occupancy[i]
                )
            else:
                logger.warning("Cannot smooth: source occupancy is zero")

    def smooth_with_model(self, tau: float, gmm: DiagGmm) -> None:
        """Add tau virtual counts per component drawn from the model itself
        (mle-diag-gmm.cc:228-241)."""
        assert gmm.num_gauss == self.num_comp and gmm.dim == self.dim
        means = gmm.get_means().astype(np.float64)
        variances = gmm.get_vars().astype(np.float64)
        self.mean_accumulator += means * tau
        self.variance_accumulator += (variances + means**2) * tau
        self.occupancy += tau


class AccumAmDiagGmm:
    def __init__(self):
        self.accs: List[AccumDiagGmm] = []
        self.total_frames = 0.0
        self.total_log_like = 0.0

    def init(self, model: AmDiagGmm, flags: int) -> None:
        self.accs = []
        for i in range(model.num_pdfs):
            acc = AccumDiagGmm()
            acc.resize(model.get_pdf(i).num_gauss, model.dim, flags)
            self.accs.append(acc)
        self.total_frames = 0.0
        self.total_log_like = 0.0

    @property
    def num_accs(self) -> int:
        return len(self.accs)

    @property
    def tot_count(self) -> float:
        return self.total_frames

    @property
    def tot_log_like(self) -> float:
        return self.total_log_like

    def get_acc(self, i: int) -> AccumDiagGmm:
        return self.accs[i]

    def accumulate_for_gmm(
        self, model: AmDiagGmm, data: np.ndarray, gmm_index: int, weight: float
    ) -> float:
        log_like = self.accs[gmm_index].accumulate_from_diag(
            model.get_pdf(gmm_index), data, weight
        )
        self.total_log_like += log_like * weight
        self.total_frames += weight
        return log_like

    def add(self, scale: float, other: "AccumAmDiagGmm") -> None:
        self.total_frames += scale * other.total_frames
        self.total_log_like += scale * other.total_log_like
        assert self.num_accs == other.num_accs
        for a, b in zip(self.accs, other.accs):
            a.add(scale, b)

    # ------------------------------------------------------------- device IO

    def add_dense(
        self,
        occ: np.ndarray,       # (P, K)
        mean_acc: np.ndarray,  # (P, K, D)
        var_acc: np.ndarray,   # (P, K, D)
        tot_log_like: float,
        tot_frames: float,
    ) -> None:
        """Fold device-computed padded stats into the ragged host view."""
        for p, acc in enumerate(self.accs):
            k = acc.num_comp
            acc.occupancy += occ[p, :k].astype(np.float64)
            if acc.flags & GMM_MEANS:
                acc.mean_accumulator += mean_acc[p, :k, : acc.dim].astype(np.float64)
            if acc.flags & GMM_VARIANCES:
                acc.variance_accumulator += var_acc[p, :k, : acc.dim].astype(
                    np.float64
                )
        self.total_log_like += float(tot_log_like)
        self.total_frames += float(tot_frames)


def segment_sum(src: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) sums ``out[j] = sum of src[i] with index[i] == j``, added
    in increasing i on every run and device (checkpoint resume must be
    bit-exact; CUDA's ``index_add_`` adds with atomics in whatever order
    they land).  A stable sort of the rows by index, then one serial sum
    per (segment, column): no atomics, no host sync.  Rows whose index
    lies outside [0, n) are dropped, as jax.ops.segment_sum drops them
    (CTC's id2pdf maps the padding tid 0 to pdf -1): they sort into a
    last segment that is cut off."""
    index = torch.where((index >= 0) & (index < n), index, n)
    order = torch.argsort(index, stable=True)
    bounds = torch.searchsorted(
        index[order], torch.arange(n + 2, device=index.device, dtype=index.dtype)
    )
    return torch.segment_reduce(
        src[order], "sum", lengths=bounds.diff(), axis=0, unsafe=True
    )[:n]


class DenseStats(NamedTuple):
    """Device-side padded stats; additive."""

    occ: torch.Tensor       # (P, K)
    mean_acc: torch.Tensor  # (P, K, D)
    var_acc: torch.Tensor   # (P, K, D)
    tot_log_like: torch.Tensor  # ()
    tot_frames: torch.Tensor    # ()


def accumulate_am_stats(
    gconsts: torch.Tensor,        # (P, K)
    means_invvars: torch.Tensor,  # (P, K, D)
    inv_vars: torch.Tensor,       # (P, K, D)
    feats: torch.Tensor,          # (B, T, D)
    pdf_ids: torch.Tensor,        # (B, T) int
    frame_weights: torch.Tensor,  # (B, T) f32 (0 masks a frame out)
    scores: Optional[torch.Tensor] = None,  # (B, T, P, K) precomputed
) -> DenseStats:
    """E-step stats from a fixed frame-level pdf alignment.

    Per frame: component posteriors of the aligned pdf; stats reduced
    over frames with ``segment_sum`` on the pdf axis.  Mirrors
    AccumulateForGmm with weight=frame_weights (1.0 normally, 0.0 for
    padding/failed frames).  Pass ``scores`` (gmm.likelihoods.
    component_scores of the same model and features) when the caller
    already computed them for alignment scoring; without them, above
    1 GiB of (N, P, K) scores each frame's aligned pdf rows are
    gathered instead."""
    from khg_tpu_torch.gmm.likelihoods import component_scores

    P, K, D = means_invvars.shape
    B, T, _ = feats.shape
    N = B * T
    x = feats.reshape(N, D)
    pid = pdf_ids.reshape(N).long()
    w = frame_weights.reshape(N).to(torch.float32)
    if scores is None and N * P * K * 4 > _SCORES_ALL_MAX_BYTES:
        # wide (triphone-scale) models: the (N, P, K) scores would not
        # fit, so gather each frame's aligned pdf rows instead (N*K*D
        # floats, far fewer than N*P*K here)
        sel = (
            gconsts[pid]
            + torch.einsum("nkd,nd->nk", means_invvars[pid], x)
            - 0.5 * torch.einsum("nkd,nd->nk", inv_vars[pid], x * x)
        )                                              # (N, K)
    else:
        if scores is None:
            scores = component_scores(gconsts, means_invvars, inv_vars, feats)
        rows = torch.arange(N, device=feats.device)
        sel = scores.reshape(N, P, K)[rows, pid]       # (N, K) aligned pdf
    log_like = torch.logsumexp(sel, dim=1)             # (N,)
    post = torch.softmax(sel, dim=1) * w[:, None]      # (N, K)
    occ = segment_sum(post, pid, P)                    # (P, K)
    xw = torch.cat([x, x * x], dim=1)                  # (N, 2D)
    pkx = segment_sum(post[:, :, None] * xw[:, None, :], pid, P)
    # padding frames may carry any pdf: w = 0 zeroes their terms
    tot_log_like = torch.sum(torch.where(w > 0, log_like * w, 0.0))
    return DenseStats(
        occ, pkx[..., :D], pkx[..., D:], tot_log_like, torch.sum(w)
    )


def scatter_local_stats(local: torch.Tensor, state_pdf: torch.Tensor,
                        num_pdfs: int) -> torch.Tensor:
    """(B, S, K, 1+2D) per-(utterance, state) stats -> (P, K, 1+2D),
    summed onto each state's pdf by ``segment_sum`` (deterministic)."""
    B, S, K, Q = local.shape
    out = segment_sum(local.reshape(B * S, K * Q),
                      state_pdf.long().reshape(B * S), num_pdfs)
    return out.reshape(num_pdfs, K, Q)


def accumulate_am_stats_local(
    gconsts: torch.Tensor,        # (P, K)
    means_invvars: torch.Tensor,  # (P, K, D)
    inv_vars: torch.Tensor,       # (P, K, D)
    feats: torch.Tensor,          # (B, T, D)
    pdf_ids: torch.Tensor,        # (B, T) int
    frame_weights: torch.Tensor,  # (B, T) f32 (0 masks a frame out)
    state_pdf: torch.Tensor,      # (B, S) int: pdf of each graph state
    state_scores: Optional[torch.Tensor] = None,  # (B, T, S, K) precomputed
) -> DenseStats:
    """Triphone-scale stats factored through each utterance's graph
    states (port of khg_tpu accumulate_am_stats_local).

    Every aligned pdf occurs among its utterance's graph states
    (S << P), so posteriors and moments accumulate per LOCAL state
    first, as one batched product over the frames, and
    ``scatter_local_stats`` adds the (B, S) partials onto the pdf axis.
    Each frame takes the first state of its aligned pdf (states of one
    pdf share their model rows).  A w>0 frame whose pdf is absent from
    ``state_pdf`` drops out of every output, tot_log_like and
    tot_frames included.  Matches accumulate_am_stats up to f32
    summation order.

    Pass ``state_scores`` (component_scores_per_state's, f32) when the
    caller already computed them for alignment scoring: the fold then
    does no scoring product."""
    from khg_tpu_torch.gmm.likelihoods import component_scores_per_state

    P, K, D = means_invvars.shape
    B, T, _ = feats.shape
    S = state_pdf.shape[1]
    dev = feats.device
    if state_scores is None:
        state_scores = component_scores_per_state(
            gconsts, means_invvars, inv_vars, state_pdf, feats
        )
    # padding components carry gconst = -inf: a finite floor keeps every
    # product finite, and exp(-1e30 - max) is exactly 0
    scores_sk = torch.clamp(state_scores, min=-1e30)           # (B, T, S, K)
    iota = torch.arange(S, device=dev)
    eq = state_pdf.long()[:, None, :] == pdf_ids.long()[:, :, None]
    sidx = torch.where(eq, iota, S).min(dim=-1).values         # (B, T)
    w = frame_weights.to(torch.float32)
    matched = (sidx < S) & (w > 0)
    wm = torch.where(matched, w, 0.0)
    sel = torch.gather(
        scores_sk, 2,
        sidx.clamp(max=max(S - 1, 0))[:, :, None, None].expand(B, T, 1, K),
    )[:, :, 0]                                                 # (B, T, K)
    log_like = torch.logsumexp(sel, dim=-1)                    # (B, T)
    post = torch.softmax(sel, dim=-1) * wm[..., None]          # (B, T, K)
    onehot = (sidx[..., None] == iota).to(torch.float32)       # (B, T, S)
    wsk = (onehot[..., None] * post[:, :, None, :]).reshape(B, T, S * K)
    xw1 = torch.cat([torch.ones_like(feats[..., :1]), feats, feats * feats],
                    dim=-1)                                    # (B, T, 1+2D)
    local = torch.bmm(wsk.transpose(1, 2), xw1)                # (B, S*K, 1+2D)
    out = scatter_local_stats(local.reshape(B, S, K, 1 + 2 * D), state_pdf, P)
    tot_log_like = torch.sum(torch.where(matched, log_like * w, 0.0))
    return DenseStats(out[..., 0], out[..., 1:1 + D], out[..., 1 + D:],
                      tot_log_like, torch.sum(wm))


def accumulate_am_stats_soft(
    gconsts: torch.Tensor,        # (P, K)
    means_invvars: torch.Tensor,  # (P, K, D)
    inv_vars: torch.Tensor,       # (P, K, D)
    feats: torch.Tensor,          # (B, T, D)
    gamma: torch.Tensor,          # (B, T, P) per-frame pdf posteriors
    scores: Optional[torch.Tensor] = None,  # (B, T, P, K) precomputed
) -> DenseStats:
    """Soft-EM (Baum-Welch) stats: every frame contributes to every pdf
    weighted by its occupation posterior gamma[t, p].

    Uses full per-component scores (B, T, P, K): memory O(B·T·P·K),
    fine for monophone-scale P; pass ``scores`` when the caller already
    computed them for scoring.  The moments are one product over the
    frames (``einsum``), as khg_tpu leaves them to XLA."""
    from khg_tpu_torch.gmm.likelihoods import component_scores

    P, K, D = means_invvars.shape
    B, T, _ = feats.shape
    N = B * T
    x = feats.reshape(N, D)
    w = gamma.reshape(N, P)
    if scores is None:
        scores = component_scores(gconsts, means_invvars, inv_vars, feats)
    scores = scores.reshape(N, P, K)
    post = torch.softmax(scores, dim=-1) * w[..., None]  # (N, P, K)
    # total log-like under the soft alignment: sum_t sum_p gamma * loglike
    ll = torch.logsumexp(scores, dim=-1)                 # (N, P)
    tot_log_like = torch.sum(torch.where(w > 0, ll * w, 0.0))
    occ = torch.sum(post, dim=0)                         # (P, K)
    xw = torch.cat([x, x * x], dim=1)                    # (N, 2D)
    pkx = torch.einsum("npk,nd->pkd", post, xw)
    return DenseStats(occ, pkx[..., :D], pkx[..., D:], tot_log_like, torch.sum(w))


def accumulate_transition_stats(
    tids: torch.Tensor, num_frames: torch.Tensor, num_tids: int
) -> torch.Tensor:
    """(num_tids+1,) float64 counts from batched alignments (tid 0 —
    padding — is zeroed)."""
    B, T = tids.shape
    dev = tids.device
    mask = (
        torch.arange(T, device=dev)[None, :]
        < num_frames.to(dev).reshape(B, 1)
    )
    stats = segment_sum(
        mask.reshape(-1).to(torch.float64), tids.long().reshape(-1), num_tids + 1
    )
    stats[0] = 0.0
    return stats
