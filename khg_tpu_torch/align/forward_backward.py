"""Forward-backward (Baum-Welch) over packed graphs as an eager PyTorch
DP (port of khg_tpu/align/forward_backward.py).

Computes exact per-frame pdf occupation posteriors gamma[t, p] and
per-transition-id expected counts under each utterance's training
graph: the soft-EM alternative to Viterbi alignment.  Works in the
log-prob domain (negated costs):

  alpha[t+1][v] = logsumexp_m( alpha[t][in_src[v,m]] - in_cost[v,m]
                               + scale * ll[t, in_pdf[v,m]] )
  beta[t][s]    = logsumexp_m( beta[t+1][out_dst[s,m]] - out_cost[s,m]
                               + scale * ll[t, out_pdf[s,m]] )
  arc posterior = exp(alpha[t][s] - w + scale * ll - logZ + beta[t+1][v])

Three routes, as in khg_tpu:

- general: the acoustic term is selected per arc (``state_pdf=None``);
- ``state_pdf``: every arc into a state carries that state's pdf
  (align.packed.uniform_dest_pdf), so the acoustic lattice is gathered
  once per state and rides beta in the backward step;
- ``time_chunk=C``: the forward pass keeps only the alpha at every C-th
  frame and the backward pass recomputes each chunk's alphas from it,
  which cuts alpha memory from O(T) to O(T/C + C) frames for one more
  forward sweep.  With ``time_chunk=None`` every alpha is kept.  The
  recomputation repeats the same operations, so both memory plans give
  bit-identical results (khg_tpu applies it on the ``state_pdf`` route
  only; here it applies on both).

Index lookups are ``torch.gather``; khg_tpu's one-hot and factored
selects exist only because dynamic gathers inside a TPU scan serialise.
Per-state posteriors become pdf posteriors by one batched one-hot
product and transition counts by ``stats.accum.segment_sum``: neither
uses atomics, so runs on the card are repeatable.  Each route keeps the
association of khg_tpu's formulas, so the two packages also agree on
utterances with no complete path, whose posteriors are meaningless
(callers mask them with ``failed``).

Frames at or past an utterance's length leave alpha and beta unchanged
and carry zero posteriors.  This is the path of every batch that does
not fit the banded kernels (align/banded_fb.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from khg_tpu_torch.stats.accum import segment_sum

NEG_BIG = -1.0e30


class FBResult(NamedTuple):
    log_z: torch.Tensor       # (B,) total log-prob of each utterance
    gamma: torch.Tensor       # (B, T, P) per-frame pdf posteriors
    tid_counts: torch.Tensor  # (B, num_tids+1) expected transition counts
    failed: torch.Tensor      # (B,) bool (no complete path)


def tid_counts_from_posteriors(
    arc_post: torch.Tensor, arc_tid: torch.Tensor, num_tids: int
) -> torch.Tensor:
    """(B, num_tids+1) sums of the per-arc posteriors ``arc_post``
    (B, ...) by transition id ``arc_tid`` (same shape); tid 0 (padding)
    is zeroed.  A segment sum: the same order on every run."""
    B = arc_post.shape[0]
    n = num_tids + 1
    rows = torch.arange(B, device=arc_post.device).reshape(
        (B,) + (1,) * (arc_tid.dim() - 1)
    )
    index = (rows * n + arc_tid.long()).reshape(-1)
    counts = segment_sum(arc_post.reshape(-1), index, B * n).reshape(B, n)
    counts[:, 0] = 0.0
    return counts


def gamma_from_state_posteriors(
    spost: torch.Tensor, state_pdf: torch.Tensor, num_pdfs: int
) -> torch.Tensor:
    """(B, T, S) state posteriors -> (B, T, P) pdf posteriors: one
    batched product with the (B, S, P) one-hot of ``state_pdf``."""
    onehot = torch.nn.functional.one_hot(state_pdf.long(), num_pdfs)
    return torch.bmm(spost, onehot.to(spost.dtype))


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.clamp(torch.logsumexp(x, dim=dim), min=NEG_BIG)


def forward_backward_batch(
    graphs,                     # BatchedGraphs of tensors (leading axis B)
    loglikes: torch.Tensor,     # (B, T, P)
    num_frames: torch.Tensor,   # (B,)
    num_tids: int,
    acoustic_scale: float = 1.0,
    state_pdf: Optional[torch.Tensor] = None,  # (B, S) or None
    time_chunk: Optional[int] = None,
) -> FBResult:
    """Exact batched forward-backward of B utterances (see module
    docstring for the routes).  Build ``graphs`` with
    align.packed.pack_graph_batch(semiring="log") and
    utils.convert.batched_graphs_to_torch."""
    in_src = graphs.in_src.long()
    B, S, M = in_src.shape
    Mo = graphs.out_dst.shape[2]
    T, P = loglikes.shape[1], loglikes.shape[2]
    dev = loglikes.device
    nf = num_frames.to(device=dev, dtype=torch.int64)
    n_steps = min(int(nf.max()), T) if B else 0
    src_flat = in_src.reshape(B, S * M)
    dst_flat = graphs.out_dst.long().reshape(B, S * Mo)
    in_cost, out_cost = graphs.in_cost, graphs.out_cost
    init = torch.clamp(-graphs.init_cost, min=NEG_BIG)
    fin = torch.clamp(-graphs.final_cost, min=NEG_BIG)

    if state_pdf is not None:
        sac = acoustic_scale * torch.gather(
            loglikes, 2, state_pdf.long()[:, None, :].expand(B, T, S)
        )  # (B, T, S)
    else:
        in_pdf = graphs.in_pdf.long().reshape(B, S * M)
        out_pdf = graphs.out_pdf.long().reshape(B, S * Mo)
        oh_in_pdf = torch.nn.functional.one_hot(in_pdf, P).to(torch.float32)

    def fwd_step(alpha, t):
        ga = torch.gather(alpha, 1, src_flat).reshape(B, S, M)
        if state_pdf is not None:
            contrib = ga - in_cost + sac[:, t, :, None]
        else:
            ac = torch.gather(loglikes[:, t], 1, in_pdf).reshape(B, S, M)
            contrib = ga - in_cost + acoustic_scale * ac
        new_alpha = _lse(contrib, 2)
        return torch.where((t < nf)[:, None], new_alpha, alpha)

    # forward: keep the alpha before every C-th frame (C=1: all of them)
    C = 1 if time_chunk is None else max(1, min(int(time_chunk), max(n_steps, 1)))
    ckpts = []
    alpha = init
    for t in range(n_steps):
        if t % C == 0:
            ckpts.append(alpha)
        alpha = fwd_step(alpha, t)
    log_z = torch.logsumexp(alpha + fin, dim=1)
    failed = log_z < NEG_BIG / 2

    lz = log_z[:, None]
    beta = fin
    arc_post_sum = torch.zeros((B, S * M), dtype=torch.float32, device=dev)
    if state_pdf is not None:
        spost = torch.zeros((B, T, S), dtype=torch.float32, device=dev)
    else:
        gamma = torch.zeros((B, T, P), dtype=torch.float32, device=dev)
    for c in range(len(ckpts) - 1, -1, -1):
        t0 = c * C
        alphas = [ckpts[c]]  # recompute the chunk's alphas from its start
        for t in range(t0, min(t0 + C, n_steps) - 1):
            alphas.append(fwd_step(alphas[-1], t))
        for t in range(min(t0 + C, n_steps) - 1, t0 - 1, -1):
            active = (t < nf)[:, None]
            ga = torch.gather(alphas[t - t0], 1, src_flat).reshape(B, S, M)
            if state_pdf is not None:
                bplus = beta + sac[:, t]
                logp = ga - in_cost + (bplus - lz)[:, :, None]
            else:
                ac = torch.gather(loglikes[:, t], 1, in_pdf).reshape(B, S, M)
                logp = (ga - in_cost + acoustic_scale * ac
                        + beta[:, :, None] - lz[:, :, None])
            post = torch.exp(torch.clamp(logp, max=0.0))
            post = torch.where(active[:, :, None], post, 0.0)
            post_flat = post.reshape(B, S * M)
            arc_post_sum = arc_post_sum + post_flat
            if state_pdf is not None:
                spost[:, t] = torch.sum(post, dim=2)
                gb = torch.gather(bplus, 1, dst_flat).reshape(B, S, Mo)
                new_beta = _lse(gb - out_cost, 2)
            else:
                gamma[:, t] = torch.bmm(post_flat[:, None, :], oh_in_pdf)[:, 0]
                gb = torch.gather(beta, 1, dst_flat).reshape(B, S, Mo)
                aco = torch.gather(loglikes[:, t], 1, out_pdf).reshape(B, S, Mo)
                new_beta = _lse(gb - out_cost + acoustic_scale * aco, 2)
            beta = torch.where(active, new_beta, beta)

    if state_pdf is not None:
        gamma = gamma_from_state_posteriors(spost, state_pdf, P)
    tid_counts = tid_counts_from_posteriors(
        arc_post_sum, graphs.in_tid.reshape(B, S * M), num_tids
    )
    return FBResult(log_z, gamma, tid_counts, failed)
