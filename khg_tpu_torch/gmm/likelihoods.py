"""GMM log-likelihoods in PyTorch (port of khg_tpu/gmm/likelihoods.py).

The per-frame, per-pdf log-likelihood of a diagonal GMM in exponential
form is

    loglike[t, p] = logsumexp_k( gconst[p,k] + M[p,k]·x[t] - 0.5 V[p,k]·x[t]² )

Stacking all pdfs (padded to K) makes scoring one matrix product

    scores = [x, x²] @ [M, -0.5 V]^T + gconsts            # (T, P*K)
    loglikes = logsumexp over K                            # (T, P)

Padding components carry gconst = -inf so they cannot win the logsumexp.
These are plain GEMMs (``torch.matmul``, full fp32: the package turns
TF32 off) and ``torch.logsumexp``; the fused single-pass kernel is
``gmm/fused_loglikes.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def stack_model(
    gconsts: torch.Tensor, means_invvars: torch.Tensor, inv_vars: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P,K), (P,K,D), (P,K,D) -> A (P*K, 2D), g (P*K,)."""
    P, K, D = means_invvars.shape
    A = torch.cat([means_invvars, -0.5 * inv_vars], dim=-1)
    return A.reshape(P * K, 2 * D), gconsts.reshape(P * K)


def expand_feats(feats: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., 2D) with [x, x²]."""
    return torch.cat([feats, feats * feats], dim=-1)


def component_scores(
    gconsts: torch.Tensor,
    means_invvars: torch.Tensor,
    inv_vars: torch.Tensor,
    feats: torch.Tensor,
    compute_dtype: Optional[str] = None,
) -> torch.Tensor:
    """Per-component log-likelihoods: (..., T, D) feats -> (..., T, P, K).

    ``compute_dtype='bfloat16'`` rounds both GEMM operands to bf16 and
    accumulates in f32 (products of bf16 values are exact in f32)."""
    P, K, D = means_invvars.shape
    A, g = stack_model(gconsts, means_invvars, inv_vars)
    x = expand_feats(feats.to(torch.float32))
    if compute_dtype == "bfloat16":
        A = A.to(torch.bfloat16).to(torch.float32)
        x = x.to(torch.bfloat16).to(torch.float32)
    scores = torch.matmul(x, A.T) + g
    return scores.reshape(feats.shape[:-1] + (P, K))


def loglikes(
    gconsts: torch.Tensor,
    means_invvars: torch.Tensor,
    inv_vars: torch.Tensor,
    feats: torch.Tensor,
    compute_dtype: Optional[str] = None,
) -> torch.Tensor:
    """Total per-pdf log-likelihoods: (..., T, D) feats -> (..., T, P)."""
    scores = component_scores(
        gconsts, means_invvars, inv_vars, feats, compute_dtype=compute_dtype
    )
    return torch.logsumexp(scores, dim=-1)


def component_scores_per_state(
    gconsts: torch.Tensor,        # (P, K)
    means_invvars: torch.Tensor,  # (P, K, D)
    inv_vars: torch.Tensor,       # (P, K, D)
    state_pdf: torch.Tensor,      # (B, S) int: pdf of each graph state
    feats: torch.Tensor,          # (B, T, D)
    compute_dtype: Optional[str] = None,
) -> torch.Tensor:
    """(B, T, S, K) f32 per-component scores of each graph STATE's pdf.

    The S-factored analogue of component_scores: the model rows are
    gathered once per (b, s) as (B, S, K, 2D) and the product with
    [x, x²] shrinks by P/S.  Shared by per-state alignment scoring
    (loglikes_per_state) and the local-state stats fold
    (stats.accum.accumulate_am_stats_local).  ``compute_dtype`` as in
    component_scores: 'bfloat16' rounds both operands to bf16, and the
    products and sums stay f32."""
    P, K, D = means_invvars.shape
    A, g = stack_model(gconsts, means_invvars, inv_vars)
    spdf = state_pdf.long()
    A_state = A.reshape(P, K, 2 * D)[spdf]           # (B, S, K, 2D)
    g_state = g.reshape(P, K)[spdf]                  # (B, S, K)
    x2 = expand_feats(feats.to(torch.float32))       # (B, T, 2D)
    if compute_dtype == "bfloat16":
        A_state = A_state.to(torch.bfloat16).to(torch.float32)
        x2 = x2.to(torch.bfloat16).to(torch.float32)
    return torch.einsum("btd,bskd->btsk", x2, A_state) + g_state[:, None]


def loglikes_per_state(
    gconsts: torch.Tensor,
    means_invvars: torch.Tensor,
    inv_vars: torch.Tensor,
    state_pdf: torch.Tensor,
    feats: torch.Tensor,
    compute_dtype: Optional[str] = None,
) -> torch.Tensor:
    """(B, T, S) log-likelihoods of each graph state's pdf: the values
    of loglikes(...)[b, t, state_pdf[b, s]] without scoring the pdfs
    outside the graph."""
    scores = component_scores_per_state(
        gconsts, means_invvars, inv_vars, state_pdf, feats,
        compute_dtype=compute_dtype,
    )
    return torch.logsumexp(scores, dim=-1)


def loglikes_np(packed, feats, device=None):
    """Host wrapper taking a PackedGmm: (T, D) numpy feats -> (T, P) f32
    numpy log-likelihoods, computed on ``device`` (None means CUDA) by
    ``gmm/fused_loglikes.loglikes_fused``: the kernel on the card, the
    plain version on the CPU."""
    # imported here: fused_loglikes imports this module
    from khg_tpu_torch.gmm.fused_loglikes import loglikes_fused
    from khg_tpu_torch.utils.convert import model_to_torch, to_tensor
    from khg_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    g, m, v = model_to_torch(
        packed.gconsts, packed.means_invvars, packed.inv_vars, device=dev
    )
    x = to_tensor(feats, dev, torch.float32)
    return loglikes_fused(g, m, v, x).cpu().numpy()
