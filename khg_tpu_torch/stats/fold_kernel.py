"""Wide-model stats fold: the CUDA kernel ``csrc/stats_fold.cu`` and its
plain PyTorch version.

Port of khg_tpu/stats/pallas_fold.py::accumulate_am_stats_fold_pallas.
Per frame: the aligned local state's K component scores, their
logsumexp and posteriors times the frame weight, folded as [occ,
post*x, post*x²] into per-(utterance, state) accumulators with
Σ w·loglike; then the (B, S) partials are summed onto the pdf axis
(``stats.accum.scatter_local_stats``, a sorted segment sum).  The
plain version is ``stats.accum.accumulate_am_stats_local`` itself: the
two compute the same function up to f32 summation order.

The kernel rescores only the aligned state's K rows of each frame (the
TPU kernel scores all S*K and selects one), runs one block per
(utterance, state) and uses no atomics, so reruns are bit-identical.

``accumulate_am_stats_fold`` takes the kernel for CUDA tensors and the
plain version only for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from khg_tpu_torch.align.banded_kernel import _SMEM_LIMIT, check_tensors
from khg_tpu_torch.stats.accum import (
    DenseStats,
    accumulate_am_stats_local,
    scatter_local_stats,
)

_CHUNK = 32  # frames per chunk in csrc/stats_fold.cu


def fold_smem_bytes(K: int, D: int) -> int:
    """Shared memory of one block of csrc/stats_fold.cu: the state's K
    model rows and accumulators, and one chunk's frame rows, scores,
    weights and indices (mirrors fold_smem_bytes there)."""
    Q = 2 * D + 1
    return (2 * K * Q + _CHUNK * (2 * D + K + 3) + 1) * 4


def fold_kernel_fits(K: int, D: int) -> bool:
    return fold_smem_bytes(K, D) <= _SMEM_LIMIT


def fold_cuda(
    gconsts: torch.Tensor,        # (P, K) f32
    means_invvars: torch.Tensor,  # (P, K, D) f32
    inv_vars: torch.Tensor,       # (P, K, D) f32
    feats: torch.Tensor,          # (B, T, D) f32
    pdf_ids: torch.Tensor,        # (B, T) int32
    frame_weights: torch.Tensor,  # (B, T) f32
    state_pdf: torch.Tensor,      # (B, S) int32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/stats_fold.cu``: (local (B, S, K, 1+2D) stats [occ,
    post*x, post*x²], Σ w·loglike (B, S), Σ w (B, S)) per (utterance,
    state); a state that is not its pdf's first holds zeros."""
    from khg_tpu_torch import kernels

    P, K, D = means_invvars.shape
    B, T, _ = feats.shape
    S = state_pdf.shape[1]
    check_tensors("fold_cuda", feats.device, [
        (gconsts, torch.float32, (P, K)),
        (means_invvars, torch.float32, (P, K, D)),
        (inv_vars, torch.float32, (P, K, D)),
        (feats, torch.float32, (B, T, D)),
        (pdf_ids, torch.int32, (B, T)),
        (frame_weights, torch.float32, (B, T)),
        (state_pdf, torch.int32, (B, S)),
    ])
    if not fold_kernel_fits(K, D):
        raise ValueError(
            f"fold_cuda: K={K} components of D={D} need "
            f"{fold_smem_bytes(K, D)} B > {_SMEM_LIMIT} B of shared memory"
        )
    dev = feats.device
    local = torch.empty((B, S, K, 2 * D + 1), dtype=torch.float32, device=dev)
    ll = torch.empty((B, S), dtype=torch.float32, device=dev)
    frames = torch.empty((B, S), dtype=torch.float32, device=dev)
    err = kernels.lib().launch_stats_fold(
        gconsts.data_ptr(), means_invvars.data_ptr(), inv_vars.data_ptr(),
        feats.data_ptr(), pdf_ids.data_ptr(), frame_weights.data_ptr(),
        state_pdf.data_ptr(), local.data_ptr(), ll.data_ptr(),
        frames.data_ptr(), B, S, T, K, D, kernels.stream_handle(dev),
    )
    kernels.check("stats_fold", err)
    return local, ll, frames


def accumulate_am_stats_fold(
    gconsts: torch.Tensor,
    means_invvars: torch.Tensor,
    inv_vars: torch.Tensor,
    feats: torch.Tensor,
    pdf_ids: torch.Tensor,
    frame_weights: torch.Tensor,
    state_pdf: torch.Tensor,
) -> DenseStats:
    """accumulate_am_stats_local's stats: the kernel, then the P scatter,
    for CUDA tensors; the plain version for CPU tensors."""
    if feats.device.type != "cuda":
        return accumulate_am_stats_local(
            gconsts, means_invvars, inv_vars, feats, pdf_ids, frame_weights,
            state_pdf,
        )
    P, K, D = means_invvars.shape
    local, ll, frames = fold_cuda(
        gconsts.contiguous(), means_invvars.contiguous(),
        inv_vars.contiguous(), feats.contiguous(),
        pdf_ids.to(torch.int32).contiguous(),
        frame_weights.to(torch.float32).contiguous(),
        state_pdf.to(torch.int32).contiguous(),
    )
    out = scatter_local_stats(local, state_pdf, P)
    return DenseStats(out[..., 0], out[..., 1:1 + D], out[..., 1 + D:],
                      torch.sum(ll), torch.sum(frames))
