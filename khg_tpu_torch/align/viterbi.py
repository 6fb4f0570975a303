"""Exact batched Viterbi alignment over packed graphs (port of
khg_tpu/align/viterbi.py::viterbi_align_batch).

Per frame t the DP updates all (state, incoming-arc) pairs at once:

    score[b, s, m] = alpha[b, in_src[b,s,m]] + in_cost[b,s,m]
                     - acoustic_scale * ll[b, t, in_pdf[b,s,m]]
    alpha'[b, s]   = min_m score[b, s, m];  bp[t, b, s] = first argmin_m

followed by a reverse loop for the backtrace.  ``viterbi_align_batch``
runs the CUDA kernel csrc/viterbi.cu for CUDA tensors and its plain
version, the eager DP, for CPU tensors (align/viterbi_kernel.py).  This
is the path for batches that do not fit the banded kernel (parallel
arcs, or no band menu covers them), and for align_backend="xla".

"Alignment failure" means the graph cannot emit exactly T frames,
reported via a total cost at or above FAIL_THRESHOLD.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Costs at/above this threshold mean "unreachable".
FAIL_THRESHOLD = 1.0e29


class ViterbiResult(NamedTuple):
    tids: torch.Tensor           # (B, T) int32 frame alignment (0 past utt end)
    total_cost: torch.Tensor     # (B,) float32 graph+acoustic cost of best path
    acoustic_cost: torch.Tensor  # (B,) float32 acoustic part (scaled)
    failed: torch.Tensor         # (B,) bool no complete path of length len


def path_acoustic_cost(loglikes, tids, num_frames, id2pdf, acoustic_scale):
    """(B,) scaled acoustic cost of the alignment ``tids``."""
    T = tids.shape[1]
    frame_mask = (
        torch.arange(T, device=tids.device)[None, :] < num_frames[:, None]
    )
    pdf_ids = id2pdf.long()[tids.long()].clamp(min=0)
    ll = torch.gather(loglikes, 2, pdf_ids[..., None])[..., 0]
    return -acoustic_scale * torch.sum(
        torch.where(frame_mask, ll, torch.zeros_like(ll)), dim=1
    )


def viterbi_align_batch(
    graphs,                      # BatchedGraphs of tensors (leading axis B)
    loglikes: torch.Tensor,      # (B, T, P)
    num_frames: torch.Tensor,    # (B,) int
    id2pdf: torch.Tensor,        # (num_tids+1,) int
    acoustic_scale: float = 1.0,
    state_pdf: Optional[torch.Tensor] = None,  # (B, S) int or None
) -> ViterbiResult:
    """Exact batched Viterbi alignment of B utterances: the kernel on
    CUDA (any S and M), the eager DP on the CPU.

    ``state_pdf`` (align.packed.uniform_dest_pdf) is accepted for
    khg_tpu's signature and not read.  There it switches to a per-state
    acoustic lattice, which scores each state by its one pdf instead of
    each arc by its own.  The two differ only on padding arcs, whose
    pdf is a placeholder and whose cost BIG swamps any score, so every
    feasible path, its cost and the failure flags are the same.  The
    kernel and the eager DP both keep the per-arc select, which keeps
    them bit-equal to each other."""
    # imported here: viterbi_kernel imports banded_kernel, which imports
    # this module
    from khg_tpu_torch.align.viterbi_kernel import viterbi_cuda, viterbi_plain

    dev = loglikes.device
    if dev.type == "cuda":
        tids, total_cost = viterbi_cuda(
            graphs, loglikes.contiguous(),
            num_frames.to(device=dev, dtype=torch.int32).contiguous(),
            acoustic_scale,
        )
    else:
        tids, total_cost = viterbi_plain(
            graphs, loglikes, num_frames, acoustic_scale
        )
    nf = num_frames.to(device=dev, dtype=torch.int64)
    acoustic_cost = path_acoustic_cost(
        loglikes, tids, nf, id2pdf.to(dev), acoustic_scale
    )
    return ViterbiResult(tids, total_cost, acoustic_cost,
                         total_cost >= FAIL_THRESHOLD)
