"""Wide-model stats fold: the CUDA kernels ``csrc/stats_fold.cu`` and
their plain PyTorch version.

Port of khg_tpu/stats/pallas_fold.py::accumulate_am_stats_fold_pallas.
Per frame: the K component scores of its pdf's first graph state, their
logsumexp and posteriors times the frame weight, folded as [occ,
post*x, post*x²] per pdf, with Σ w·loglike and Σ w per (utterance,
state).  The plain version is ``stats.accum.accumulate_am_stats_local``
itself: the two compute the same function up to f32 summation order.

On the card (``fold_cuda``) five hand-written launches do it all:
match (each frame's first state and its rank in time order), group (the
(utterance, state) segments grouped by pdf, in ascending utterance),
place (each frame at its position in the frames sorted by (pdf, b, t)),
score (posteriors and feature rows at those positions, a block per 64
positions) and fold (a thread per row entry of four components walks its
pdf's frames; the (B, S) sums per segment; the unused pdfs' zero
rows).  No atomics on floats, so reruns are bit-identical, and the
sums keep the order of the first port's kernel and its segment-sum
scatter, so the outputs are too.

``accumulate_am_stats_fold`` takes the kernels for CUDA tensors and the
plain version only for CPU tensors.  The kernels take every K: where a
pdf's K model rows do not fit a score block beside one frame's scores,
the score launch stages them in chunks of components and keeps the
scores in the float workspace (``score_plan``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from khg_tpu_torch.align.banded_kernel import _SMEM_LIMIT, check_tensors
from khg_tpu_torch.stats.accum import DenseStats, accumulate_am_stats_local

# csrc/stats_fold.cu: threads of the score and fold blocks, frames per
# staged fold chunk, sorted positions per score block
_THREADS = 256
_CHUNK = 32
_SCORE_CH = 64
_NSTAGE = 3  # fold chunks in flight


def fold_kernel_fits(K: int, D: int) -> bool:
    """Whether the kernels take K components of D dims: their launches'
    own limits (mirrors launch_stats_fold_score and _fold): a score block
    holds at least one frame's row and one model row of 2D+1 floats, a
    fold block at least one frame in each of its buffers.  Every K fits,
    up to D = 19,359."""
    return score_plan(K, D)[0] >= 1 and fold_chunk(K, D) >= 1


def score_smem_bytes(K: int, D: int) -> int:
    """Dynamic shared memory of a score block: its frames' feature rows
    (D rounded up to 4 floats), model rows of 2D+1 floats, the frames'
    scores where they stay in shared memory, weights, weighted log Z,
    maxima and sums, and their indices, pdfs and first-frame flags
    (mirrors score_smem_bytes)."""
    ch, kc, in_smem = score_plan(K, D)
    return (ch * ((D + 3) & ~3) + kc * (2 * D + 1) + ch * ((K if in_smem else 0) + 4)
            ) * 4 + 3 * ch * 4


def score_chunk(K: int, D: int) -> int:
    """Sorted positions a score block of a whole pdf takes: 64, fewer
    where their rows and scores would not fit beside the K model rows;
    0 where not even one fits."""
    fixed = K * (2 * D + 1) * 4
    if fixed >= _SMEM_LIMIT:
        return 0
    return min(_SCORE_CH, (_SMEM_LIMIT - fixed) // (((D + 3) & ~3) + K + 7) // 4)


def score_plan(K: int, D: int) -> Tuple[int, int, bool]:
    """A score block's (sorted positions, components staged at once,
    scores in shared memory) (mirrors score_plan): the whole pdf with its
    scores in shared memory where ``score_chunk`` takes a position;
    otherwise up to 64 positions' rows in at most half the block (at
    least one), their scores in the float workspace (the posteriors'
    place) and the model rows in chunks of what fits beside them (K >
    358 at D = 80)."""
    whole = score_chunk(K, D)
    if whole >= 1:
        return whole, K, True
    row, pos = (2 * D + 1) * 4, (((D + 3) & ~3) + 7) * 4
    ch = max(1, min(_SCORE_CH, _SMEM_LIMIT // 2 // pos))
    if ch * pos + row > _SMEM_LIMIT:
        return 0, 0, False
    return ch, min(K, (_SMEM_LIMIT - ch * pos) // row), False


def _row_floats(D: int) -> int:
    """A sorted row [x, first-frame flag] padded to 4 floats."""
    return (D + 1 + 3) & ~3


def _fold_nk(K: int, D: int) -> int:
    """Posteriors a fold block stages per frame: the groups of 4
    components its slice of (group, row entry) pairs spans, at most."""
    return min((K + 3) & ~3, 4 * ((_THREADS - 1) // (2 * D + 1) + 2))


def fold_chunk(K: int, D: int) -> int:
    """Frames a fold block stages at a time (three buffers)."""
    per_frame = _NSTAGE * (_row_floats(D) + _fold_nk(K, D)) * 4
    return min(_CHUNK, _SMEM_LIMIT // per_frame)


def fold_smem_bytes(K: int, D: int) -> int:
    """Dynamic shared memory of a fold block: three buffers of a chunk's
    sorted rows and posteriors (mirrors fold_smem_bytes)."""
    return _NSTAGE * fold_chunk(K, D) * (_row_floats(D) + _fold_nk(K, D)) * 4


def fold_workspace_ints(B: int, S: int, T: int, P: int) -> int:
    """Length of the int32 workspace (mirrors fold_ws): 3 arrays of B·T,
    3 of B·S, one of P, 5 of min(P, B·S) and an 8-int header."""
    U = min(P, B * S)
    return 3 * B * T + 3 * B * S + P + 5 * U + 8


def fold_workspace_floats(B: int, T: int, K: int, D: int) -> int:
    """Length of the float workspace (mirrors fold_fws): per sorted
    frame its row, K posteriors, lse·w and w."""
    return B * T * (_row_floats(D) + K + 2)


def fold_cuda(
    gconsts: torch.Tensor,        # (P, K) f32
    means_invvars: torch.Tensor,  # (P, K, D) f32
    inv_vars: torch.Tensor,       # (P, K, D) f32
    feats: torch.Tensor,          # (B, T, D) f32
    pdf_ids: torch.Tensor,        # (B, T) int32
    frame_weights: torch.Tensor,  # (B, T) f32
    state_pdf: torch.Tensor,      # (B, S) int32
    events: Optional[Sequence["torch.cuda.Event"]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/stats_fold.cu``: ((P, K, 1+2D) stats [occ, post*x,
    post*x²], Σ w·loglike (B, S), Σ w (B, S)); a state that takes no
    frame holds 0.  ``events`` (4 CUDA events), when given, are recorded
    before grouping (match, group, place), scoring, folding and after."""
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
            f"fold_cuda: rows of D={D} do not fit a score block or a fold block"
        )
    dev = feats.device
    lib = kernels.lib()
    stream = kernels.stream_handle(dev)
    iws = torch.empty(fold_workspace_ints(B, S, T, P), dtype=torch.int32, device=dev)
    fws = torch.empty(fold_workspace_floats(B, T, K, D), dtype=torch.float32, device=dev)
    out = torch.empty((P, K, 2 * D + 1), dtype=torch.float32, device=dev)
    ll, frames = torch.empty((2, B, S), dtype=torch.float32, device=dev)
    ev = list(events) if events is not None else [None] * 4

    def mark(i):
        if ev[i] is not None:
            ev[i].record()

    mark(0)
    err = lib.launch_stats_fold_group(
        pdf_ids.data_ptr(), frame_weights.data_ptr(), state_pdf.data_ptr(),
        iws.data_ptr(), ll.data_ptr(), frames.data_ptr(), B, S, T, P, stream,
    )
    kernels.check("stats_fold", err, count=False)
    mark(1)
    err = lib.launch_stats_fold_score(
        gconsts.data_ptr(), means_invvars.data_ptr(), inv_vars.data_ptr(),
        feats.data_ptr(), pdf_ids.data_ptr(), frame_weights.data_ptr(),
        iws.data_ptr(), fws.data_ptr(), B, S, T, P, K, D, stream,
    )
    kernels.check("stats_fold", err, count=False)
    mark(2)
    err = lib.launch_stats_fold_fold(
        iws.data_ptr(), fws.data_ptr(), out.data_ptr(), ll.data_ptr(),
        frames.data_ptr(), B, S, T, P, K, D, stream,
    )
    kernels.check("stats_fold", err)
    mark(3)
    return out, ll, frames


def accumulate_am_stats_fold(
    gconsts: torch.Tensor,
    means_invvars: torch.Tensor,
    inv_vars: torch.Tensor,
    feats: torch.Tensor,
    pdf_ids: torch.Tensor,
    frame_weights: torch.Tensor,
    state_pdf: torch.Tensor,
) -> DenseStats:
    """accumulate_am_stats_local's stats: the kernels for CUDA tensors;
    the plain version for CPU tensors."""
    if feats.device.type != "cuda":
        return accumulate_am_stats_local(
            gconsts, means_invvars, inv_vars, feats, pdf_ids, frame_weights,
            state_pdf,
        )
    D = means_invvars.shape[2]
    out, ll, frames = fold_cuda(
        gconsts.contiguous(), means_invvars.contiguous(),
        inv_vars.contiguous(), feats.contiguous(),
        pdf_ids.to(torch.int32).contiguous(),
        frame_weights.to(torch.float32).contiguous(),
        state_pdf.to(torch.int32).contiguous(),
    )
    return DenseStats(out[..., 0], out[..., 1:1 + D], out[..., 1 + D:],
                      torch.sum(ll), torch.sum(frames))
