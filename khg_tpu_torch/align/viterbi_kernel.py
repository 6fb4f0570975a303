"""Exact Viterbi over incoming-arc tables: the CUDA kernel
``csrc/viterbi.cu`` and its plain PyTorch version (the eager DP).

Port of khg_tpu/align/pallas_viterbi.py::viterbi_align_batch_pallas,
the single-kernel form of align/viterbi.py::viterbi_align_batch.  Per
frame t the DP updates all (state, incoming-arc) pairs at once:

    score[b, s, m] = (alpha[b, in_src[b,s,m]] + in_cost[b,s,m])
                     - acoustic_scale * ll[b, t, in_pdf[b,s,m]]
    alpha'[b, s]   = min(min_m score[b, s, m], BIG);  bp = first argmin_m

followed by a first-match argmin over the end states and a backtrace.
The card takes every (S, M): a compiled kernel (a state's M <= 8 arc
slots in registers, S <= 512) and a generic one (tables in global
memory, wider backpointers) for the rest, picked by shape
(``viterbi_plan``).  The plain version and both kernels perform the
same f32 operations in the same order, so their costs are bit-equal and
their tids equal.  Both lookups are direct gathers: khg_tpu's one-hot
selects exist only because dynamic gathers inside a TPU scan serialise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from khg_tpu_torch.align.banded_kernel import _SMEM_LIMIT, check_tensors
from khg_tpu_torch.align.packed import BIG


# csrc/viterbi.cu's compiled kernel: arc slots and states it takes, and
# its backpointer chunk (frames)
_FAST_MAX_M = 8
_FAST_MAX_S = 512
_CHUNK = 32


def _padded_states(S: int) -> int:
    return -(-S // 16) * 16


def viterbi_smem_bytes(S: int, M: int) -> int:
    """Shared memory of one block of csrc/viterbi.cu's compiled kernel:
    two alpha buffers of 512 floats, the staged backpointers (2 chunks
    of rows of S rounded up to 16 bytes), the source table, the chase's
    path and the argmin scratch."""
    return (2 * _FAST_MAX_S * 4 + 2 * _CHUNK * _padded_states(S) + S * M * 4
            + 4 * _CHUNK * 4 + 64 * 4)


def viterbi_plan(S: int, M: int) -> Tuple[str, torch.dtype, str]:
    """Which kernel of csrc/viterbi.cu takes S states of M incoming arcs
    (mirrors launch_viterbi): (kernel, backpointer dtype, where alpha
    lives).  The compiled kernel where M <= 8 and S <= 512 (int8
    backpointers); the generic kernel otherwise, with int8, int16 or
    int32 backpointers for M < 128, M < 32,768 or beyond, and alpha in
    shared memory while its two rows fit (8 S bytes beside the argmin
    scratch), in a (B, 2, S) global scratch beyond."""
    if M <= _FAST_MAX_M and S <= _FAST_MAX_S:
        return "compiled", torch.int8, "shared"
    bp = torch.int8 if M < 128 else torch.int16 if M < 32768 else torch.int32
    return "generic", bp, "shared" if 8 * S <= _SMEM_LIMIT - 256 else "global"


def viterbi_plain(
    graphs,                      # BatchedGraphs of tensors (leading axis B)
    loglikes: torch.Tensor,      # (B, T, P)
    num_frames: torch.Tensor,    # (B,) int
    acoustic_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch DP: returns (tids (B, T) int32, total_cost (B,))."""
    in_src = graphs.in_src.long()
    in_cost = graphs.in_cost
    B, S, M = in_src.shape
    T = loglikes.shape[1]
    dev = loglikes.device
    nf = num_frames.to(device=dev, dtype=torch.int64)
    src_flat = in_src.reshape(B, S * M)
    pdf_flat = graphs.in_pdf.long().reshape(B, 1, S * M).expand(B, T, S * M)
    ac_seq = torch.gather(loglikes, 2, pdf_flat).reshape(B, T, S, M)

    alpha = graphs.init_cost.clone()
    bp = torch.zeros((T, B, S), dtype=torch.int64, device=dev)
    for t in range(T):
        ga = torch.gather(alpha, 1, src_flat).reshape(B, S, M)
        score = ga + in_cost - acoustic_scale * ac_seq[:, t]
        best, bp_t = torch.min(score, dim=2)  # first minimal index
        new_alpha = torch.clamp(best, max=float(BIG))
        active = (t < nf)[:, None]
        alpha = torch.where(active, new_alpha, alpha)
        bp[t] = bp_t

    totals = alpha + graphs.final_cost
    total_cost, end_state = torch.min(totals, dim=1)

    in_tid = graphs.in_tid.long()
    rows = torch.arange(B, device=dev)
    v = end_state
    tids = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for t in range(T - 1, -1, -1):
        m = bp[t, rows, v]
        active = t < nf
        tids[:, t] = torch.where(active, in_tid[rows, v, m], 0).to(torch.int32)
        v = torch.where(active, in_src[rows, v, m], v)
    return tids, total_cost


def viterbi_cuda(
    graphs,
    loglikes: torch.Tensor,      # (B, T, P) f32
    num_frames: torch.Tensor,    # (B,) int32
    acoustic_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/viterbi.cu``: (tids (B, T) int32, total_cost (B,)).
    Any S and M: ``viterbi_plan`` says which of its two kernels runs."""
    from khg_tpu_torch import kernels

    B, S, M = graphs.in_src.shape
    if loglikes.dim() != 3 or loglikes.shape[0] != B:
        raise ValueError("loglikes must be (B, T, P)")
    T, P = loglikes.shape[1], loglikes.shape[2]
    dev = loglikes.device
    check_tensors("viterbi_cuda", dev, [
        (graphs.in_src, torch.int32, (B, S, M)),
        (graphs.in_pdf, torch.int32, (B, S, M)),
        (graphs.in_cost, torch.float32, (B, S, M)),
        (graphs.in_tid, torch.int32, (B, S, M)),
        (graphs.init_cost, torch.float32, (B, S)),
        (graphs.final_cost, torch.float32, (B, S)),
        (loglikes, torch.float32, (B, T, P)),
        (num_frames, torch.int32, (B,)),
    ])
    if M < 1:
        raise ValueError("viterbi_cuda: states need at least one arc slot")
    kernel, bp_dtype, alpha_at = viterbi_plan(S, M)
    width = _padded_states(S) if kernel == "compiled" else S
    bp = torch.empty((B, T, width), dtype=bp_dtype, device=dev)
    alpha_ws = (torch.empty((B, 2, S), dtype=torch.float32, device=dev)
                if alpha_at == "global" else None)
    tids = torch.empty((B, T), dtype=torch.int32, device=dev)
    cost = torch.empty((B,), dtype=torch.float32, device=dev)
    err = kernels.lib().launch_viterbi(
        graphs.in_src.data_ptr(), graphs.in_pdf.data_ptr(),
        graphs.in_cost.data_ptr(), graphs.in_tid.data_ptr(),
        graphs.init_cost.data_ptr(), graphs.final_cost.data_ptr(),
        loglikes.data_ptr(), num_frames.data_ptr(), bp.data_ptr(),
        alpha_ws.data_ptr() if alpha_ws is not None else None,
        tids.data_ptr(), cost.data_ptr(), B, S, M, T, P,
        float(acoustic_scale), kernels.stream_handle(dev),
    )
    kernels.check("viterbi", err)
    return tids, cost
