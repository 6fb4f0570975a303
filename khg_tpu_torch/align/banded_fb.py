"""Banded (offset-plane) forward-backward: the CUDA kernels
``csrc/banded_fb.cu`` and their plain PyTorch versions.

Port of khg_tpu/align/pallas_banded_fb.py::forward_backward_banded
(its ``_fb_fwd_kernel`` and ``_fb_bwd_kernel``).  The log-semiring
companion of banded Viterbi (align/banded_kernel.py): after SCC
renumbering every arc into state s comes from s - off_d, and with the
destination-uniform acoustic term sac[t, s] = scale * ll[t, pdf(s)]

    alpha'[s] = lse_d( alpha[s - off_d] - cost_d[s] ) + sac[t, s]
    beta[s]   = lse_d( (beta' + sac[t])[s + off_d] - cost_d[s + off_d] )
    post_d[s] = exp(min( (alpha[s - off_d] - cost_d[s])
                         + ((sac[t, s] + beta'[s]) - logZ), 0 ))

(indices mod S).  ``lse_d`` keeps khg_tpu's floor: when every candidate
is at or below NEG_BIG/2 the result is NEG_BIG, and it never drops below
NEG_BIG; alpha after adding sac is clamped again, and log Z has the
same guard.  Plane cells with no arc carry cost BIG, so they add
exactly 0.

The forward pass returns every alpha (the one before each frame) and
log Z; the backward pass returns the state posteriors spost[t, s] =
sum_d post_d[s] and the plane posteriors summed over frames.  Outside
the kernels, gamma is spost summed per state pdf and the expected
transition counts are the plane posteriors summed per plane tid
(align/forward_backward.py's helpers).  The plain versions perform the
kernels' f32 operations in the kernels' order (planes and states summed
one after another), so on the card the two agree to the last bits of
expf/logf.

Inputs come from align.banded.band_renumber + pack_banded called with
``reject_parallel=True``: the sum semiring needs every parallel arc's
mass, and a plane cell holds only one.  ``band_renumber`` leaves the
outgoing tables in the original numbering, so compare gamma, log Z and
tid counts with the dense path, never per-state arrays.

``forward_backward_banded`` takes the kernels for CUDA tensors and the
plain versions only for CPU tensors.  Whether a batch takes the kernels
at all is decided before, from shapes alone (``fb_kernel_fits``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from khg_tpu_torch.align.banded_kernel import (
    _SMEM_LIMIT,
    BandedTables,
    _offsets_on,
    check_banded_inputs,
    check_tensors,
)
from khg_tpu_torch.align.forward_backward import (
    NEG_BIG,
    FBResult,
    gamma_from_state_posteriors,
    tid_counts_from_posteriors,
)

# one thread per state
_MAX_STATES = 1024
# csrc/banded_fb.cu's compiled paths: plane counts of the forward and the
# backward kernel, at most this many states; frames in the backward
# kernel's alpha ring
_FWD_FAST_DK = (16, 20, 32)
_BWD_FAST_DK = (16, 20)
_FAST_MAX_S = 512
_BWD_RING = 4


def _generic_smem_bytes(DK: int, S: int) -> int:
    """The generic backward block's tables: the negated plane costs,
    double-buffered alpha_t and beta' + acoustic, the offsets (the
    forward block needs less)."""
    return (DK * S + 4 * S) * 4 + DK * 4


def fb_kernel_smem_bytes(DK: int, S: int) -> int:
    """Shared memory that csrc/banded_fb.cu's backward launcher
    requests for one block.  Compiled path: the alpha ring (rows stored
    twice) and beta' + acoustic (stored twice).  Generic path: its
    tables, plus the plane-posterior sums where they fit."""
    if DK in _BWD_FAST_DK and S <= _FAST_MAX_S:
        return 4 * S * (2 * _BWD_RING + 4)
    base = _generic_smem_bytes(DK, S)
    with_sums = base + DK * S * 4
    return with_sums if with_sums <= _SMEM_LIMIT else base


def fb_fwd_smem_bytes(DK: int, S: int) -> int:
    """Shared memory that csrc/banded_fb.cu's forward launcher requests
    for one block.  Compiled path: alpha double-buffered, each row
    stored twice, and 32 warp maxima for log Z.  Generic path: the
    negated plane costs, alpha double-buffered and the offsets."""
    if DK in _FWD_FAST_DK and S <= _FAST_MAX_S:
        return 16 * S + 128
    return (DK * S + 2 * S) * 4 + DK * 4


def fb_kernel_fits(DK: int, S: int) -> bool:
    """Whether the kernels take DK planes over S states: one thread per
    state, and a block's tables must fit its shared memory.  (No plane
    limit: FB keeps no int8 backpointers.)"""
    return S <= _MAX_STATES and _generic_smem_bytes(DK, S) <= _SMEM_LIMIT


# ------------------------------------------------------------- plain version

def _seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` one term after another, as the kernels add."""
    parts = torch.unbind(x, dim)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _plane_lse(cand: torch.Tensor, dim: int) -> torch.Tensor:
    """Floored log-sum-exp along ``dim`` (khg_tpu's _plane_lse)."""
    m = torch.max(cand, dim=dim).values
    ok = m > NEG_BIG / 2
    m_safe = torch.where(ok, m, 0.0)
    s = _seq_sum(torch.exp(cand - m_safe.unsqueeze(dim)), dim)
    out = torch.where(ok, torch.log(s) + m_safe, NEG_BIG)
    return torch.clamp(out, min=NEG_BIG)


def _sac(tables: BandedTables, loglikes: torch.Tensor, acoustic_scale: float):
    B, T = loglikes.shape[:2]
    S = tables.state_pdf.shape[1]
    return acoustic_scale * torch.gather(
        loglikes, 2, tables.state_pdf.long()[:, None, :].expand(B, T, S)
    )  # (B, T, S)


def banded_fb_fwd_plain(
    tables: BandedTables,
    offsets: Sequence[int],
    loglikes: torch.Tensor,    # (B, T, P)
    num_frames: torch.Tensor,  # (B,)
    acoustic_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward pass: (alphas (B, T, S), the alpha before each
    frame; log_z (B,))."""
    ncost = -tables.plane_cost
    B, DK, S = ncost.shape
    T = loglikes.shape[1]
    dev = ncost.device
    nf = num_frames.to(device=dev, dtype=torch.int64)
    sac = _sac(tables, loglikes, acoustic_scale)
    alpha = torch.clamp(-tables.init_cost, min=NEG_BIG)
    alphas = torch.zeros((B, T, S), dtype=torch.float32, device=dev)
    n_steps = min(int(nf.max()), T) if B else 0
    for t in range(n_steps):
        alphas[:, t] = alpha
        rolled = torch.stack([torch.roll(alpha, int(d), dims=1) for d in offsets], 1)
        new_alpha = torch.clamp(_plane_lse(rolled + ncost, 1) + sac[:, t], min=NEG_BIG)
        alpha = torch.where((t < nf)[:, None], new_alpha, alpha)
    tot = alpha + torch.clamp(-tables.final_cost, min=NEG_BIG)
    return alphas, _plane_lse(tot, 1)


def banded_fb_bwd_plain(
    tables: BandedTables,
    offsets: Sequence[int],
    loglikes: torch.Tensor,
    num_frames: torch.Tensor,
    acoustic_scale: float,
    alphas: torch.Tensor,      # (B, T, S) from the forward pass
    log_z: torch.Tensor,       # (B,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward pass: (spost (B, T, S) state posteriors, apost
    (B, DK, S) plane posteriors summed over frames)."""
    ncost = -tables.plane_cost
    B, DK, S = ncost.shape
    T = loglikes.shape[1]
    dev = ncost.device
    nf = num_frames.to(device=dev, dtype=torch.int64)
    sac = _sac(tables, loglikes, acoustic_scale)
    beta = torch.clamp(-tables.final_cost, min=NEG_BIG)
    spost = torch.zeros((B, T, S), dtype=torch.float32, device=dev)
    apost = torch.zeros((B, DK, S), dtype=torch.float32, device=dev)
    lz = log_z[:, None]
    n_steps = min(int(nf.max()), T) if B else 0
    for t in range(n_steps - 1, -1, -1):
        active = (t < nf)[:, None]
        bplus = beta + sac[:, t]
        rolled = torch.stack(
            [torch.roll(alphas[:, t], int(d), dims=1) for d in offsets], 1
        )
        logp = (rolled + ncost) + (bplus - lz)[:, None, :]
        post = torch.where(
            active[:, :, None], torch.exp(torch.clamp(logp, max=0.0)), 0.0
        )
        spost[:, t] = _seq_sum(post, 1)
        apost = apost + post
        # the arc leaving s with offset d enters s + d: its cost is the
        # in-plane's at s + d
        out_cand = torch.stack(
            [torch.roll(bplus + ncost[:, i], -int(d), dims=1)
             for i, d in enumerate(offsets)], 1,
        )
        beta = torch.where(active, _plane_lse(out_cand, 1), beta)
    return spost, apost


def banded_fb_plain(tables, offsets, loglikes, num_frames, acoustic_scale):
    """Plain forward + backward: (log_z, spost, apost)."""
    alphas, log_z = banded_fb_fwd_plain(
        tables, offsets, loglikes, num_frames, acoustic_scale
    )
    spost, apost = banded_fb_bwd_plain(
        tables, offsets, loglikes, num_frames, acoustic_scale, alphas, log_z
    )
    return log_z, spost, apost


# -------------------------------------------------------------- CUDA kernels

def _check_inputs(name, tables, offsets, loglikes, num_frames):
    B, DK, S, T, P, dev = check_banded_inputs(
        name, tables, offsets, loglikes, num_frames
    )
    if not fb_kernel_fits(DK, S):
        raise ValueError(
            f"{name}: DK={DK} planes over S={S} states need S <= "
            f"{_MAX_STATES} and {_generic_smem_bytes(DK, S)} B <= "
            f"{_SMEM_LIMIT} B of shared memory"
        )
    return B, DK, S, T, P, dev


def banded_fb_fwd_cuda(tables, offsets, loglikes, num_frames, acoustic_scale):
    """Launch the forward kernel: (alphas (B, T, S), log_z (B,)).
    Alphas at or past an utterance's length are left unwritten."""
    from khg_tpu_torch import kernels

    B, DK, S, T, P, dev = _check_inputs(
        "banded_fb_fwd_cuda", tables, offsets, loglikes, num_frames
    )
    offs = _offsets_on(tuple(int(d) for d in offsets), str(dev))
    alphas = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    log_z = torch.empty((B,), dtype=torch.float32, device=dev)
    err = kernels.lib().launch_banded_fb_fwd(
        tables.plane_cost.data_ptr(), tables.state_pdf.data_ptr(),
        tables.init_cost.data_ptr(), tables.final_cost.data_ptr(),
        loglikes.data_ptr(), num_frames.data_ptr(), offs.data_ptr(),
        alphas.data_ptr(), log_z.data_ptr(), B, DK, S, T, P,
        float(acoustic_scale), kernels.stream_handle(dev),
    )
    kernels.check("banded_fb_fwd", err)
    return alphas, log_z


def banded_fb_bwd_cuda(tables, offsets, loglikes, num_frames, acoustic_scale,
                       alphas, log_z):
    """Launch the backward kernel: (spost (B, T, S), apost (B, DK, S))."""
    from khg_tpu_torch import kernels

    B, DK, S, T, P, dev = _check_inputs(
        "banded_fb_bwd_cuda", tables, offsets, loglikes, num_frames
    )
    check_tensors("banded_fb_bwd_cuda", dev, [
        (alphas, torch.float32, (B, T, S)), (log_z, torch.float32, (B,)),
    ])
    offs = _offsets_on(tuple(int(d) for d in offsets), str(dev))
    spost = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    apost = torch.empty((B, DK, S), dtype=torch.float32, device=dev)
    err = kernels.lib().launch_banded_fb_bwd(
        tables.plane_cost.data_ptr(), tables.state_pdf.data_ptr(),
        tables.final_cost.data_ptr(), loglikes.data_ptr(),
        num_frames.data_ptr(), offs.data_ptr(), alphas.data_ptr(),
        log_z.data_ptr(), spost.data_ptr(), apost.data_ptr(),
        B, DK, S, T, P, float(acoustic_scale), kernels.stream_handle(dev),
    )
    kernels.check("banded_fb_bwd", err)
    return spost, apost


def banded_fb_cuda(tables, offsets, loglikes, num_frames, acoustic_scale):
    """Both kernels: (log_z, spost, apost)."""
    alphas, log_z = banded_fb_fwd_cuda(
        tables, offsets, loglikes, num_frames, acoustic_scale
    )
    spost, apost = banded_fb_bwd_cuda(
        tables, offsets, loglikes, num_frames, acoustic_scale, alphas, log_z
    )
    return log_z, spost, apost


def forward_backward_banded(
    tables: BandedTables,
    offsets: Sequence[int],
    loglikes: torch.Tensor,    # (B, T, P) f32
    num_frames: torch.Tensor,  # (B,) int
    num_tids: int,
    acoustic_scale: float = 1.0,
) -> FBResult:
    """Banded Baum-Welch: the kernels on CUDA, the plain versions on the
    CPU.  Build ``tables`` with align.banded.band_renumber + pack_banded
    (``reject_parallel=True``), then utils.convert.banded_to_torch."""
    if loglikes.device.type == "cuda":
        log_z, spost, apost = banded_fb_cuda(
            tables, offsets, loglikes.contiguous(),
            num_frames.to(torch.int32).contiguous(), acoustic_scale,
        )
    else:
        log_z, spost, apost = banded_fb_plain(
            tables, offsets, loglikes, num_frames, acoustic_scale
        )
    return FBResult(
        log_z=log_z,
        gamma=gamma_from_state_posteriors(spost, tables.state_pdf, loglikes.shape[2]),
        tid_counts=tid_counts_from_posteriors(apost, tables.plane_tid, num_tids),
        failed=log_z < NEG_BIG / 2,
    )
