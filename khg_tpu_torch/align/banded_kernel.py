"""Banded (offset-plane) Viterbi alignment: the CUDA kernel
``csrc/banded_viterbi.cu`` and its plain PyTorch version.

Port of khg_tpu/align/pallas_banded.py::viterbi_align_banded.  After
SCC-topological renumbering (align/banded.py) every arc's source is
``dest - d`` for a small static offset d, so a frame of the DP is

    cand[p] = roll(alpha, d_p) + plane_cost[p]
    alpha'  = min(min_p cand[p] - scale * ll[t, pdf(s)], BIG)

with first-match int8 backpointers (the smallest plane index attaining
the min) and a backtrace that emits transition ids.  Subtracting the
per-state acoustic term after the min is bit-equivalent to the per-arc
form.  The plain version and the kernel perform the same f32 operations
in the same order, so their costs are bit-equal and their tids equal.

``acoustic_cost`` and ``failed`` are plain PyTorch around the kernel, as
they are plain XLA around the Pallas kernel in khg_tpu.

External-acoustic ("sac") mode, for wide models: the caller scores
each graph state itself (gmm.likelihoods.loglikes_per_state) and hands
the (B, T, S) lattice over, which the DP reads in place of
ll[b, t, state_pdf[b, s]].  The lattice goes to the same kernel and the
same plain version as the loglikes, with an identity ``state_pdf``
(``sac_tables``): the kernel needs no second mode.

``viterbi_align_banded`` takes the kernel for CUDA tensors and the
plain version only for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from khg_tpu_torch.align.packed import BIG
from khg_tpu_torch.align.viterbi import (
    FAIL_THRESHOLD,
    ViterbiResult,
    path_acoustic_cost,
)

# shared memory a block may use on Hopper (bytes)
_SMEM_LIMIT = 232448
# csrc/banded_viterbi.cu: plane counts compiled, at most FAST_MAX_S
# states (one per thread), frames per backpointer chunk
_FAST_DK = (16, 20, 32)
_FAST_MAX_S = 512
_CHUNK = 32


def _padded_states(S: int) -> int:
    """Backpointer row of the kernel's scratch: S bytes rounded up to 16."""
    return -(-S // 16) * 16


def _generic_smem_bytes(DK: int, S: int) -> int:
    nt = min(1024, -(-S // 32) * 32)
    return DK * S * 4 + 2 * S * 4 + DK * 4 + nt * 8


def kernel_smem_bytes(DK: int, S: int) -> int:
    """Shared memory that csrc/banded_viterbi.cu requests for one block.
    Compiled path: two alpha buffers of _FAST_MAX_S floats, the staged
    backpointers (2 chunks of padded rows), the offsets, the
    backtrace's path and the argmin scratch.  Generic path: the plane
    costs, two alpha buffers, the offsets and the argmin scratch."""
    if DK in _FAST_DK and S <= _FAST_MAX_S:
        return (2 * _FAST_MAX_S * 4 + 2 * _CHUNK * _padded_states(S)
                + DK * 4 + 4 * _CHUNK * 4 + 64 * 4)
    return _generic_smem_bytes(DK, S)


def kernel_fits(DK: int, S: int) -> bool:
    """Whether the kernel takes DK planes over S states: int8
    backpointers need DK < 128, and a block's tables must fit."""
    return DK < 128 and kernel_smem_bytes(DK, S) <= _SMEM_LIMIT


class BandedTables(NamedTuple):
    """Device tensors of align.banded.BandedGraphs (leading axis B)."""

    plane_cost: torch.Tensor  # (B, DK, S) f32
    plane_tid: torch.Tensor   # (B, DK, S) int32
    state_pdf: torch.Tensor   # (B, S) int32
    init_cost: torch.Tensor   # (B, S) f32
    final_cost: torch.Tensor  # (B, S) f32


def banded_plain(
    tables: BandedTables,
    offsets: Sequence[int],
    loglikes: torch.Tensor,    # (B, T, P)
    num_frames: torch.Tensor,  # (B,)
    acoustic_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch banded DP: returns (tids (B, T) int32, total_cost)."""
    pc = tables.plane_cost
    B, DK, S = pc.shape
    T = loglikes.shape[1]
    dev = pc.device
    nf = num_frames.to(device=dev, dtype=torch.int64)
    ac = torch.gather(
        loglikes, 2, tables.state_pdf.long()[:, None, :].expand(B, T, S)
    )  # (B, T, S) exact select
    dk_iota = torch.arange(DK, device=dev)[None, :, None]
    alpha = tables.init_cost.clone()
    n_steps = int(nf.max()) if B else 0
    bp = torch.zeros((max(n_steps, 1), B, S), dtype=torch.int64, device=dev)
    for t in range(n_steps):
        rolled = torch.stack([torch.roll(alpha, int(d), dims=1) for d in offsets], 1)
        cand = rolled + pc                                   # (B, DK, S)
        best = torch.min(cand, dim=1).values                 # (B, S)
        bp[t] = torch.min(
            torch.where(cand == best[:, None], dk_iota, DK), dim=1
        ).values                                             # first match
        new_alpha = torch.clamp(best - acoustic_scale * ac[:, t], max=float(BIG))
        alpha = torch.where((t < nf)[:, None], new_alpha, alpha)

    totals = alpha + tables.final_cost
    total_cost = torch.min(totals, dim=1).values
    s_iota = torch.arange(S, device=dev)[None, :]
    v = torch.min(
        torch.where(totals == total_cost[:, None], s_iota, S), dim=1
    ).values
    offs = torch.as_tensor(list(offsets), dtype=torch.int64, device=dev)
    tid_tab = tables.plane_tid.long()
    rows = torch.arange(B, device=dev)
    tids = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for t in range(n_steps - 1, -1, -1):
        p = bp[t, rows, v]
        active = t < nf
        tids[:, t] = torch.where(active, tid_tab[rows, p, v], 0).to(torch.int32)
        v = torch.where(active, torch.remainder(v - offs[p], S), v)
    return tids, total_cost


def check_banded_inputs(name, tables: BandedTables, offsets, loglikes,
                        num_frames):
    """Validate a banded kernel's inputs before their pointers reach the
    kernel: one CUDA device, dtypes, shapes, contiguity, one offset per
    plane.  Returns (B, DK, S, T, P, device)."""
    pc = tables.plane_cost
    B, DK, S = pc.shape
    if loglikes.dim() != 3 or loglikes.shape[0] != B:
        raise ValueError("loglikes must be (B, T, P)")
    T, P = loglikes.shape[1], loglikes.shape[2]
    dev = loglikes.device
    check_tensors(name, dev, [
        (pc, torch.float32, (B, DK, S)),
        (tables.plane_tid, torch.int32, (B, DK, S)),
        (tables.state_pdf, torch.int32, (B, S)),
        (tables.init_cost, torch.float32, (B, S)),
        (tables.final_cost, torch.float32, (B, S)),
        (loglikes, torch.float32, (B, T, P)),
        (num_frames, torch.int32, (B,)),
    ])
    if len(offsets) != DK:
        raise ValueError("one offset per plane")
    return B, DK, S, T, P, dev


def check_tensors(name, dev, checks):
    """Each (tensor, dtype, shape) of ``checks`` lies on the CUDA device
    ``dev``, contiguous, with that dtype and shape."""
    for t, dtype, shape in checks:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} needs every tensor on one CUDA device")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


@functools.lru_cache(maxsize=32)
def _offsets_on(offsets: Tuple[int, ...], device: str) -> torch.Tensor:
    return torch.as_tensor(offsets, dtype=torch.int32, device=device)


def banded_cuda(
    tables: BandedTables,
    offsets: Sequence[int],
    loglikes: torch.Tensor,
    num_frames: torch.Tensor,
    acoustic_scale: float,
    counter: str = "banded_viterbi",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/banded_viterbi.cu``: (tids (B, T) int32, total_cost).
    ``counter`` is the launch count it adds to (banded_sac_cuda counts
    its launches apart)."""
    from khg_tpu_torch import kernels

    B, DK, S, T, P, dev = check_banded_inputs(
        "banded_cuda", tables, offsets, loglikes, num_frames
    )
    if not kernel_fits(DK, S):
        raise ValueError(
            f"banded_cuda: DK={DK} planes over S={S} states need "
            f"DK < 128 and {kernel_smem_bytes(DK, S)} B <= {_SMEM_LIMIT} B "
            "of shared memory"
        )
    offs = _offsets_on(tuple(int(d) for d in offsets), str(dev))
    bp = torch.empty((B, T, _padded_states(S)), dtype=torch.int8, device=dev)
    tids = torch.empty((B, T), dtype=torch.int32, device=dev)
    cost = torch.empty((B,), dtype=torch.float32, device=dev)
    err = kernels.lib().launch_banded_viterbi(
        tables.plane_cost.data_ptr(), tables.plane_tid.data_ptr(),
        tables.state_pdf.data_ptr(), tables.init_cost.data_ptr(),
        tables.final_cost.data_ptr(), loglikes.data_ptr(),
        num_frames.data_ptr(), offs.data_ptr(), bp.data_ptr(),
        tids.data_ptr(), cost.data_ptr(), B, DK, S, T, P,
        float(acoustic_scale), kernels.stream_handle(dev),
    )
    kernels.check(counter, err)
    return tids, cost


def sac_tables(tables: BandedTables) -> BandedTables:
    """``tables`` with an identity state_pdf, so that a (B, T, S)
    per-state lattice passed as the loglikes is read as ac[b, t, s]."""
    B, S = tables.state_pdf.shape
    ident = torch.arange(S, dtype=torch.int32, device=tables.state_pdf.device)
    return tables._replace(state_pdf=ident.expand(B, S).contiguous())


def banded_sac_plain(tables, offsets, sac, num_frames, acoustic_scale):
    """Plain version of the external-acoustic mode: ``sac`` (B, T, S)."""
    return banded_plain(sac_tables(tables), offsets, sac, num_frames,
                        acoustic_scale)


def banded_sac_cuda(tables, offsets, sac, num_frames, acoustic_scale):
    """Kernel A in its external-acoustic mode: ``sac`` (B, T, S) f32,
    counted as ``banded_viterbi_sac``."""
    return banded_cuda(sac_tables(tables), offsets, sac, num_frames,
                       acoustic_scale, counter="banded_viterbi_sac")


def viterbi_align_banded(
    tables: BandedTables,
    offsets: Sequence[int],
    loglikes: Optional[torch.Tensor],  # (B, T, P) f32, or None with sac
    num_frames: torch.Tensor,  # (B,) int32
    id2pdf: torch.Tensor,      # (num_tids+1,) int32
    acoustic_scale: float = 1.0,
    sac: Optional[torch.Tensor] = None,  # (B, T, S) per-state loglikes
) -> ViterbiResult:
    """Exact banded Viterbi alignment: the kernel on CUDA, the plain
    version on the CPU.  Build ``tables`` with align.banded.band_renumber
    + pack_banded (then utils.convert.banded_to_torch).

    ``sac`` supplies the (B, T, S) per-state UNSCALED log-likelihood
    lattice (gmm.likelihoods.loglikes_per_state over tables.state_pdf);
    ``loglikes`` may then be None, and ``acoustic_cost`` is zeros."""
    dev = (sac if sac is not None else loglikes).device
    on_card = dev.type == "cuda"
    nf32 = num_frames.to(device=dev, dtype=torch.int32).contiguous()
    if sac is not None:
        run = banded_sac_cuda if on_card else banded_sac_plain
        tids, total_cost = run(tables, offsets, sac.contiguous(), nf32,
                               acoustic_scale)
    else:
        run = banded_cuda if on_card else banded_plain
        tids, total_cost = run(tables, offsets, loglikes.contiguous(), nf32,
                               acoustic_scale)
    nf = num_frames.to(device=dev, dtype=torch.int64)
    if loglikes is None:
        acoustic_cost = torch.zeros_like(total_cost)
    else:
        acoustic_cost = path_acoustic_cost(
            loglikes, tids, nf, id2pdf.to(dev), acoustic_scale
        )
    return ViterbiResult(
        tids=tids,
        total_cost=total_cost,
        acoustic_cost=acoustic_cost,
        failed=total_cost >= FAIL_THRESHOLD,
    )
