"""Data-parallel EM over torch.distributed (PyTorch port of
khg_tpu/parallel/mesh.py).

The workload's natural parallelism is over utterances: each
utterance's alignment is independent, and sufficient statistics are
additive.  khg_tpu shards a batch over a 1-D "dp" device mesh with
shard_map and sums with ``jax.lax.psum``; here, in PyTorch's idiom, one
process runs per card (SPMD, as ``torchrun`` launches it):

  - each rank holds its shard of the utterances and a replica of the
    (small) model;
  - per rank: scoring -> Viterbi or forward-backward (the CUDA kernels
    on the card, their plain versions on the CPU) -> stats fold, each
    batch through recipes/pipeline's per-batch functions (align_batch,
    fb_batch and their carry rows), the ones EStepPipeline runs;
  - ``torch.distributed.all_reduce(SUM)`` of the stats over the
    process group: NCCL for CUDA tensors and gloo for CPU tensors, as
    the caller initialised the group (parallel/multihost.initialize);
    nothing chooses or swaps the backend here;
  - the dense M-step on the reduced stats, identical on every rank, so
    the replicated model stays in sync without a broadcast.

Correctness anchor: the all-reduced shard stats equal the serial
accumulation (tests/test_torch_parallel.py holds every entry point at
world sizes 1 and 2 to khg_tpu's mesh at 1 and 2 devices).

A graph batch is either a dense table set (align/packed.BatchedGraphs
of tensors) or a banded one (align/banded_kernel.BandedTables, or
align/banded.BandedGraphs of tensors): a batch with ``plane_cost``
takes the banded kernels with the builder's ``banded_offsets``, or the
``offsets`` given to the call (EStepPipeline.device_batches packs each
batch with its own band menu).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from khg_tpu_torch.utils.platform import resolve_device

_LOG_2PI = 1.8378770664093453


@dataclass(frozen=True)
class DataMesh:
    """The data-parallel layout seen by one rank: its process group
    (None without torch.distributed: world size 1, no collective), its
    rank and the world size of that group, and its device."""

    group: Optional[object]
    rank: int
    world_size: int
    device: torch.device

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The SUM over the group's ranks of ``x``, in a new tensor."""
        out = x.clone()
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out


def _rank_device(rank: int, devices) -> torch.device:
    if devices is not None:
        return resolve_device(devices[rank])
    resolve_device(None)  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    return torch.device("cuda", local)


def make_data_mesh(n_devices: Optional[int] = None, devices=None) -> DataMesh:
    """This rank's DataMesh over the initialised process group (all its
    ranks, or the first ``n_devices`` of them), or world size 1 without
    one.  ``devices`` names each rank's device (indexed by rank;
    "cpu" for the plain path); by default a rank takes CUDA card
    ``LOCAL_RANK`` (as torchrun sets it) or rank modulo the cards.

    With ``n_devices`` smaller than the world, every rank must call
    this (torch.distributed.new_group is collective); ranks outside the
    first ``n_devices`` get a DataMesh with rank -1 and no group."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_data_mesh: {n_devices} devices asked for, but no "
                "process group is initialised (parallel/multihost.initialize)"
            )
        return DataMesh(None, 0, 1, _rank_device(0, devices))
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"make_data_mesh: {n} devices of a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return DataMesh(None, -1, n, _rank_device(rank, devices))
    return DataMesh(group, rank, n, _rank_device(rank, devices))


class EmStepResult(NamedTuple):
    tids: torch.Tensor          # (B, T) this rank's shard
    total_cost: torch.Tensor    # (B,) this rank's shard
    occ: torch.Tensor           # (P, K) all-reduced
    mean_acc: torch.Tensor      # (P, K, D)
    var_acc: torch.Tensor       # (P, K, D)
    tid_counts: torch.Tensor    # (num_tids+1,) all-reduced
    tot_log_like: torch.Tensor  # ()
    tot_frames: torch.Tensor    # ()
    new_gconsts: torch.Tensor       # (P, K)
    new_means_invvars: torch.Tensor  # (P, K, D)
    new_inv_vars: torch.Tensor      # (P, K, D)
    new_weights: torch.Tensor       # (P, K)


def _dense_mstep(
    occ: torch.Tensor,        # (P, K)
    mean_acc: torch.Tensor,   # (P, K, D)
    var_acc: torch.Tensor,    # (P, K, D)
    old_gconsts: torch.Tensor,
    old_means_invvars: torch.Tensor,
    old_inv_vars: torch.Tensor,
    old_weights: torch.Tensor,
    min_variance: float = 0.001,
    min_gaussian_occupancy: float = 10.0,
    min_gaussian_weight: float = 1.0e-05,
    remove_low_count_gaussians: bool = True,
    variance_floor_vector=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form MLE update on padded dense stats.

    Full MleDiagGmmOptions semantics, matching est.mle.mle_diag_gmm_update
    (reference: mle-diag-gmm.cc:243-390) with flags=mvw on padded tensors:

    - a component updates iff occ > min_gaussian_occupancy AND its weight
      prob > min_gaussian_weight (prob = occ/occ_sum, or 1/num_real when
      the pdf saw no data);
    - variances floored by ``variance_floor_vector`` (a (D,) array) when
      given, else by the scalar ``min_variance``;
    - with ``remove_low_count_gaussians`` starved components are
      DEACTIVATED (weight 0, inv_vars/means_invvars zeroed, gconst -inf —
      the dense analogue of removal, which would change shapes) and the
      surviving weights renormalized per pdf, except the last real
      component of an all-starved pdf survives with weight
      max(prob, min_gaussian_weight) exactly as the reference's
      "don't remove the last one" branch;
    - without it, starved components keep their parameters and get
      weight max(prob, min_gaussian_weight), no renormalization.

    Padding components (gconst -inf / zero inv_vars rows) never update.
    The floors written 1e-300 round to 0 in f32, as they do in khg_tpu.
    """
    P_, K, D = mean_acc.shape
    dev, f32 = occ.device, torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    real = torch.isfinite(old_gconsts)                     # (P, K)
    num_real = torch.sum(real, dim=1, keepdim=True)        # (P, 1)
    occ = torch.where(real, occ, zero)
    occ_sum = torch.sum(occ, dim=1, keepdim=True)          # (P, 1)
    prob = torch.where(
        occ_sum > 0,
        occ / torch.clamp(occ_sum, min=1e-300),
        1.0 / torch.clamp(num_real, min=1).to(f32),
    )
    active = real & (occ > min_gaussian_occupancy) & (prob > min_gaussian_weight)
    safe_occ = torch.where(active, occ, one)

    means = mean_acc / safe_occ[..., None]
    variances = var_acc / safe_occ[..., None] - means * means
    if variance_floor_vector is not None:
        floor = torch.as_tensor(
            variance_floor_vector, dtype=f32, device=dev
        ).reshape(1, 1, D)
        variances = torch.maximum(variances, floor)
    else:
        variances = torch.clamp(variances, min=min_variance)

    inv_vars = 1.0 / variances
    means_invvars = means * inv_vars

    new_inv_vars = torch.where(active[..., None], inv_vars, old_inv_vars)
    new_means_invvars = torch.where(
        active[..., None], means_invvars, old_means_invvars
    )

    starved = real & ~active
    if remove_low_count_gaussians:
        # keep one survivor when a pdf is fully starved: the reference
        # removes components in index order and stops short of the last,
        # so the highest-index REAL component survives
        rev_cum = torch.flip(
            torch.cumsum(torch.flip(real.to(torch.int32), [1]), dim=1), [1]
        )
        last_real = real & (rev_cum == 1)
        all_starved = ~torch.any(active, dim=1, keepdim=True)
        keep_anyway = starved & last_real & all_starved
        removed = starved & ~keep_anyway
        surv = active | keep_anyway
        w = torch.where(active, prob, zero)
        w = torch.where(
            keep_anyway, torch.clamp(prob, min=min_gaussian_weight), w
        )
        any_removed = torch.any(removed, dim=1, keepdim=True)
        denom = torch.sum(torch.where(surv, w, zero), dim=1, keepdim=True)
        w = torch.where(any_removed, w / torch.clamp(denom, min=1e-300), w)
        new_weights = torch.where(surv, w, zero)
        new_inv_vars = torch.where(removed[..., None], zero, new_inv_vars)
        new_means_invvars = torch.where(
            removed[..., None], zero, new_means_invvars
        )
    else:
        w = torch.where(
            active, prob, torch.clamp(prob, min=min_gaussian_weight)
        )
        new_weights = torch.where(real, w, zero)

    # gconsts; padding/deactivated components (zero inv_vars rows) stay -inf
    pos = new_inv_vars > 0
    safe_iv = torch.where(pos, new_inv_vars, one)
    valid = torch.any(pos, dim=-1) & (new_weights > 0)
    gconsts = (
        torch.log(torch.clamp(new_weights, min=1e-300))
        - 0.5 * _LOG_2PI * D
        + 0.5 * torch.sum(torch.log(safe_iv), dim=-1)
        - 0.5 * torch.sum(new_means_invvars * new_means_invvars / safe_iv, dim=-1)
    )
    new_gconsts = torch.where(
        valid, gconsts, torch.full((), -float("inf"), dtype=f32, device=dev)
    )
    return new_gconsts, new_means_invvars, new_inv_vars, new_weights


class FbEmStepResult(NamedTuple):
    log_z: torch.Tensor         # (B,) this rank's shard; 0 where failed
    failed: torch.Tensor        # (B,) bool, this rank's shard
    occ: torch.Tensor           # (P, K) all-reduced
    mean_acc: torch.Tensor      # (P, K, D)
    var_acc: torch.Tensor       # (P, K, D)
    tid_counts: torch.Tensor    # (num_tids+1,) all-reduced
    tot_log_like: torch.Tensor  # ()
    tot_frames: torch.Tensor    # ()
    new_gconsts: torch.Tensor
    new_means_invvars: torch.Tensor
    new_inv_vars: torch.Tensor
    new_weights: torch.Tensor


def _routed(graphs, offsets, banded_offsets):
    """(dense tables, banded) of one shard's graph batch, as the
    pipeline's per-batch functions take them: a batch with
    ``plane_cost`` is banded, with the call's ``offsets`` or the
    builder's ``banded_offsets``."""
    if hasattr(graphs, "plane_cost"):
        return None, (graphs, banded_offsets if offsets is None else offsets)
    return graphs, None


def _hard_estep(acoustic_scale: float, likelihood_backend: str, banded_offsets,
                per_state: bool):
    """Per-rank hard-EM alignment: (model, graphs, feats, num_frames,
    id2pdf, offsets, delta) -> (ViterbiResult, component scores or None,
    state_pdf to fold through or None), through the pipeline's
    ``align_batch`` with ``wide=per_state``.  khg_tpu's
    ``uniform_dest_pdf`` fast path has no counterpart: the port's
    Viterbi selects each arc's pdf, which gives the same result
    (align/viterbi.viterbi_align_batch)."""
    from khg_tpu_torch.recipes.pipeline import align_batch

    def align(model, graphs, feats, num_frames, id2pdf, offsets=None, delta=None):
        dense, banded = _routed(graphs, offsets, banded_offsets)
        if per_state and banded is None:
            raise ValueError("per_state needs banded tables (state_pdf lives there)")
        gconsts, miv, iv, _weights = model
        return align_batch(gconsts, miv, iv, feats, num_frames, dense, banded,
                           id2pdf, acoustic_scale, likelihood_backend,
                           wide=per_state, delta=delta)

    return align


def _soft_estep(acoustic_scale: float, likelihood_backend: str,
                uniform_dest_pdf: bool, banded_offsets, num_tids: int):
    """Per-rank soft-EM E-step: (model, graphs, feats, num_frames,
    offsets, delta) -> (FBResult, component scores or None), through the
    pipeline's ``fb_batch``; ``uniform_dest_pdf`` takes the dense FB's
    per-state acoustic route."""
    from khg_tpu_torch.recipes.pipeline import fb_batch

    def fb(model, graphs, feats, num_frames, offsets=None, delta=None):
        dense, banded = _routed(graphs, offsets, banded_offsets)
        state_pdf = (dense.in_pdf[:, :, 0]
                     if dense is not None and uniform_dest_pdf else None)
        gconsts, miv, iv, _weights = model
        return fb_batch(gconsts, miv, iv, feats, num_frames, dense, banded,
                        state_pdf, num_tids, acoustic_scale, likelihood_backend,
                        delta=delta)

    return fb


def _reduced_mstep(mesh, model, row, num_tids, mle_config):
    """All-reduce one batch's carry row (recipes/pipeline's layout) in
    one collective, then the replicated M-step: (occ, mean_acc,
    var_acc, tid counts, tot_log_like, tot_frames, *new model)."""
    from khg_tpu_torch.recipes.pipeline import _split_carry

    gconsts, miv, iv, weights = model
    P, K, D = miv.shape
    occ, mean_acc, var_acc, scalars, counts, _tail = _split_carry(
        mesh.all_reduce(row), P, K, D, num_tids)
    new = _dense_mstep(occ, mean_acc, var_acc, gconsts, miv, iv, weights,
                       **_mstep_kwargs(mle_config))
    return (occ, mean_acc, var_acc, counts, scalars[0], scalars[1]) + tuple(new)


def sharded_em_step(
    mesh: DataMesh,
    acoustic_scale: float = 1.0,
    uniform_dest_pdf: bool = False,
    banded_offsets: Optional[Tuple[int, ...]] = None,
    mle_config=None,
    per_state: bool = False,
    likelihood_backend: str = "xla",
) -> Callable[..., EmStepResult]:
    """The full hard-EM step over the mesh.

    Returns ``step(model (gconsts, miv, iv, weights), graphs, feats,
    num_frames, id2pdf, offsets=None) -> EmStepResult``, where graphs,
    feats and num_frames are this rank's shard of the batch (dense
    BatchedGraphs, or banded tables aligned with ``banded_offsets`` or
    ``offsets``) and the model and id2pdf are replicated tensors on the
    mesh's device.  Stats and tid counts are all-reduced; the M-step
    runs on the sums on every rank, so every rank returns the same new
    model.

    ``per_state=True`` (banded tables only) is the wide-model mode: one
    per-state component scoring per rank feeds the sac-mode banded
    Viterbi, and the stats fold (stats/fold_kernel.py) rescores each
    frame's aligned state: work scales with the graph-state count S,
    not the pdf count P.  ``uniform_dest_pdf`` is accepted for
    khg_tpu's signature and changes nothing (see _hard_estep).
    ``likelihood_backend`` is EStepPipeline's ("pallas": kernel B);
    per-state scoring is f32 whatever it says, as in the pipeline.

    Each rank's batch runs the pipeline's per-batch step
    (recipes/pipeline.align_batch and its carry row), so a shard is
    scored, aligned and folded as EStepPipeline folds a batch."""
    from khg_tpu_torch.recipes.pipeline import _hard_row

    del uniform_dest_pdf
    align = _hard_estep(acoustic_scale, likelihood_backend, banded_offsets,
                        per_state)

    def step(model, graphs, feats, num_frames, id2pdf, offsets=None):
        res, scores, fold_pdf = align(model, graphs, feats, num_frames, id2pdf,
                                      offsets)
        row = _hard_row(*model[:3], feats, res.tids, num_frames, res.failed,
                        id2pdf, res.total_cost, scores=scores, state_pdf=fold_pdf)
        return EmStepResult(res.tids, res.total_cost, *_reduced_mstep(
            mesh, model, row, id2pdf.shape[0] - 1, mle_config))

    return step


def sharded_fb_em_step(
    mesh: DataMesh,
    num_tids: int,
    acoustic_scale: float = 1.0,
    uniform_dest_pdf: bool = False,
    banded_offsets: Optional[Tuple[int, ...]] = None,
    mle_config=None,
    likelihood_backend: str = "xla",
) -> Callable[..., FbEmStepResult]:
    """The soft (Baum-Welch) EM step over the mesh: sharded_em_step's
    plumbing with the forward-backward E-step.  Per rank, pdf posteriors
    feed the soft stats and expected transition counts sum beside them.
    Banded tables (packed with ``reject_parallel=True``) take the banded
    forward-backward kernels; dense log-semiring tables the dense FB,
    with ``uniform_dest_pdf`` its per-state acoustic route.

    Returns ``step(model, graphs, feats, num_frames, offsets=None) ->
    FbEmStepResult``."""
    from khg_tpu_torch.recipes.pipeline import _soft_row

    fb_estep = _soft_estep(acoustic_scale, likelihood_backend, uniform_dest_pdf,
                           banded_offsets, num_tids)

    def step(model, graphs, feats, num_frames, offsets=None):
        fb, scores = fb_estep(model, graphs, feats, num_frames, offsets)
        row = _soft_row(*model[:3], feats, fb, scores=scores)
        return FbEmStepResult(
            torch.where(~fb.failed, fb.log_z, 0.0), fb.failed,
            *_reduced_mstep(mesh, model, row, num_tids, mle_config))

    return step


class ShardedResidentEm(NamedTuple):
    """Device-resident corpus EM over the mesh (see sharded_resident_em)."""

    make_carry: Callable   # () -> (carry, comp): this rank's zeros
    fold: Callable         # (model, carry, comp, graphs, feats, nf, id2pdf,
                           #  offsets=None) -> (carry, comp)
    finish: Callable       # (model, carry, comp) -> (new_model, packet)
    carry_width: int
    num_tids: int


def _reduce_carry(mesh, carry, comp):
    """One pass's reduction: the carry and its compensation all-reduce
    separately (one collective over both) and combine after, so the sum
    keeps the compensated precision of each rank's fold.  The carries
    are f64 (recipes/pipeline.resident_carry), so the total equals the
    single-process pass's, whatever the world size.  khg_tpu adds the
    reduced compensation; ``_kahan_add`` stores the excess of the
    running sum there, so the port subtracts it, as every pass of the
    pipeline does (recipes/pipeline._carry_total)."""
    from khg_tpu_torch.recipes.pipeline import _carry_total

    both = mesh.all_reduce(torch.stack([carry, comp]))
    return _carry_total(both[0], both[1])


def _zeros_carry(mesh, width):
    from khg_tpu_torch.recipes.pipeline import resident_carry

    return resident_carry(width, mesh.device)


def sharded_resident_em(
    mesh: DataMesh,
    num_pdfs: int,
    num_mix: int,
    dim: int,
    num_tids: int,
    acoustic_scale: float = 1.0,
    uniform_dest_pdf: bool = False,
    banded_offsets: Optional[Tuple[int, ...]] = None,
    mle_config=None,
    per_state: bool = False,
    likelihood_backend: str = "xla",
) -> ShardedResidentEm:
    """The mesh's EStepPipeline.em_pass_resident: per rank, a Kahan
    carry fold across that rank's batches (recipes/pipeline._carry_fold,
    the flat layout of the pipeline's carry); ``finish`` makes the
    pass's one reduction and one replicated dense M-step, and returns
    the new model with the small packet [tot_log_like, tot_frames,
    tid_counts, like_sum, num_done, num_error, frame_count]
    (unpack_resident_packet) — all the host needs to fetch.

    Usage per corpus pass, on every rank:
        carry, comp = r.make_carry()
        for batch in my_batches:
            carry, comp = r.fold(model, carry, comp, *batch)
        model, packet = r.finish(model, carry, comp)

    Equality contract (tests/test_torch_parallel.py): the model equals
    the dense M-step on the summed per-batch stats of sharded_em_step,
    at any world size."""
    from khg_tpu_torch.recipes.pipeline import _carry_fold, _carry_width

    del uniform_dest_pdf
    W = _carry_width(num_pdfs, num_mix, dim, num_tids)
    align = _hard_estep(acoustic_scale, likelihood_backend, banded_offsets,
                        per_state)
    off = num_pdfs * num_mix * (2 * dim + 1)

    def fold(model, carry, comp, graphs, feats, num_frames, id2pdf, offsets=None):
        res, scores, fold_pdf = align(model, graphs, feats, num_frames, id2pdf,
                                      offsets)
        return _carry_fold(*model[:3], feats, res.tids, num_frames, res.failed,
                           id2pdf, res.total_cost, carry, comp, scores=scores,
                           state_pdf=fold_pdf)

    def finish(model, carry, comp):
        from khg_tpu_torch.recipes.pipeline import _split_carry

        gconsts, miv, iv, weights = model
        total = _reduce_carry(mesh, carry, comp)
        occ, mean_acc, var_acc = _split_carry(total, num_pdfs, num_mix, dim,
                                              num_tids)[:3]
        new_model = _dense_mstep(occ, mean_acc, var_acc, gconsts, miv, iv,
                                 weights, **_mstep_kwargs(mle_config))
        return new_model, total[off:]

    return ShardedResidentEm(lambda: _zeros_carry(mesh, W), fold, finish, W,
                             num_tids)


class ShardedResidentEmLoop(NamedTuple):
    """Fully resident multi-pass EM over the mesh (see
    sharded_resident_em_loop)."""

    make_carry: Callable   # () -> (carry, comp): this rank's zeros
    fold: Callable         # (model, delta, carry, comp, graphs, feats, nf,
                           #  [id2pdf,] offsets=None) -> (carry, comp);
                           #  graphs hold BASE (prob-free) costs
    finish: Callable       # (model, carry, comp, logp) ->
                           #  (new_model, logp_new, delta_new, packet)
    delta: Callable        # (logp) -> delta (for the first pass)
    carry_width: int
    num_tids: int


def _loop_finish(mesh, struct, num_pdfs, num_mix, dim, transition_scale,
                 self_loop_scale, mle_config, transition_cfg):
    """finish of the resident loops: the pass's reduction, then the
    pipeline's pass finisher (M-step, transition update, new deltas)."""
    from khg_tpu_torch.model.transition_model import MleTransitionUpdateConfig
    from khg_tpu_torch.recipes.pipeline import finish_pass

    tcfg = transition_cfg or MleTransitionUpdateConfig()
    if tcfg.share_for_pdfs:
        raise ValueError("the device transition update is the non-shared variant")
    kw = _mstep_kwargs(mle_config)
    off = num_pdfs * num_mix * (2 * dim + 1)

    def finish(model, carry, comp, logp):
        total = _reduce_carry(mesh, carry, comp)
        new_model, logp_new, delta, _row = finish_pass(
            model, total, logp, struct, kw, tcfg, transition_scale,
            self_loop_scale,
        )
        return new_model, logp_new, delta, total[off:]

    return finish


def _delta_fn(struct, transition_scale, self_loop_scale):
    from khg_tpu_torch.model.transition_device import transition_cost_deltas_device

    return lambda logp: transition_cost_deltas_device(
        logp, struct, transition_scale, self_loop_scale
    )


def sharded_resident_em_loop(
    mesh: DataMesh,
    num_pdfs: int,
    num_mix: int,
    dim: int,
    num_tids: int,
    struct,
    acoustic_scale: float = 1.0,
    transition_scale: float = 1.0,
    self_loop_scale: float = 1.0,
    uniform_dest_pdf: bool = False,
    banded_offsets: Optional[Tuple[int, ...]] = None,
    mle_config=None,
    transition_cfg=None,
    per_state: bool = False,
    likelihood_backend: str = "xla",
) -> ShardedResidentEmLoop:
    """The mesh's EStepPipeline.em_passes_resident: the transition
    update and the graph-cost refresh join the M-step inside the
    replicated ``finish``, so N passes need one reduction per pass and
    one host fetch at the end.

    ``struct`` is model.transition_device.build_transition_struct(tm);
    the graphs given to ``fold`` are packed from pack_graphs_base
    output (costs WITHOUT transition probs): the current probs are
    added per call as delta[tid].  As in the pipeline, banded batches
    must be free of parallel arcs for that to equal pack-after-refresh
    (EStepPipeline.device_batches packs only those banded); dense
    tables are exact unconditionally.

    Equality contract (tests/test_torch_parallel.py; chip_smoke.py
    phase 11): N fold/finish rounds equal em_passes_resident on the
    same batches, at any world size."""
    from khg_tpu_torch.recipes.pipeline import _carry_fold, _carry_width

    del uniform_dest_pdf
    W = _carry_width(num_pdfs, num_mix, dim, num_tids)
    align = _hard_estep(acoustic_scale, likelihood_backend, banded_offsets,
                        per_state)

    def fold(model, delta, carry, comp, graphs, feats, num_frames, id2pdf,
             offsets=None):
        res, scores, fold_pdf = align(model, graphs, feats, num_frames, id2pdf,
                                      offsets, delta)
        return _carry_fold(*model[:3], feats, res.tids, num_frames, res.failed,
                           id2pdf, res.total_cost, carry, comp, scores=scores,
                           state_pdf=fold_pdf)

    finish = _loop_finish(mesh, struct, num_pdfs, num_mix, dim, transition_scale,
                          self_loop_scale, mle_config, transition_cfg)
    return ShardedResidentEmLoop(
        lambda: _zeros_carry(mesh, W), fold, finish,
        _delta_fn(struct, transition_scale, self_loop_scale), W, num_tids,
    )


def sharded_resident_fb_em_loop(
    mesh: DataMesh,
    num_pdfs: int,
    num_mix: int,
    dim: int,
    num_tids: int,
    struct,
    acoustic_scale: float = 1.0,
    transition_scale: float = 1.0,
    self_loop_scale: float = 1.0,
    uniform_dest_pdf: bool = False,
    banded_offsets: Optional[Tuple[int, ...]] = None,
    mle_config=None,
    transition_cfg=None,
    likelihood_backend: str = "xla",
) -> ShardedResidentEmLoop:
    """Soft-EM (Baum-Welch) twin of sharded_resident_em_loop: per rank,
    forward-backward posteriors and expected transition counts fold
    into the same Kahan carry (recipes/pipeline._soft_carry_fold); the
    replicated finish runs the M-step, the transition update on the
    expected counts and the cost refresh.  ``fold(model, delta, carry,
    comp, graphs, feats, num_frames, offsets=None)``: banded tables
    (FB-packed, free of parallel arcs) or dense log-semiring tables."""
    from khg_tpu_torch.recipes.pipeline import _carry_width, _soft_carry_fold

    W = _carry_width(num_pdfs, num_mix, dim, num_tids)
    fb_estep = _soft_estep(acoustic_scale, likelihood_backend, uniform_dest_pdf,
                           banded_offsets, num_tids)

    def fold(model, delta, carry, comp, graphs, feats, num_frames, offsets=None):
        fb, scores = fb_estep(model, graphs, feats, num_frames, offsets, delta)
        return _soft_carry_fold(*model[:3], feats, fb, carry, comp, scores=scores)

    finish = _loop_finish(mesh, struct, num_pdfs, num_mix, dim, transition_scale,
                          self_loop_scale, mle_config, transition_cfg)
    return ShardedResidentEmLoop(
        lambda: _zeros_carry(mesh, W), fold, finish,
        _delta_fn(struct, transition_scale, self_loop_scale), W, num_tids,
    )


def unpack_resident_packet(packet, num_tids: int):
    """Split a finish() packet into (tot_log_like, tot_frames,
    tid_counts, like_sum, num_done, num_error, frame_count)."""
    if isinstance(packet, torch.Tensor):
        packet = packet.detach().cpu().numpy()
    packet = np.asarray(packet, dtype=np.float64)
    tot_ll, tot_frames = packet[0], packet[1]
    counts = packet[2 : 2 + num_tids + 1]
    like_sum, num_done, num_error, frame_count = packet[2 + num_tids + 1 :]
    return (tot_ll, tot_frames, counts, like_sum, num_done, num_error,
            frame_count)


def _mstep_kwargs(mle_config) -> dict:
    """kwargs for _dense_mstep from an est.mle.MleDiagGmmOptions (or None)."""
    if mle_config is None:
        return {}
    return dict(
        min_variance=float(mle_config.min_variance),
        min_gaussian_occupancy=float(mle_config.min_gaussian_occupancy),
        min_gaussian_weight=float(mle_config.min_gaussian_weight),
        remove_low_count_gaussians=bool(mle_config.remove_low_count_gaussians),
        variance_floor_vector=mle_config.variance_floor_vector,
    )
