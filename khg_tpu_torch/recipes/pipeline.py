"""Batched device E-step: align utterances and accumulate statistics
(PyTorch port of khg_tpu/recipes/pipeline.py: hard EM and soft EM).

Bridges the host world (ragged utterances, FST graphs, mutable models)
and the device world (padded dense tensors, CUDA kernels):

  1. pack the acoustic model (one padded tensor set per pass),
  2. pack each utterance's training graph once, without transition
     probabilities; every pass adds the current per-tid cost deltas on
     the device,
  3. batch utterances by length and pad each batch's (T, S),
  4. per batch: GMM scoring -> Viterbi (banded CUDA kernel, or the
     non-banded CUDA kernel for batches that do not fit a band) ->
     stats fold into a Kahan-compensated f64 carry; soft EM runs
     forward-backward instead (banded CUDA kernels, or the eager dense
     FB) and folds posterior-weighted stats into the same carry.
     Wide models (more than EXTERNAL_AC_PDFS pdfs) score banded
     batches per graph state: the banded kernel reads that lattice and
     the stats fold kernel (stats/fold_kernel.py) rescores each frame's
     aligned state, so no stage scores all P pdfs,
  5. per pass: dense M-step and transition update on the device; the
     host fetches one record block at the end of a multi-pass stretch.

The host-driven E-steps of khg_tpu's loop run here too:
``align_and_accumulate`` (Viterbi alignments back to the host, with or
without per-batch stats; the realignment of recipes/yesno.train_yesno)
and ``em_pass_resident`` (one carry pass + the device M-step, the
transition update left to the host), on graphs that already carry the
transition probs.

The per-batch steps (``score_batch``, ``align_batch``, ``fb_batch``,
and the carry rows they fold) are module functions: the sharded steps
and loops of parallel/mesh.py run the same ones on each rank's shard.

Carry layout (one flat f64 vector, ``resident_carry``; a batch's row
is f32):
  [occ (P*K), mean_acc (P*K*D), var_acc (P*K*D), tot_log_like,
   tot_frames, tid_counts (num_tids+1), like_sum, num_done, num_error,
   frame_count]
(soft EM: like_sum is the sum of log Z and frame_count is 0.)
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from khg_tpu_torch.align.banded_fb import fb_kernel_fits, forward_backward_banded
from khg_tpu_torch.align.banded_kernel import kernel_fits, viterbi_align_banded
from khg_tpu_torch.align.forward_backward import FBResult, forward_backward_batch
from khg_tpu_torch.align.packed import (
    FAIL_PAD_THRESHOLD,
    PackedGraph,
    pack_graph,
    pack_graph_batch,
    uniform_dest_pdf,
)
from khg_tpu_torch.align.viterbi import viterbi_align_batch
from khg_tpu_torch.fstlib.fst import VectorFst
from khg_tpu_torch.gmm.am_gmm import AmDiagGmm
from khg_tpu_torch.gmm.fused_loglikes import loglikes_fused
from khg_tpu_torch.gmm.likelihoods import (
    component_scores,
    loglikes,
    loglikes_per_state,
)
from khg_tpu_torch.graph.h_builder import (
    _scaled_transition_log_prob,
    add_transition_probs,
    modify_graph_for_careful_alignment,
)
from khg_tpu_torch.model.transition_model import TransitionModel
from khg_tpu_torch.stats.accum import (
    _SCORES_ALL_MAX_BYTES,
    AccumAmDiagGmm,
    accumulate_am_stats,
    accumulate_am_stats_soft,
    accumulate_transition_stats,
    segment_sum,
)
from khg_tpu_torch.stats.fold_kernel import accumulate_am_stats_fold
from khg_tpu_torch.utils.convert import banded_to_torch, batched_graphs_to_torch
from khg_tpu_torch.utils.platform import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# above this many pdfs the E-step scores banded batches per graph state
# and the banded kernel reads that (B, T, S) lattice (external-acoustic
# mode) instead of (B, T, P) loglikes
EXTERNAL_AC_PDFS = 512


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _carry_width(P: int, K: int, D: int, num_tids: int) -> int:
    return P * K * (2 * D + 1) + 2 + (num_tids + 1) + 4


def _unpack_stats(flat: np.ndarray, P: int, K: int, D: int):
    """Host-side (occ, mean_acc, var_acc, tot_log_like, tot_frames) of
    packed GMM stats (a batch's, or the head of a carry)."""
    pk, pkd = P * K, P * K * D
    occ = flat[:pk].reshape(P, K)
    mean_acc = flat[pk : pk + pkd].reshape(P, K, D)
    var_acc = flat[pk + pkd : pk + 2 * pkd].reshape(P, K, D)
    tot_log_like, tot_frames = flat[pk + 2 * pkd :]
    return occ, mean_acc, var_acc, float(tot_log_like), float(tot_frames)


def _unpack_carry(flat: np.ndarray, P: int, K: int, D: int, num_tids: int):
    """Host-side inverse of the carry layout (see module docstring)."""
    base = P * K * (2 * D + 1) + 2
    counts = flat[base : base + 1 + num_tids].astype(np.float64)
    like_sum, num_done, num_error, frame_count = flat[base + 1 + num_tids :]
    return (
        *_unpack_stats(flat[:base], P, K, D), counts,
        float(like_sum), int(round(float(num_done))),
        int(round(float(num_error))), int(round(float(frame_count))),
    )


def _kahan_add(carry, comp, x):
    """One compensated-summation step; returns (carry', comp').  Eager
    PyTorch evaluates each op as written, so nothing reassociates
    ``(t - carry) - y`` away."""
    y = x - comp
    t = carry + y
    return t, (t - carry) - y


def resident_carry(width: int, device):
    """(carry, comp) zeros of a pass's carry, every E-step's: f64, so
    that a pass's sum of f32 batch rows is exact (unless an entry's rows
    span more than the 29 bits f64 has beyond f32) and so does not
    depend on how the batches are grouped: one process folding all of
    them, or ranks folding their shares before an all-reduce, reach the
    same total.  The Kahan step (``_kahan_add``) runs on it unchanged;
    every pass reads its total through ``_carry_total``."""
    carry = torch.zeros(width, dtype=torch.float64, device=device)
    return carry, torch.zeros_like(carry)


def _carry_total(carry, comp):
    """A carry's compensated total, rounded once to f32 for the M-step:
    the carry minus its compensation (``_kahan_add`` keeps in ``comp``
    the excess that rounding added to the running sum).  Every pass
    finishes on it, and so do the sharded loops of parallel/mesh.py
    (with carry and compensation each summed over the ranks first)."""
    return (carry.double() - comp.double()).float()


def _hard_stats(gconsts, miv, iv, bfeats, tids, lens, failed, id2pdf,
                scores=None, state_pdf=None):
    """(GMM stats, frame weights (B, T)) of one aligned batch, failed
    utterances weighted 0.  ``scores`` are the batch's component scores
    when scoring already computed them.  Pass ``state_pdf`` (B, S) on
    wide models to fold through each utterance's graph states
    (stats/fold_kernel.py): O(S) not O(P)."""
    T = bfeats.shape[1]
    dev = bfeats.device
    fw = (
        (torch.arange(T, device=dev)[None, :] < lens[:, None]) & ~failed[:, None]
    ).to(torch.float32)
    if state_pdf is not None:
        s = accumulate_am_stats_fold(
            gconsts, miv, iv, bfeats, id2pdf[tids.long()], fw, state_pdf
        )
    else:
        s = accumulate_am_stats(
            gconsts, miv, iv, bfeats, id2pdf[tids.long()], fw, scores=scores
        )
    return s, fw


def _hard_row(gconsts, miv, iv, bfeats, tids, lens, failed, id2pdf,
              total_cost, scores=None, state_pdf=None):
    """One aligned batch's stats (``_hard_stats``) and transition counts
    as a row of the carry layout."""
    s, fw = _hard_stats(gconsts, miv, iv, bfeats, tids, lens, failed, id2pdf,
                        scores=scores, state_pdf=state_pdf)
    # transition counts: frame weights added per tid (tid 0 = padding)
    counts = segment_sum(fw.reshape(-1), tids.long().reshape(-1), id2pdf.shape[0])
    counts[0] = 0.0
    okf = (~failed).to(torch.float32)
    return _carry_row(s, counts, torch.sum(-total_cost * okf), failed,
                      torch.sum(lens.to(torch.float32) * okf))


def _carry_fold(
    gconsts, miv, iv, bfeats, tids, lens, failed, id2pdf, total_cost,
    carry, comp, scores=None, state_pdf=None,
):
    """Fold one aligned batch's row (``_hard_row``) into the carry."""
    return _kahan_add(carry, comp, _hard_row(
        gconsts, miv, iv, bfeats, tids, lens, failed, id2pdf, total_cost,
        scores=scores, state_pdf=state_pdf))


def _split_carry(carry, P: int, K: int, D: int, num_tids: int):
    """(occ, mean_acc, var_acc, [tot_log_like, tot_frames], tid counts,
    [like_sum, num_done, num_error, frame_count]): views of a device
    carry (layout in the module docstring)."""
    pk, pkd = P * K, P * K * D
    off = pk + 2 * pkd
    return (
        carry[:pk].reshape(P, K),
        carry[pk : pk + pkd].reshape(P, K, D),
        carry[pk + pkd : off].reshape(P, K, D),
        carry[off : off + 2],
        carry[off + 2 : off + 3 + num_tids],
        carry[off + 3 + num_tids :],
    )


def _start_fetch(tensors):
    """Issue device->host copies of ``tensors``: on CUDA each into
    pinned memory, non-blocking, behind one recorded event; CPU tensors
    are already host memory.  ``_finish_fetch`` waits and returns
    numpy arrays."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    hosts = []
    for x in tensors:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        hosts.append(h)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return hosts, event


def _finish_fetch(fetch):
    hosts, event = fetch
    if event is not None:
        event.synchronize()
    return [h.numpy() for h in hosts]


def _carry_row(s, counts, like_sum, failed, frame_count):
    """One batch's contribution in the carry layout (module docstring)."""
    return torch.cat([
        s.occ.reshape(-1),
        s.mean_acc.reshape(-1),
        s.var_acc.reshape(-1),
        s.tot_log_like[None],
        s.tot_frames[None],
        counts,
        like_sum[None],
        torch.sum((~failed).to(torch.float32))[None],
        torch.sum(failed.to(torch.float32))[None],
        frame_count[None],
    ])


def _soft_row(gconsts, miv, iv, bfeats, fb: FBResult, scores=None):
    """One forward-backward batch's soft stats and expected transition
    counts as a row of the carry layout (frame_count is 0: FB has no
    hard assignment).  Utterances with no complete path add nothing but
    their failure."""
    ok = ~fb.failed
    gamma = torch.where(ok[:, None, None], fb.gamma, 0.0)
    s = accumulate_am_stats_soft(gconsts, miv, iv, bfeats, gamma, scores=scores)
    counts = torch.sum(torch.where(ok[:, None], fb.tid_counts, 0.0), dim=0)
    return _carry_row(s, counts, torch.sum(torch.where(ok, fb.log_z, 0.0)),
                      fb.failed, torch.zeros((), device=bfeats.device))


def _soft_carry_fold(gconsts, miv, iv, bfeats, fb: FBResult, carry, comp,
                     scores=None):
    """Fold one forward-backward batch's row (``_soft_row``) into the
    carry, so the hard passes' finisher works on it."""
    return _kahan_add(carry, comp, _soft_row(gconsts, miv, iv, bfeats, fb,
                                             scores=scores))


def score_batch(gconsts, miv, iv, bfeats, likelihood_backend: str = "xla",
                wide: bool = False):
    """(loglikes (B, T, P), component scores or None) of one batch.  The
    f32 "xla" backend hands its component scores to the stats fold,
    except on wide models, whose (B, T, P, K) scores would be too large:
    those score a few utterances at a time and keep only the loglikes.
    "pallas" runs the fused kernel (B on the card)."""
    dtype = "bfloat16" if likelihood_backend.endswith("bf16") else None
    if likelihood_backend.startswith("pallas"):
        return loglikes_fused(gconsts, miv, iv, bfeats, compute_dtype=dtype), None
    if wide:
        P, K = gconsts.shape
        n = max(1, _SCORES_ALL_MAX_BYTES // (bfeats.shape[1] * P * K * 4))
        return torch.cat([
            loglikes(gconsts, miv, iv, bfeats[i : i + n], compute_dtype=dtype)
            for i in range(0, bfeats.shape[0], n)
        ]), None
    scores = component_scores(gconsts, miv, iv, bfeats, compute_dtype=dtype)
    ll = torch.logsumexp(scores, dim=-1)
    return ll, (scores if dtype is None else None)


def align_batch(gconsts, miv, iv, bfeats, lens, graphs, banded, id2pdf,
                acoustic_scale: float, likelihood_backend: str = "xla",
                wide: bool = False, delta=None):
    """Scoring + Viterbi of one batch, with the per-tid cost deltas
    added when given (``None``: the tables already carry the transition
    probs).  ``banded`` is (BandedTables, offsets) for a batch that takes
    the banded kernel, else None and ``graphs`` are dense tables.
    Returns (ViterbiResult, component scores or None, state_pdf or
    None): a banded batch of a ``wide`` model scores each graph state in
    f32 whatever the likelihood backend (as khg_tpu does), aligns on
    that lattice, and hands back the graph states its stats fold
    through."""
    if banded is not None:
        tables, offsets = banded
        if delta is not None:
            tables = tables._replace(
                plane_cost=tables.plane_cost + delta[tables.plane_tid.long()]
            )
        if wide:
            sac = loglikes_per_state(gconsts, miv, iv, tables.state_pdf, bfeats)
            res = viterbi_align_banded(
                tables, offsets, None, lens, id2pdf,
                acoustic_scale=acoustic_scale, sac=sac,
            )
            return res, None, tables.state_pdf
    ll, scores = score_batch(gconsts, miv, iv, bfeats, likelihood_backend, wide)
    if banded is not None:
        res = viterbi_align_banded(
            tables, offsets, ll, lens, id2pdf, acoustic_scale=acoustic_scale,
        )
    else:
        if delta is not None:
            graphs = graphs._replace(
                in_cost=graphs.in_cost + delta[graphs.in_tid.long()]
            )
        res = viterbi_align_batch(
            graphs, ll, lens, id2pdf, acoustic_scale=acoustic_scale,
        )
    return res, scores, None


def fb_batch(gconsts, miv, iv, bfeats, lens, graphs, banded, state_pdf,
             num_tids: int, acoustic_scale: float,
             likelihood_backend: str = "xla", delta=None, time_chunk=None):
    """Scoring + forward-backward of one batch, with the current cost
    deltas when given: (FBResult, component scores or None).  The
    cost-delta shortcut is exact on both routes: the banded packing for
    FB rejects parallel arcs, and the dense tables keep every arc.
    ``state_pdf`` (B, S) takes the dense FB's per-state acoustic route
    on destination-uniform graphs."""
    ll, scores = score_batch(gconsts, miv, iv, bfeats, likelihood_backend)
    if banded is not None:
        tables, offsets = banded
        if delta is not None:
            tables = tables._replace(
                plane_cost=tables.plane_cost + delta[tables.plane_tid.long()]
            )
        fb = forward_backward_banded(
            tables, offsets, ll, lens, num_tids, acoustic_scale=acoustic_scale,
        )
    else:
        if delta is not None:
            graphs = graphs._replace(
                in_cost=graphs.in_cost + delta[graphs.in_tid.long()],
                out_cost=graphs.out_cost + delta[graphs.out_tid.long()],
            )
        fb = forward_backward_batch(
            graphs, ll, lens, num_tids, acoustic_scale=acoustic_scale,
            state_pdf=state_pdf, time_chunk=time_chunk,
        )
    return fb, scores


def finish_pass(model, carry, logp, struct, kw, tcfg, transition_scale,
                self_loop_scale):
    """Device M-step on a pass's (reduced) carry + transition update +
    fresh cost deltas.  Returns (new_model, logp_new, delta, row) with
    the pass's record row [tot_log_like, tot_frames, like_sum,
    num_done, num_error, frame_count, transition_objf_impr,
    transition_count]."""
    from khg_tpu_torch.model.transition_device import (
        transition_cost_deltas_device,
        transition_mle_update_device,
    )
    from khg_tpu_torch.parallel.mesh import _dense_mstep

    gconsts, miv, iv, weights = model
    P, K = gconsts.shape
    occ, mean_acc, var_acc, scalars, counts, tail = _split_carry(
        carry, P, K, miv.shape[-1], struct.num_tids
    )
    new_model = _dense_mstep(
        occ, mean_acc, var_acc, gconsts, miv, iv, weights, **kw
    )
    logp_new, objf_t, count_t = transition_mle_update_device(
        counts, logp, struct, floor=tcfg.floor, mincount=tcfg.mincount
    )
    delta = transition_cost_deltas_device(
        logp_new, struct, transition_scale, self_loop_scale
    )
    row = torch.cat([scalars, tail, objf_t[None], count_t[None]])
    return new_model, logp_new, delta, row


@dataclasses.dataclass
class AlignmentResult:
    """Host-side alignment outcome for a batch of utterances.

    ``alignments`` is None when the pass ran with
    ``return_alignments=False`` (stats-only carry mode: the tid
    sequences never leave the device)."""

    alignments: Optional[List[Optional[List[int]]]]  # per utt tids (None = failed)
    tot_like: float  # sum over utts of -(graph+acoustic)/acoustic_scale
    num_done: int
    num_error: int
    frame_count: int


class EStepPipeline:
    def __init__(
        self,
        transition_model: TransitionModel,
        acoustic_scale: float = 1.0,
        transition_scale: float = 1.0,
        self_loop_scale: float = 1.0,
        batch_size: int = 64,
        frames_pad_multiple: int = 32,
        states_pad_multiple: int = 8,
        indeg_pad_multiple: int = 2,
        mix_pad_multiple: int = 1,
        likelihood_backend: str = "xla",
        align_backend: str = "xla",
        feature_cache_budget: int = 2 << 30,
        device: DeviceLike = None,
    ):
        """``likelihood_backend``: "xla" (plain f32 GEMM + logsumexp —
        default), "xla_bf16" (bf16 operands, f32 accumulation),
        "pallas" (the fused CUDA kernel, csrc/loglikes.cu) or
        "pallas_bf16" (the kernel with bf16 operands).  The names are
        khg_tpu's, kept so configurations carry over.

        ``align_backend``: "xla" (the Viterbi kernel over incoming-arc
        tables, csrc/viterbi.cu) or "banded" (the banded CUDA kernel
        wherever a batch fits a band menu with fewer than 128 planes and
        no parallel arcs; the incoming-arc kernel otherwise).  Both are
        exact; on the CPU their plain versions run.  Soft EM picks the
        same way between the banded forward-backward kernels (no parallel arcs,
        tables within a block's shared memory) and the eager dense FB.

        ``feature_cache_budget``: bytes of padded feature batches kept
        on the device across calls, keyed on the utterance arrays'
        identity; do not mutate feature arrays in place between passes.
        0 disables caching.

        ``device``: None means CUDA (raises without a card); pass
        "cpu" for the plain PyTorch path."""
        self.device = resolve_device(device)
        self.tm = transition_model
        self.acoustic_scale = acoustic_scale
        self.transition_scale = transition_scale
        self.self_loop_scale = self_loop_scale
        self.batch_size = batch_size
        self.frames_pad = frames_pad_multiple
        self.states_pad = states_pad_multiple
        self.indeg_pad = indeg_pad_multiple
        self.mix_pad = mix_pad_multiple
        self.id2pdf = transition_model.id2pdf_array()
        self._id2pdf_t = torch.as_tensor(
            self.id2pdf.astype(np.int64), device=self.device
        )
        from khg_tpu_torch.utils.profiling import Counters

        self.counters = Counters()
        assert likelihood_backend in ("xla", "xla_bf16", "pallas", "pallas_bf16")
        self.likelihood_backend = likelihood_backend
        assert align_backend in ("xla", "banded")
        self.align_backend = align_backend
        self.feature_cache_budget = feature_cache_budget
        self._feat_cache = {}
        self._feat_cache_bytes = 0
        self._batch_graph_cache = {}

    # ------------------------------------------------------------ batches

    def _batch_feats(self, idx, feats):
        """One padded feature batch on the device, cached across calls.

        Returns (bfeats (B, bt, D) f32, lens (B,) int32, bt)."""
        bt = _round_up(max(feats[i].shape[0] for i in idx), self.frames_pad)
        lens_np = np.array([feats[i].shape[0] for i in idx], dtype=np.int32)
        lens = torch.as_tensor(lens_np, device=self.device)
        key = (bt,) + tuple(
            (id(feats[i]), feats[i].ctypes.data, feats[i].shape) for i in idx
        )
        hit = self._feat_cache.get(key)
        if hit is not None:
            return hit[0], lens, bt
        bfeats_np = np.zeros((len(idx), bt, feats[idx[0]].shape[1]), np.float32)
        for j, i in enumerate(idx):
            bfeats_np[j, : feats[i].shape[0]] = feats[i]
        bfeats = torch.as_tensor(bfeats_np, device=self.device)
        if 0 < bfeats_np.nbytes <= self.feature_cache_budget:
            while self._feat_cache_bytes + bfeats_np.nbytes > self.feature_cache_budget:
                old_key = next(iter(self._feat_cache))
                old = self._feat_cache.pop(old_key)
                self._feat_cache_bytes -= old[0].numel() * 4
            # pin the source arrays: the key uses id() + data pointer,
            # which the allocator may reuse once an array is freed
            self._feat_cache[key] = (bfeats, [feats[i] for i in idx])
            self._feat_cache_bytes += bfeats_np.nbytes
        return bfeats, lens, bt

    def _batch_graphs(self, idx, packed_graphs, fb: bool = False):
        """(graphs, banded, state_pdf) device tables for these
        utterances, cached on the PackedGraph objects' identity.

        ``banded`` is (BandedTables, offsets) when the batch takes the
        banded kernel(s), else None; ``state_pdf`` is the (B, S) uniform
        destination pdf for the eager DP (None when banded, or when
        the graphs are not destination-uniform).  ``fb`` packs for
        forward-backward: log-semiring costs, banded FB kernels."""
        key = (fb, self.states_pad, self.indeg_pad,
               tuple(id(packed_graphs[i]) for i in idx))
        hit = self._batch_graph_cache.get(key)
        if hit is not None:
            return hit[:3]
        graphs = pack_graph_batch(
            [packed_graphs[i] for i in idx],
            states_pad_to=self.states_pad,
            indeg_pad_to=self.indeg_pad,
            semiring="log" if fb else "tropical",
        )
        banded = (
            self._try_pack_banded(graphs, fb=fb)
            if self.align_backend == "banded" else None
        )
        sp = None if banded is not None else uniform_dest_pdf(graphs)
        out = (
            batched_graphs_to_torch(graphs, self.device),
            banded,
            None if sp is None else torch.as_tensor(sp, device=self.device),
        )
        self._batch_graph_cache[key] = out + ([packed_graphs[i] for i in idx],)
        while len(self._batch_graph_cache) > 256:
            self._batch_graph_cache.pop(next(iter(self._batch_graph_cache)))
        return out

    @staticmethod
    def _banded_parallel_free(graphs) -> bool:
        """True when no (src, dst) pair carries 2+ real arcs: banded
        packing then never min-prunes, so adding cost deltas to the
        base-packed planes is EXACTLY pack-after-refresh.  (With
        parallel arcs the min is taken under the costs current at pack
        time, and the delta shortcut would freeze that choice.)"""
        in_src = np.asarray(graphs.in_src)
        real = np.asarray(graphs.in_cost) < FAIL_PAD_THRESHOLD
        bs, ss, ms = np.nonzero(real)
        if len(bs) == 0:
            return True
        src = in_src[bs, ss, ms].astype(np.int64)
        S = in_src.shape[1]
        cell = (bs.astype(np.int64) * S + ss) * S + src
        return len(np.unique(cell)) == len(cell)

    def _try_pack_banded(self, graphs, fb: bool = False):
        """(BandedTables, offsets) for this batch, or None for the eager
        DP: no band menu covers the arcs, parallel arcs (the per-pass
        cost deltas would not be exact; FB would also lose their mass),
        or tables the kernel does not take (Viterbi: 128+ planes for its
        int8 backpointers; both: beyond a block's shared memory).
        Decided from shapes alone, before any launch."""
        from khg_tpu_torch.align.banded import band_renumber, pack_banded

        # FB packing rejects parallel arcs itself (reject_parallel)
        if not fb and not self._banded_parallel_free(graphs):
            return None
        ren, _perm = band_renumber(graphs)
        sp = uniform_dest_pdf(ren)
        if sp is None:
            return None
        out = pack_banded(ren, sp, reject_parallel=fb)
        if out is None:
            return None
        banded, offsets = out
        _B, DK, S = banded.plane_cost.shape
        if not (fb_kernel_fits if fb else kernel_fits)(DK, S):
            return None
        return banded_to_torch(banded, self.device), offsets

    # ------------------------------------------------------------ packing

    def pack_graphs(
        self, graphs: Sequence[VectorFst], careful: bool = False
    ) -> List[PackedGraph]:
        """Apply the current transition probs (align-time scales) and
        pack.  Mirrors gmm_align_compiled: scaled transition costs are
        ADDED to the compile-time graph costs, on a copy.  ``careful``
        concatenates a final-stripped copy so wrap-around alignments
        fail loudly (AlignConfig.careful); such graphs have 2S + 1
        states."""
        id2pdf = self.tm.id2pdf_array()
        packed = []
        for g in graphs:
            gc = g.copy()
            add_transition_probs(
                self.tm, gc, self.transition_scale, self.self_loop_scale
            )
            if careful:
                gc = modify_graph_for_careful_alignment(gc)
            packed.append(pack_graph(gc, id2pdf))
        return packed

    def pack_graphs_base(
        self, graphs: Sequence[VectorFst]
    ) -> List[PackedGraph]:
        """Pack once WITHOUT transition probs; every resident pass adds
        the current per-tid cost deltas on the device."""
        id2pdf = self.tm.id2pdf_array()
        return [pack_graph(g, id2pdf) for g in graphs]

    def transition_cost_deltas(self) -> np.ndarray:
        """(num_tids+1,) f32: -scaled log P(tid) under the CURRENT
        transition model (index 0 = 0), as add_transition_probs applies
        per arc (hmm-utils.cc:442-493)."""
        n = self.tm.num_transition_ids
        d = np.zeros(n + 1, dtype=np.float32)
        for tid in range(1, n + 1):
            d[tid] = -_scaled_transition_log_prob(
                self.tm, tid, self.transition_scale, self.self_loop_scale
            )
        return d

    def refresh_transition_costs(
        self, base: Sequence[PackedGraph]
    ) -> List[PackedGraph]:
        """Packed graphs with the current transition probs applied.

        Equivalent to pack_graphs on the original FSTs up to f32
        association (the delta adds after the eps-prefix sum instead of
        before); eps paths carry no tids, so exactly one delta applies
        per packed arc.  Padding survives: delta[tid=0] = 0."""
        d = self.transition_cost_deltas()
        out = []
        for pg in base:
            repl = dict(
                in_cost=(pg.in_cost + d[pg.in_tid]).astype(np.float32),
                out_cost=(pg.out_cost + d[pg.out_tid]).astype(np.float32),
            )
            if pg.in_cost_log is not None:
                # paths combined into one slot share the tid, so the
                # delta commutes with the log-add: exact
                repl["in_cost_log"] = (
                    pg.in_cost_log + d[pg.in_tid]
                ).astype(np.float32)
                repl["out_cost_log"] = (
                    pg.out_cost_log + d[pg.out_tid]
                ).astype(np.float32)
            out.append(dataclasses.replace(pg, **repl))
        return out

    def _pack_model(self, am: AmDiagGmm):
        """(gconsts, means_invvars, inv_vars) f32 tensors on the device."""
        m = am.pack(mix_pad_to=self.mix_pad)
        return tuple(
            torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            for x in (m.gconsts, m.means_invvars, m.inv_vars)
        )

    def pack_model_device(self, am: AmDiagGmm):
        """(gconsts, means_invvars, inv_vars, weights) device tuple for
        device-resident EM passes."""
        gconsts, miv, iv = self._pack_model(am)
        P, K = gconsts.shape
        w = np.zeros((P, K), dtype=np.float32)
        for p in range(am.num_pdfs):
            g = am.get_pdf(p)
            w[p, : g.num_gauss] = g.weights
        return (gconsts, miv, iv, torch.as_tensor(w, device=self.device))

    def apply_model_to_am(self, model, am: AmDiagGmm) -> None:
        """Write a device-resident model back into the host AmDiagGmm —
        the sync point for checkpoints and mix-up.  Components the
        device M-step deactivated (weight 0) are dropped, matching the
        reference's post-removal shape."""
        gconsts, miv, iv, w = (x.detach().cpu().numpy() for x in model)
        D = am.dim
        for p in range(am.num_pdfs):
            g = am.get_pdf(p)
            k = g.num_gauss
            keep = w[p, :k] > 0
            if not keep.all():
                g.resize(int(keep.sum()), D)
            g.weights = w[p, :k][keep].astype(np.float32).copy()
            g.inv_vars = iv[p, :k, :D][keep].astype(np.float32).copy()
            g.means_invvars = miv[p, :k, :D][keep].astype(np.float32).copy()
            g.valid_gconsts = False
            g.compute_gconsts()

    # ------------------------------------------------------------- e-step

    def _is_wide(self) -> bool:
        """More pdfs than are scored in full: per-state scoring."""
        return int(self.id2pdf.max()) + 1 > EXTERNAL_AC_PDFS

    def _align_batch(self, gconsts, miv, iv, bfeats, lens, graphs, banded,
                     delta=None):
        """``align_batch`` with this pipeline's settings (``wide`` above
        EXTERNAL_AC_PDFS pdfs)."""
        return align_batch(
            gconsts, miv, iv, bfeats, lens, graphs, banded, self._id2pdf_t,
            self.acoustic_scale, self.likelihood_backend, self._is_wide(),
            delta,
        )

    def _estep_batch(self, gconsts, miv, iv, bfeats, lens, graphs, banded,
                     state_pdf, delta, carry, comp):
        """Scoring + Viterbi (``_align_batch``) + stats fold of one
        batch.  ``state_pdf`` is the soft step's (dense FB); the hard
        step's Viterbi selects per arc."""
        res, scores, fold_pdf = self._align_batch(
            gconsts, miv, iv, bfeats, lens, graphs, banded, delta
        )
        return _carry_fold(
            gconsts, miv, iv, bfeats, res.tids, lens, res.failed,
            self._id2pdf_t, res.total_cost, carry, comp, scores=scores,
            state_pdf=fold_pdf,
        )

    def _fb_batch(self, gconsts, miv, iv, bfeats, lens, graphs, banded,
                  state_pdf, delta=None, time_chunk=None):
        """``fb_batch`` with this pipeline's settings."""
        return fb_batch(
            gconsts, miv, iv, bfeats, lens, graphs, banded, state_pdf,
            self.tm.num_transition_ids, self.acoustic_scale,
            self.likelihood_backend, delta, time_chunk,
        )

    def _soft_estep_batch(self, gconsts, miv, iv, bfeats, lens, graphs,
                          banded, state_pdf, delta, carry, comp):
        """Scoring + forward-backward + soft stats fold of one batch."""
        fb, scores = self._fb_batch(
            gconsts, miv, iv, bfeats, lens, graphs, banded, state_pdf, delta
        )
        return _soft_carry_fold(
            gconsts, miv, iv, bfeats, fb, carry, comp, scores=scores
        )

    def device_batches(self, packed_graphs: Sequence[PackedGraph],
                       feats: Sequence[np.ndarray], fb: bool = False):
        """The device batches of a resident pass, in its order
        (utterances sorted by length, ``batch_size`` at a time): a list
        of (feats (B, T, D), num_frames (B,), graphs, banded, state_pdf)
        where ``banded`` is (BandedTables, offsets) for a batch that
        takes the banded kernel(s), else None, and ``state_pdf`` is the
        dense forward-backward's uniform destination pdf or None
        (``_batch_graphs``).  The sharded loops of parallel/mesh.py
        fold these batches, each rank its share."""
        order = sorted(range(len(feats)), key=lambda i: feats[i].shape[0])
        batches = []
        for lo in range(0, len(feats), self.batch_size):
            idx = order[lo : lo + self.batch_size]
            bfeats, lens, _bt = self._batch_feats(idx, feats)
            graphs, banded, state_pdf = self._batch_graphs(
                idx, packed_graphs, fb=fb
            )
            batches.append((bfeats, lens, graphs, banded, state_pdf))
        return batches

    def em_passes_resident(
        self,
        model,
        base_packed_graphs: Sequence[PackedGraph],
        feats: Sequence[np.ndarray],
        passes: int,
        mle_config=None,
        transition_cfg=None,
        return_occ: bool = False,
    ):
        """``passes`` consecutive EM passes with model, stats carry,
        transition model and graph costs all on the device; the host
        fetches one record block at the end.

        ``base_packed_graphs`` must come from pack_graphs_base (costs
        WITHOUT transition probs); the current probs are added per pass
        as per-tid cost deltas (exact: every packed arc carries one tid,
        and batches with parallel arcs take the eager DP).

        Returns (new_model, records[, occ]) where records is a
        (passes, 8) f64 array of rows [tot_log_like, tot_frames,
        like_sum, num_done, num_error, frame_count,
        transition_objf_impr, transition_count] and occ the final pass's
        (P, K) occupancies.  The host TransitionModel is synced to the
        final device state before returning; sync the GMM side with
        apply_model_to_am.

        Models with more than EXTERNAL_AC_PDFS pdfs score banded batches
        per graph state and fold their stats through the graph states;
        their other batches score all pdfs a few utterances at a time
        and fold with accumulate_am_stats."""
        return self._resident_passes(
            model, base_packed_graphs, feats, passes, mle_config,
            transition_cfg, fb=False, return_occ=return_occ,
        )

    def fb_em_passes_resident(
        self,
        model,
        base_packed_graphs: Sequence[PackedGraph],
        feats: Sequence[np.ndarray],
        passes: int,
        mle_config=None,
        transition_cfg=None,
    ):
        """Soft-EM (Baum-Welch) twin of em_passes_resident: ``passes``
        consecutive forward-backward EM passes, all on the device.  The
        transition update runs on the EXPECTED tid counts (the same
        accumulate/update path as the reference, mle-diag-gmm.cc:100-158,
        fed by posteriors instead of a hard alignment).

        Returns (new_model, records); rows are [tot_log_like,
        tot_frames, log_z_sum, num_done, num_error, 0, t_objf, t_count]
        (frame_count is 0: FB has no hard assignment)."""
        return self._resident_passes(
            model, base_packed_graphs, feats, passes, mle_config,
            transition_cfg, fb=True,
        )

    def _resident_passes(self, model, base_packed_graphs, feats, passes,
                         mle_config, transition_cfg, fb: bool,
                         return_occ: bool = False):
        """The resident loop of em_passes_resident (``fb=False``) and
        fb_em_passes_resident (``fb=True``)."""
        from khg_tpu_torch.model.transition_device import (
            build_transition_struct,
            transition_cost_deltas_device,
        )
        from khg_tpu_torch.model.transition_model import (
            MleTransitionUpdateConfig,
        )
        from khg_tpu_torch.parallel.mesh import _mstep_kwargs

        gconsts, miv, iv, weights = model
        P, K = gconsts.shape
        D = miv.shape[-1]
        num_tids = self.tm.num_transition_ids
        tcfg = transition_cfg or MleTransitionUpdateConfig()
        assert not tcfg.share_for_pdfs, (
            "device transition update implements the non-shared variant"
        )
        struct = build_transition_struct(self.tm)
        logp = torch.as_tensor(
            np.asarray(self.tm.log_probs, np.float32), device=self.device
        )
        delta = transition_cost_deltas_device(
            logp, struct, self.transition_scale, self.self_loop_scale
        )
        batches = self.device_batches(base_packed_graphs, feats, fb=fb)
        step = self._soft_estep_batch if fb else self._estep_batch
        kw = _mstep_kwargs(mle_config)
        width = _carry_width(P, K, D, num_tids)
        rows = []
        occ_carry = None
        total_frames = sum(f.shape[0] for f in feats) * passes
        with self.counters.phase("fb" if fb else "align", frames=total_frames):
            for _ in range(passes):
                carry, comp = resident_carry(width, self.device)
                for bfeats, lens, graphs, banded, state_pdf in batches:
                    carry, comp = step(
                        gconsts, miv, iv, bfeats, lens, graphs, banded,
                        state_pdf, delta, carry, comp,
                    )
                total = _carry_total(carry, comp)
                (gconsts, miv, iv, weights), logp, delta, row = finish_pass(
                    (gconsts, miv, iv, weights), total, logp, struct, kw, tcfg,
                    self.transition_scale, self.self_loop_scale,
                )
                rows.append(row)
                occ_carry = total if return_occ else None
            rec = torch.stack(rows).cpu().numpy().astype(np.float64)
            logp_host = logp.cpu().numpy().astype(np.float32)
            occ = None
            if return_occ:
                occ = (
                    occ_carry[: P * K].cpu().numpy().astype(np.float64)
                    .reshape(P, K)
                )
        self.tm.log_probs[1:] = logp_host[1:]
        self.tm._compute_derived_of_probs()
        n_err = rec[:, 4].sum()
        if n_err:
            logger.warning(
                "%s failed for %d utterance-passes",
                "Forward-backward" if fb else "Alignment", int(round(n_err)),
            )
        if return_occ:
            return (gconsts, miv, iv, weights), rec, occ
        return (gconsts, miv, iv, weights), rec

    def _run_carry_fold_loop(self, gconsts, miv, iv, packed_graphs, feats):
        """Every batch's scoring + Viterbi + stats fold into one device
        carry, on graphs that already carry the transition probs.
        Returns the pass's total (``_carry_total``) on the device,
        WITHOUT fetching."""
        P, K = gconsts.shape
        width = _carry_width(P, K, miv.shape[-1], self.tm.num_transition_ids)
        carry, comp = resident_carry(width, self.device)
        n = len(feats)
        order = sorted(range(n), key=lambda i: feats[i].shape[0])
        for lo in range(0, n, self.batch_size):
            idx = order[lo : lo + self.batch_size]
            bfeats, lens, _bt = self._batch_feats(idx, feats)
            graphs, banded, _sp = self._batch_graphs(idx, packed_graphs)
            carry, comp = self._estep_batch(
                gconsts, miv, iv, bfeats, lens, graphs, banded, None, None,
                carry, comp,
            )
        return _carry_total(carry, comp)

    def _align_accumulate_carry(
        self, model, packed_graphs, feats, gmm_accs, transition_accs,
    ) -> AlignmentResult:
        """Stats-only E-step: every batch folds into the device carry;
        ONE fetch for the whole pass (see align_and_accumulate)."""
        gconsts, miv, iv = model
        P, K = gconsts.shape
        D = miv.shape[-1]
        n = len(feats)
        total_frames = sum(f.shape[0] for f in feats)
        with self.counters.phase("align", frames=total_frames):
            total = self._run_carry_fold_loop(
                gconsts, miv, iv, packed_graphs, feats
            )
            flat = total.cpu().numpy().astype(np.float64)
        (occ, mean_acc, var_acc, tot_ll, tot_frames, counts, like_sum,
         num_done, num_error, frame_count) = _unpack_carry(
            flat, P, K, D, self.tm.num_transition_ids
        )
        if num_error:
            logger.warning(
                "Alignment failed for %d of %d utterances", num_error, n
            )
        if gmm_accs is not None:
            gmm_accs.add_dense(occ, mean_acc, var_acc, tot_ll, tot_frames)
        if transition_accs is not None:
            transition_accs += counts
        return AlignmentResult(
            None, like_sum / self.acoustic_scale, num_done, num_error,
            frame_count,
        )

    def em_pass_resident(
        self,
        model,
        packed_graphs: Sequence[PackedGraph],
        feats: Sequence[np.ndarray],
        mle_config=None,
    ):
        """One full EM pass with the model on the device: the carry
        E-step folds every batch's stats on the device, the dense M-step
        consumes the carry there, and the host fetches only the
        transition counts and summary scalars.

        ``packed_graphs`` carry the transition probs (pack_graphs or
        refresh_transition_costs).  Returns (new_model, tid_counts,
        AlignmentResult with None alignments); ``new_model`` is the
        (gconsts, means_invvars, inv_vars, weights) device tuple for the
        next pass (sync it into a host AmDiagGmm with apply_model_to_am).
        The transition-model update stays on the host:
        tm.mle_update(counts), then refresh_transition_costs."""
        from khg_tpu_torch.parallel.mesh import _dense_mstep, _mstep_kwargs

        gconsts, miv, iv, weights = model
        P, K = gconsts.shape
        D = miv.shape[-1]
        num_tids = self.tm.num_transition_ids
        total_frames = sum(f.shape[0] for f in feats)
        with self.counters.phase("align", frames=total_frames):
            total = self._run_carry_fold_loop(
                gconsts, miv, iv, packed_graphs, feats
            )
            occ, mean_acc, var_acc, scalars, counts, tail = _split_carry(
                total, P, K, D, num_tids
            )
            new_model = _dense_mstep(
                occ, mean_acc, var_acc, gconsts, miv, iv, weights,
                **_mstep_kwargs(mle_config),
            )
            packet = torch.cat([counts, scalars, tail]).cpu().numpy()
        packet = packet.astype(np.float64)
        counts = packet[: num_tids + 1]
        like_sum, num_done, num_error, frame_count = packet[num_tids + 3 :]
        if num_error:
            logger.warning(
                "Alignment failed for %d of %d utterances",
                int(round(num_error)), len(feats),
            )
        return (
            new_model,
            counts,
            AlignmentResult(
                None, like_sum / self.acoustic_scale,
                int(round(num_done)), int(round(num_error)),
                int(round(frame_count)),
            ),
        )

    def align_and_accumulate(
        self,
        am: AmDiagGmm,
        packed_graphs: Sequence[PackedGraph],
        feats: Sequence[np.ndarray],
        gmm_accs: Optional[AccumAmDiagGmm] = None,
        transition_accs: Optional[np.ndarray] = None,
        accumulate: bool = True,
        max_in_flight: int = 4,
        return_alignments: bool = True,
    ) -> AlignmentResult:
        """Viterbi-align all utterances (graphs that carry the transition
        probs: pack_graphs or refresh_transition_costs); optionally
        accumulate GMM and transition stats from the alignments (weight
        1.0 per frame).

        Utterances are batched in order of length.  Each batch's result
        (tids, and one f32 vector of total costs, failure flags and,
        when accumulating, its GMM stats reduced on the device) is
        copied to pinned host memory without blocking; up to
        ``max_in_flight`` batches are in flight before the oldest is
        drained, so host work overlaps device compute.  Per utterance
        the likelihood is -total_cost / acoustic_scale
        (decoder-wrappers.cc:99); failed utterances are counted and
        logged and get no alignment.  Transition counts come from the
        host tids (f64).

        ``return_alignments=False`` (stats-only passes) folds every
        batch's GMM stats and transition counts into the device carry
        and makes ONE fetch at the end; ``result.alignments`` is then
        None."""
        import collections

        if len(packed_graphs) != len(feats):
            raise ValueError("one packed graph per utterance")
        model = self._pack_model(am)
        if not return_alignments:
            if not accumulate:
                raise ValueError(
                    "return_alignments=False only makes sense when "
                    "accumulating: the alignments are the only other output"
                )
            return self._align_accumulate_carry(
                model, packed_graphs, feats, gmm_accs, transition_accs
            )
        gconsts, miv, iv = model
        P, K = gconsts.shape
        D = miv.shape[-1]
        num_tids = self.tm.num_transition_ids
        n = len(feats)
        order = sorted(range(n), key=lambda i: feats[i].shape[0])
        alignments: List[Optional[List[int]]] = [None] * n
        totals = dict(tot_like=0.0, num_done=0, num_error=0, frame_count=0)
        do_gmm = accumulate and gmm_accs is not None

        def dispatch(idx):
            bfeats, lens, _bt = self._batch_feats(idx, feats)
            graphs, banded, _sp = self._batch_graphs(idx, packed_graphs)
            res, scores, fold_pdf = self._align_batch(
                gconsts, miv, iv, bfeats, lens, graphs, banded
            )
            parts = [res.total_cost, res.failed.to(torch.float32)]
            if do_gmm:
                s, _fw = _hard_stats(
                    gconsts, miv, iv, bfeats, res.tids, lens, res.failed,
                    self._id2pdf_t, scores=scores, state_pdf=fold_pdf,
                )
                parts += [s.occ.reshape(-1), s.mean_acc.reshape(-1),
                          s.var_acc.reshape(-1), s.tot_log_like[None],
                          s.tot_frames[None]]
            fetch = _start_fetch([res.tids, torch.cat(parts), lens])
            return idx, fetch

        def drain(job):
            idx, fetch = job
            tids, flat, lens = _finish_fetch(fetch)
            B = len(idx)
            total_cost, failed = flat[:B], flat[B : 2 * B] > 0.5
            for j, i in enumerate(idx):
                if failed[j]:
                    totals["num_error"] += 1
                    logger.warning("Alignment failed for utterance %d", i)
                    continue
                t = int(lens[j])
                alignments[i] = tids[j, :t].tolist()
                # like = -(graph_cost + acoustic_cost)/acoustic_scale, as in
                # AlignUtteranceWrapper (decoder-wrappers.cc:99)
                totals["tot_like"] += -float(total_cost[j]) / self.acoustic_scale
                totals["num_done"] += 1
                totals["frame_count"] += t
            if do_gmm:
                occ, mean_acc, var_acc, tot_ll, tot_frames = _unpack_stats(
                    flat[2 * B :].astype(np.float64), P, K, D
                )
                gmm_accs.add_dense(occ, mean_acc, var_acc, tot_ll, tot_frames)
            if accumulate and transition_accs is not None:
                ok = ~failed
                transition_accs[:] += accumulate_transition_stats(
                    torch.from_numpy(tids[ok]), torch.from_numpy(lens[ok]),
                    num_tids,
                ).numpy()

        total_frames = sum(f.shape[0] for f in feats)
        with self.counters.phase("align", frames=total_frames):
            pending = collections.deque()
            for lo in range(0, n, self.batch_size):
                pending.append(dispatch(order[lo : lo + self.batch_size]))
                if len(pending) >= max_in_flight:
                    drain(pending.popleft())
            while pending:
                drain(pending.popleft())
        return AlignmentResult(alignments, **totals)

    def accumulate_forward_backward(
        self,
        am: AmDiagGmm,
        packed_graphs: Sequence[PackedGraph],
        feats: Sequence[np.ndarray],
        gmm_accs: AccumAmDiagGmm,
        transition_accs: Optional[np.ndarray] = None,
    ) -> float:
        """Soft E-step: Baum-Welch posteriors instead of a hard
        alignment, on graphs that already carry the transition probs
        (pack_graphs or refresh_transition_costs).  Every batch folds
        into the device carry; ONE fetch for the whole pass.  Dense
        batches longer than 1,024 frames keep one alpha in 256 frames
        (forward_backward_batch's ``time_chunk``).

        Returns the total data log-likelihood (the sum of log Z)."""
        if len(packed_graphs) != len(feats):
            raise ValueError("one packed graph per utterance")
        gconsts, miv, iv = self._pack_model(am)
        P, K = gconsts.shape
        D = miv.shape[-1]
        num_tids = self.tm.num_transition_ids
        n = len(feats)
        order = sorted(range(n), key=lambda i: feats[i].shape[0])
        width = _carry_width(P, K, D, num_tids)
        carry, comp = resident_carry(width, self.device)
        for lo in range(0, n, self.batch_size):
            idx = order[lo : lo + self.batch_size]
            bfeats, lens, bt = self._batch_feats(idx, feats)
            graphs, banded, sp = self._batch_graphs(idx, packed_graphs, fb=True)
            fb, scores = self._fb_batch(
                gconsts, miv, iv, bfeats, lens, graphs, banded, sp,
                time_chunk=256 if sp is not None and bt > 1024 else None,
            )
            carry, comp = _soft_carry_fold(
                gconsts, miv, iv, bfeats, fb, carry, comp, scores=scores
            )
        flat = _carry_total(carry, comp).cpu().numpy().astype(np.float64)
        (occ, mean_acc, var_acc, tot_ll, tot_frames, counts, log_z_sum,
         _num_done, num_error, _) = _unpack_carry(flat, P, K, D, num_tids)
        if num_error:
            logger.warning(
                "Forward-backward failed for %d of %d utterances", num_error, n
            )
        gmm_accs.add_dense(occ, mean_acc, var_acc, tot_ll, tot_frames)
        if transition_accs is not None:
            transition_accs += counts
        return log_z_sum

    def accumulate_from_alignments(
        self,
        am: AmDiagGmm,
        feats: Sequence[np.ndarray],
        alignments: Sequence[Sequence[int]],
        gmm_accs: AccumAmDiagGmm,
        transition_accs: Optional[np.ndarray] = None,
    ) -> float:
        """Stats from FIXED alignments (equal-align init).  Every batch
        folds into the device carry; ONE fetch for the whole pass.
        Transition stats come straight from the host alignments (f64).
        Returns the total log-like."""
        gconsts, miv, iv = self._pack_model(am)
        P, K = gconsts.shape
        D = miv.shape[-1]
        num_tids = self.tm.num_transition_ids
        n = len(feats)
        order = sorted(range(n), key=lambda i: feats[i].shape[0])
        width = _carry_width(P, K, D, num_tids)
        carry, comp = resident_carry(width, self.device)
        for lo in range(0, n, self.batch_size):
            idx = order[lo : lo + self.batch_size]
            bfeats, lens, bt = self._batch_feats(idx, feats)
            btids = np.zeros((len(idx), bt), dtype=np.int32)
            for j, i in enumerate(idx):
                t = feats[i].shape[0]
                assert len(alignments[i]) == t
                btids[j, :t] = alignments[i]
            btids_host = torch.from_numpy(btids)
            if transition_accs is not None:
                transition_accs += accumulate_transition_stats(
                    btids_host, lens.cpu(), num_tids
                ).numpy()
            B = len(idx)
            carry, comp = _carry_fold(
                gconsts, miv, iv, bfeats, btids_host.to(self.device), lens,
                torch.zeros(B, dtype=torch.bool, device=self.device),
                self._id2pdf_t,
                torch.zeros(B, dtype=torch.float32, device=self.device),
                carry, comp,
            )
        flat = _carry_total(carry, comp).cpu().numpy().astype(np.float64)
        occ, mean_acc, var_acc, tot_ll, tot_frames = _unpack_carry(
            flat, P, K, D, num_tids
        )[:5]
        gmm_accs.add_dense(occ, mean_acc, var_acc, tot_ll, tot_frames)
        return tot_ll
