"""Lattice-generating decoding.

Produces a pruned state-level lattice: all decoding paths whose cost is
within ``lattice_beam`` of the best path, with graph and acoustic costs
kept separate on the arcs (the information Kaldi's LatticeFasterDecoder
keeps, lattice-faster-decoder.cc).  The construction is offline-equivalent
to Kaldi's online pruning: run the beam DP keeping all links, then
alpha/beta-prune tokens and links against best_cost + lattice_beam —
the same surviving set PruneActiveTokens converges to, computed in one
backward sweep.

The lattice is itself a VectorFst (ilabels = tids, olabels = words,
weight = graph + acoustic cost), plus a parallel acoustic-cost table so
costs can be re-scaled after the fact.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from khg_tpu_torch.fstlib.fst import Arc, VectorFst, shortest_path

INF = math.inf


@dataclass(frozen=True)
class LatticeFasterDecoderConfig:
    beam: float = 16.0
    max_active: int = 2**31 - 1
    min_active: int = 200
    lattice_beam: float = 10.0
    # every prune_interval frames, links/tokens that cannot lie within
    # lattice_beam of the best path through the current frontier are
    # deleted (the PruneActiveTokens analogue,
    # lattice-faster-decoder.cc:302-546) — memory stays O(live lattice)
    # instead of O(T * expanded arcs)
    prune_interval: int = 25


@dataclass
class Lattice:
    """State-level lattice with separated costs.

    fst:  VectorFst, arc weight = graph_cost + acoustic_cost
    acoustic_costs: per (state, arc-index) acoustic parts, aligned with
        fst.arcs (final acoustic cost is zero).
    """

    fst: VectorFst
    acoustic_costs: List[List[float]]
    # (frame, graph-state) origin of each lattice state: a
    # numbering-independent identity for comparing lattices
    state_keys: List[Tuple[int, int]] = None

    def best_path(self) -> Optional[Tuple[List[int], List[int], float]]:
        """(tids, words, total_cost) of the lattice's best path."""
        return shortest_path(self.fst)

    @property
    def num_states(self) -> int:
        return self.fst.num_states


def _prune_active(
    tokens: List[Dict[int, float]],
    links: List[Tuple[int, int, int, int, int, int, float, float]],
    t_now: int,
    lattice_beam: float,
) -> None:
    """Delete links/tokens provably outside lattice_beam of the best
    path through the frame-t_now frontier (in place).

    extra(s, t) = a lower bound on how much the best complete path
    through (s, t) will exceed the best total; a link's extra =
    extra(dst) + (alpha(src) + cost - alpha(dst)).  Every ACTIVE
    frontier token gets extra 0 — any of them may still become the
    winner — exactly as the reference constructs tokens with
    extra_cost = 0 and prunes backward from them
    (lattice-faster-decoder.cc:302-438).  Since completions only add
    slack, the bound is conservative: the final alpha/beta pruning
    keeps exactly the set it would keep without this call, so the
    incremental and offline lattices are identical (pinned by
    khg_tpu's tests/test_lattice.py).  Computed by backward relaxation to a
    fixpoint (within-frame eps chains need sweeps).
    """
    INF_ = INF
    frontier = tokens[t_now]
    extra: List[Dict[int, float]] = [dict() for _ in range(t_now + 1)]
    for s in frontier:
        extra[t_now][s] = 0.0
    for _ in range(1 + len(links)):
        changed = False
        for (t0, s0, t1, s1, _il, _ol, gc, acc) in reversed(links):
            if t1 > t_now:
                continue
            e1 = extra[t1].get(s1, INF_)
            if e1 == INF_:
                continue
            a0 = tokens[t0].get(s0, INF_)
            a1 = tokens[t1].get(s1, INF_)
            if a0 == INF_ or a1 == INF_:
                continue
            cand = e1 + (a0 + gc + acc - a1)
            if cand < extra[t0].get(s0, INF_) - 1e-12:
                extra[t0][s0] = cand
                changed = True
        if not changed:
            break

    def keep(link) -> bool:
        t0, s0, t1, s1, _il, _ol, gc, acc = link
        if t1 > t_now:
            return True
        e1 = extra[t1].get(s1, INF_)
        if e1 == INF_:
            return False
        a0 = tokens[t0].get(s0, INF_)
        a1 = tokens[t1].get(s1, INF_)
        if a0 == INF_:
            return False
        return e1 + (a0 + gc + acc - a1) <= lattice_beam + 1e-6
    links[:] = [ln for ln in links if keep(ln)]
    for t in range(t_now):
        ex = extra[t]
        tokens[t] = {
            s: c for s, c in tokens[t].items()
            if ex.get(s, INF_) <= lattice_beam + 1e-6
        }


class LatticeFasterDecoder:
    def __init__(
        self,
        fst: VectorFst,
        config: LatticeFasterDecoderConfig = LatticeFasterDecoderConfig(),
        backend: str = "auto",
    ):
        """backend: "native" (C++ core, exact-equal to the Python path,
        pinned by tests/test_torch_lattice.py; raises when the library
        cannot be built), "python", or "auto" (native when the shared
        library is loadable)."""
        self.fst = fst
        self.config = config
        assert backend in ("auto", "native", "python"), backend
        self.backend = backend
        self._packed_csr = None
        self._packed_shape = None

    def invalidate_graph_cache(self) -> None:
        """Drop the native backend's packed-CSR snapshot of the graph.

        The native path packs ``self.fst`` on first decode and re-packs
        automatically when the state/arc COUNTS change; in-place weight
        edits keep the counts, so call this after mutating arc weights
        (fresh graphs per model update — the repo's own pattern — never
        need it)."""
        self._packed_csr = None
        self._packed_shape = None

    def _use_native(self) -> bool:
        if self.backend == "python":
            return False
        from khg_tpu_torch.decode.native_lattice import native_available

        ok = native_available()
        if self.backend == "native" and not ok:
            from khg_tpu_torch.fstlib import native

            raise RuntimeError(f"native core unavailable: {native.build_error()}")
        return ok

    def decode(
        self,
        loglikes: np.ndarray,  # (T, num_pdfs)
        id2pdf: np.ndarray,
        acoustic_scale: float = 1.0,
        allow_partial: bool = True,
    ) -> Optional[Lattice]:
        # acoustic scores are f32 on BOTH backends (they come off the
        # device as f32; normalizing here keeps native == python exact
        # even for float64 callers)
        loglikes = np.ascontiguousarray(loglikes, dtype=np.float32)
        if self._use_native():
            from khg_tpu_torch.decode.native_lattice import (
                lattice_decode_native,
                pack_fst_csr,
            )

            # cheap staleness guard: re-pack when the graph's shape
            # changed; decoders whose graph is mutated IN PLACE (weight
            # edits) must call invalidate_graph_cache()
            shape = (self.fst.num_states, self.fst.num_arcs)
            if self._packed_csr is None or self._packed_shape != shape:
                self._packed_csr = pack_fst_csr(self.fst)
                self._packed_shape = shape
            cfg = self.config
            lat, max_live = lattice_decode_native(
                self._packed_csr, loglikes, id2pdf, acoustic_scale,
                cfg.beam, cfg.max_active, cfg.min_active,
                cfg.lattice_beam, cfg.prune_interval, allow_partial,
            )
            self.last_max_live_links = max_live
            return lat
        fst = self.fst
        cfg = self.config
        num_tids = len(id2pdf) - 1
        T = loglikes.shape[0]
        ac = -acoustic_scale * loglikes

        # tokens[t] : dict state -> best cost arriving with t frames consumed
        # links: (t_src, s_src, t_dst, s_dst, ilabel, olabel, graph_c, ac_c)
        tokens: List[Dict[int, float]] = [dict() for _ in range(T + 1)]
        links: List[Tuple[int, int, int, int, int, int, float, float]] = []

        def eps_expand(t: int, cutoff: float) -> None:
            queue = list(tokens[t].keys())
            while queue:
                s = queue.pop()
                cost = tokens[t].get(s, INF)
                if cost > cutoff:
                    continue
                for a in fst.arcs[s]:
                    if a.ilabel != 0:
                        continue
                    nc = cost + a.weight
                    if nc > cutoff:
                        continue
                    links.append((t, s, t, a.nextstate, 0, a.olabel, a.weight, 0.0))
                    if nc < tokens[t].get(a.nextstate, INF):
                        tokens[t][a.nextstate] = nc
                        queue.append(a.nextstate)

        def frame_cutoff(tok: Dict[int, float]) -> float:
            """GetCutoff semantics (faster-decoder.cc:243-335): beam
            cutoff, tightened to the max_active-th best when over
            max_active, but never pruning below min_active live
            tokens (all survive while active <= min_active)."""
            costs = np.array(list(tok.values()))
            best = float(costs.min())
            cutoff = best + cfg.beam
            if cfg.max_active < len(costs):
                k = cfg.max_active
                cutoff = min(cutoff, float(np.partition(costs, k - 1)[k - 1]))
            if cfg.min_active > 0:
                if len(costs) <= cfg.min_active:
                    return INF
                k = cfg.min_active
                cutoff = max(cutoff, float(np.partition(costs, k - 1)[k - 1]))
            return cutoff

        tokens[0][fst.start] = 0.0
        eps_expand(0, frame_cutoff(tokens[0]))
        max_live_links = 0
        for t in range(T):
            if not tokens[t]:
                return None
            cutoff = frame_cutoff(tokens[t])
            for s, cost in list(tokens[t].items()):
                if cost > cutoff:
                    continue
                for a in fst.arcs[s]:
                    if a.ilabel == 0:
                        continue
                    ac_cost = float(ac[t, id2pdf[a.ilabel]])
                    nc = cost + a.weight + ac_cost
                    links.append(
                        (t, s, t + 1, a.nextstate, a.ilabel, a.olabel,
                         a.weight, ac_cost)
                    )
                    if nc < tokens[t + 1].get(a.nextstate, INF):
                        tokens[t + 1][a.nextstate] = nc
            if not tokens[t + 1]:
                return None
            eps_expand(t + 1, frame_cutoff(tokens[t + 1]))
            max_live_links = max(max_live_links, len(links))
            if (t + 1) % cfg.prune_interval == 0 and t + 1 < T:
                _prune_active(tokens, links, t + 1, cfg.lattice_beam)
        max_live_links = max(max_live_links, len(links))
        self.last_max_live_links = max_live_links  # observability/tests

        # final costs
        finals = {
            s: fst.final[s]
            for s in tokens[T]
            if fst.final[s] != INF
        }
        partial = not finals
        if partial:
            if not allow_partial:
                return None
            finals = {s: 0.0 for s in tokens[T]}

        # ---- alpha (already have best forward costs in tokens) and beta
        beta: List[Dict[int, float]] = [dict() for _ in range(T + 1)]
        for s, fw in finals.items():
            beta[T][s] = fw
        # Relax links backward to a fixpoint: one reversed sweep handles the
        # frame-major order; within-frame epsilon chains may need extra
        # sweeps (their append order is exploration order, not topological).
        for _ in range(1 + len(links)):
            changed = False
            for (t0, s0, t1, s1, il, ol, gc, acc) in reversed(links):
                b = beta[t1].get(s1, INF)
                if b == INF:
                    continue
                cand = gc + acc + b
                if cand < beta[t0].get(s0, INF) - 1e-12:
                    beta[t0][s0] = cand
                    changed = True
            if not changed:
                break

        best_total = beta[0].get(fst.start, INF)
        if best_total == INF:
            return None
        keep_cutoff = best_total + cfg.lattice_beam

        # ---- build the pruned lattice over surviving (t, state) tokens
        out = VectorFst()
        acoustic_costs: List[List[float]] = []
        state_map: Dict[Tuple[int, int], int] = {}
        state_keys: List[Tuple[int, int]] = []

        def get_state(t: int, s: int) -> int:
            key = (t, s)
            if key not in state_map:
                state_map[key] = out.add_state()
                acoustic_costs.append([])
                state_keys.append(key)
            return state_map[key]

        def surviving(t, s):
            a = tokens[t].get(s, INF)
            b = beta[t].get(s, INF)
            return a + b <= keep_cutoff + 1e-6

        for (t0, s0, t1, s1, il, ol, gc, acc) in links:
            a0 = tokens[t0].get(s0, INF)
            b1 = beta[t1].get(s1, INF)
            if a0 == INF or b1 == INF:
                continue
            if a0 + gc + acc + b1 > keep_cutoff + 1e-6:
                continue
            src = get_state(t0, s0)
            dst = get_state(t1, s1)
            out.add_arc(src, Arc(il, ol, gc + acc, dst))
            acoustic_costs[src].append(acc)
        if (0, fst.start) not in state_map:
            return None
        out.set_start(state_map[(0, fst.start)])
        for s, fw in finals.items():
            if surviving(T, s) and (T, s) in state_map:
                out.set_final(state_map[(T, s)], fw)
        return Lattice(out, acoustic_costs, state_keys)


class LatticeSimpleDecoder(LatticeFasterDecoder):
    """Unpruned-during-search variant (didactic oracle): beam = inf,
    lattice pruning still applies at extraction."""

    def __init__(
        self,
        fst: VectorFst,
        config: LatticeFasterDecoderConfig = LatticeFasterDecoderConfig(),
        backend: str = "auto",
    ):
        cfg = LatticeFasterDecoderConfig(
            beam=float("inf"),
            max_active=2**31 - 1,
            min_active=0,
            lattice_beam=config.lattice_beam,
        )
        super().__init__(fst, cfg, backend=backend)


def decode_utterances_parallel(
    decoder: LatticeFasterDecoder,
    loglikes_list,
    id2pdf: np.ndarray,
    acoustic_scale: float = 1.0,
    allow_partial: bool = True,
    max_workers: Optional[int] = None,
) -> List[Tuple[bool, List[int], List[int], float]]:
    """decode_utterance_lattice_faster over a test set, thread-parallel.

    Utterance decodes are independent, and the native decoder releases
    the GIL for the whole token-passing/pruning/best-path C call, so a
    thread pool scales with host cores (the Python backend gains
    nothing and runs serially).  Results are in input order, one
    (success, tids, words, loglike) tuple per utterance.
    """
    if max_workers is None:
        import os

        max_workers = min(32, os.cpu_count() or 1)
    if max_workers <= 1 or not decoder._use_native():
        return [
            decode_utterance_lattice_faster(
                decoder, ll, id2pdf, acoustic_scale=acoustic_scale,
                allow_partial=allow_partial,
            )
            for ll in loglikes_list
        ]
    # pack the CSR once up-front (the cache write is not thread-safe)
    from khg_tpu_torch.decode.native_lattice import pack_fst_csr

    shape = (decoder.fst.num_states, decoder.fst.num_arcs)
    if decoder._packed_csr is None or decoder._packed_shape != shape:
        decoder._packed_csr = pack_fst_csr(decoder.fst)
        decoder._packed_shape = shape
    from concurrent.futures import ThreadPoolExecutor

    def one(ll):
        return decode_utterance_lattice_faster(
            decoder, ll, id2pdf, acoustic_scale=acoustic_scale,
            allow_partial=allow_partial,
        )

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(one, loglikes_list))


def decode_utterance_lattice_faster(
    decoder: LatticeFasterDecoder,
    loglikes: np.ndarray,
    id2pdf: np.ndarray,
    acoustic_scale: float = 1.0,
    allow_partial: bool = True,
) -> Tuple[bool, List[int], List[int], float]:
    """(succeeded, alignment tids, words, log-like).

    log-like = -(total cost) as in DecodeUtteranceLatticeFaster
    (decoder-wrappers.cc:186-224).
    """
    lat = decoder.decode(
        loglikes, id2pdf, acoustic_scale=acoustic_scale,
        allow_partial=allow_partial,
    )
    if lat is None:
        return False, [], [], 0.0
    bp = lat.best_path()
    if bp is None:
        return False, [], [], 0.0
    tids, words, cost = bp
    return True, tids, words, -cost
