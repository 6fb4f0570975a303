"""Decoders over HCLG graphs.

Two paths:

- ``FasterDecoder``: host beam token-passing Viterbi over an arbitrary
  FST with per-frame cutoffs (beam / max_active / min_active) — the
  scalable path for large decoding graphs.  Semantics follow the
  reference's FasterDecoder (reference kaldi-hmm-gmm/csrc/
  faster-decoder.cc:58-423): adaptive beam from a projected next-frame
  best cost, epsilon closure after each emitting step, best-path
  backtrace separating graph and acoustic cost.

- ``decode_dense``: exact dense decode on the device for small graphs
  (the packed-graph Viterbi of training alignment: kernel G,
  csrc/viterbi.cu, on the card; its plain version on the CPU), with
  word recovery on the host.

The "decodable" here is simply a (T, num_pdfs) log-likelihood matrix plus
the tid->pdf map and an acoustic scale — the dense tensor that replaces
the reference's DecodableInterface hierarchy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from khg_tpu_torch.fstlib.fst import VectorFst

INF = math.inf


@dataclass(frozen=True)
class FasterDecoderOptions:
    beam: float = 16.0
    max_active: int = 2**31 - 1
    min_active: int = 20
    beam_delta: float = 0.5


class _Token:
    __slots__ = ("cost", "acoustic", "prev", "arc_ilabel", "arc_olabel")

    def __init__(self, cost, acoustic, prev, ilabel, olabel):
        self.cost = cost
        self.acoustic = acoustic
        self.prev = prev
        self.arc_ilabel = ilabel
        self.arc_olabel = olabel


class FasterDecoder:
    def __init__(self, fst: VectorFst, opts: FasterDecoderOptions = FasterDecoderOptions()):
        self.fst = fst
        self.opts = opts

    def decode(
        self,
        loglikes: np.ndarray,   # (T, num_pdfs)
        id2pdf: np.ndarray,     # (num_tids+1,)
        acoustic_scale: float = 1.0,
    ) -> Optional[Tuple[List[int], List[int], float, float]]:
        """Returns (alignment tids, words, total_cost, acoustic_cost) of the
        best path reaching a final state, or None."""
        fst = self.fst
        num_tids = len(id2pdf) - 1
        T = loglikes.shape[0]
        ac = -acoustic_scale * loglikes  # acoustic costs

        toks = {fst.start: _Token(0.0, 0.0, None, 0, 0)}
        toks = self._process_nonemitting(toks, INF)
        for t in range(T):
            toks, next_cutoff = self._process_emitting(
                toks, ac[t], id2pdf, num_tids
            )
            if not toks:
                return None
            # epsilon closure under the EMITTING stage's cutoff, which
            # embodies the adaptive beam (ProcessNonemitting receives
            # ProcessEmitting's cutoff in the reference,
            # faster-decoder.cc:120-152)
            toks = self._process_nonemitting(toks, next_cutoff)
        # pick best final
        best_tok = None
        best_cost = INF
        for s, tok in toks.items():
            if fst.final[s] != INF and tok.cost + fst.final[s] < best_cost:
                best_cost = tok.cost + fst.final[s]
                best_tok = tok
        if best_tok is None:
            return None
        tids: List[int] = []
        words: List[int] = []
        tok = best_tok
        acoustic = tok.acoustic
        while tok is not None:
            if tok.arc_ilabel != 0:
                tids.append(tok.arc_ilabel)
            if tok.arc_olabel != 0:
                words.append(tok.arc_olabel)
            tok = tok.prev
        return tids[::-1], words[::-1], best_cost, acoustic

    # ------------------------------------------------------------ internals

    def _get_cutoff(self, toks) -> Tuple[float, float, float]:
        """(cutoff, best_cost, adaptive_beam): GetCutoff semantics
        (faster-decoder.cc:243-335).  The adaptive beam propagates a
        max/min_active-adjusted width into the NEXT frame's pruning, so
        e.g. a huge min_active keeps decoding exact under any beam."""
        opts = self.opts
        costs = np.array([tok.cost for tok in toks.values()])
        best = float(costs.min())
        beam_cutoff = best + opts.beam
        if opts.max_active < len(costs):
            k = opts.max_active
            max_active_cutoff = float(np.partition(costs, k - 1)[k - 1])
            if max_active_cutoff < beam_cutoff:  # max_active is tighter
                return (
                    max_active_cutoff, best,
                    max_active_cutoff - best + opts.beam_delta,
                )
        if opts.min_active > 0:
            if len(costs) <= opts.min_active:
                # active <= min_active: keep everything, next frame too
                return INF, best, INF
            k = opts.min_active
            min_active_cutoff = float(np.partition(costs, k - 1)[k - 1])
            if min_active_cutoff > beam_cutoff:  # min_active is looser
                return (
                    min_active_cutoff, best,
                    min_active_cutoff - best + opts.beam_delta,
                )
        return beam_cutoff, best, opts.beam

    def _process_emitting(self, toks, ac_t, id2pdf, num_tids):
        fst = self.fst
        cutoff, best, adaptive_beam = self._get_cutoff(toks)
        new_toks = {}
        next_cutoff = INF
        for s, tok in toks.items():
            if tok.cost > cutoff:
                continue
            for a in fst.arcs[s]:
                if a.ilabel == 0:
                    continue
                assert 1 <= a.ilabel <= num_tids, "non-tid input label in graph"
                cost = tok.cost + a.weight + float(ac_t[id2pdf[a.ilabel]])
                if cost >= next_cutoff:
                    continue
                if cost + adaptive_beam < next_cutoff:
                    next_cutoff = cost + adaptive_beam
                cur = new_toks.get(a.nextstate)
                if cur is None or cost < cur.cost:
                    new_toks[a.nextstate] = _Token(
                        cost,
                        tok.acoustic + float(ac_t[id2pdf[a.ilabel]]),
                        tok,
                        a.ilabel,
                        a.olabel,
                    )
        return new_toks, next_cutoff

    def _process_nonemitting(self, toks, cutoff):
        fst = self.fst
        queue = list(toks.keys())
        while queue:
            s = queue.pop()
            tok = toks.get(s)
            if tok is None or tok.cost > cutoff:
                continue
            for a in fst.arcs[s]:
                if a.ilabel != 0:
                    continue
                cost = tok.cost + a.weight
                if cost > cutoff:
                    continue
                cur = toks.get(a.nextstate)
                if cur is None or cost < cur.cost:
                    toks[a.nextstate] = _Token(
                        cost, tok.acoustic, tok, 0, a.olabel
                    )
                    queue.append(a.nextstate)
        return toks


def recover_words(fst: VectorFst, tids: List[int]) -> List[int]:
    """Best-path word (olabel) sequence of a tid path through the graph."""
    from khg_tpu_torch.fstlib.fst import compose, make_linear_acceptor, shortest_path

    comp = compose(make_linear_acceptor(tids), fst)
    res = shortest_path(comp)
    if res is None:
        return []
    return res[1]


def decode_dense(
    hclg: VectorFst,
    loglikes,              # (T, num_pdfs) numpy array or tensor
    id2pdf: np.ndarray,
    acoustic_scale: float = 1.0,
    max_states: int = 4096,
    device=None,
) -> Optional[Tuple[List[int], List[int], float]]:
    """Exact decode of one utterance on the device Viterbi; returns
    (tids, words, total_cost).

    The DP keeps an (S, max_in_degree) incoming-arc table per frame;
    intended for small/medium graphs.  Use FasterDecoder for large
    decoding graphs (guarded by ``max_states``).  ``device``: None means
    CUDA (kernel G); ``"cpu"`` runs its plain version.
    """
    import torch

    from khg_tpu_torch.align.packed import pack_graph, pack_graph_batch
    from khg_tpu_torch.align.viterbi import viterbi_align_batch
    from khg_tpu_torch.utils.convert import batched_graphs_to_torch, to_tensor
    from khg_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    if hclg.num_states > max_states:
        raise ValueError(
            f"decode_dense: graph has {hclg.num_states} states > "
            f"max_states={max_states}; use FasterDecoder for large graphs"
        )
    packed = pack_graph(hclg, id2pdf)
    graphs = batched_graphs_to_torch(pack_graph_batch([packed]), dev)
    T = loglikes.shape[0]
    if not isinstance(loglikes, torch.Tensor):
        loglikes = to_tensor(loglikes, dev, torch.float32)
    res = viterbi_align_batch(
        graphs,
        loglikes.to(device=dev, dtype=torch.float32)[None],
        torch.tensor([T], dtype=torch.int32, device=dev),
        to_tensor(id2pdf, dev, torch.int32),
        acoustic_scale=acoustic_scale,
    )
    if bool(res.failed[0]):
        return None
    tids = res.tids[0].cpu().tolist()
    words = recover_words(hclg, tids)
    return tids, words, float(res.total_cost[0])
