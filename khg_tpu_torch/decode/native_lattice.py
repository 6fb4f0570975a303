"""Native (C++) lattice-faster decoding.

The decoding graph is packed once into CSR form (``pack_fst_csr``) and
each utterance's token passing, incremental lattice pruning, and pruned
lattice extraction run inside the native core (``fstlib/native.py``
builds ``native/khg_native.cc`` into ``build/native/``) — the same
role the reference gives its compiled LatticeFasterDecoderTpl
(reference kaldi-hmm-gmm/csrc/lattice-faster-decoder.cc:86-893).

Semantics come from decode/lattice.py (the Python implementation is the
reference); the native decoder reproduces it exactly — identical lattice
states, arcs, costs, and state keys — pinned by
tests/test_torch_lattice.py.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from khg_tpu_torch.fstlib.fst import Arc, VectorFst

INF = math.inf


@dataclass
class PackedCsrFst:
    """CSR arc table of a VectorFst with float64 weights (the host
    decoders do all cost arithmetic in double)."""

    num_states: int
    start: int
    finals: np.ndarray       # (S,) float64, +inf for non-final
    arc_offsets: np.ndarray  # (S+1,) int64
    ilabels: np.ndarray      # (A,) int32
    olabels: np.ndarray      # (A,) int32
    weights: np.ndarray      # (A,) float64
    dests: np.ndarray        # (A,) int32


def pack_fst_csr(fst: VectorFst) -> PackedCsrFst:
    n = fst.num_states
    counts = np.zeros(n + 1, dtype=np.int64)
    for s in range(n):
        counts[s + 1] = len(fst.arcs[s])
    offsets = np.cumsum(counts)
    na = int(offsets[-1])
    il = np.empty(na, dtype=np.int32)
    ol = np.empty(na, dtype=np.int32)
    w = np.empty(na, dtype=np.float64)
    dst = np.empty(na, dtype=np.int32)
    k = 0
    for s in range(n):
        for a in fst.arcs[s]:
            il[k] = a.ilabel
            ol[k] = a.olabel
            w[k] = a.weight
            dst[k] = a.nextstate
            k += 1
    finals = np.array(
        [f if f != INF else np.inf for f in fst.final], dtype=np.float64
    )
    return PackedCsrFst(n, fst.start, finals, offsets, il, ol, w, dst)


def native_available() -> bool:
    from khg_tpu_torch.fstlib import native

    return native.available()


class NativeLattice:
    """Lattice backed by flat arrays from the native decoder.

    Interface-compatible with ``decode.lattice.Lattice``; the Python
    ``VectorFst`` (plus acoustic_costs/state_keys) materializes lazily
    on first attribute access, while ``best_path`` runs natively on the
    flat arrays (an exact replica of ``fstlib.shortest_path``) — so a
    decode-to-words round trip never builds Python arc objects.
    """

    def __init__(self, n, start, src, il, ol, gc, ac, dst, key_t, key_s,
                 final_state, final_w, partial):
        self._n = n
        self._start = start
        self._src, self._il, self._ol = src, il, ol
        self._gc, self._ac, self._dst = gc, ac, dst
        self._key_t, self._key_s = key_t, key_s
        self._final_state, self._final_w = final_state, final_w
        self.partial = bool(partial)
        self._fst = None
        self._acoustic_costs = None

    @property
    def num_states(self) -> int:
        return self._n

    @property
    def fst(self) -> VectorFst:
        if self._fst is None:
            out = VectorFst()
            acoustic_costs = [[] for _ in range(self._n)]
            for _ in range(self._n):
                out.add_state()
            # bulk-convert to Python scalars once (tolist is C-speed),
            # then append in link order — the same per-state arc order
            # the Python decoder produces
            arcs = out.arcs
            for s, i, o, g, a, d in zip(
                self._src.tolist(), self._il.tolist(), self._ol.tolist(),
                self._gc.tolist(), self._ac.tolist(), self._dst.tolist(),
            ):
                arcs[s].append(Arc(i, o, g + a, d))
                acoustic_costs[s].append(a)
            out.set_start(self._start)
            for s, w in zip(self._final_state.tolist(),
                            self._final_w.tolist()):
                out.set_final(s, w)
            self._fst = out
            self._acoustic_costs = acoustic_costs
        return self._fst

    @property
    def acoustic_costs(self):
        self.fst
        return self._acoustic_costs

    @property
    def state_keys(self):
        return list(zip(self._key_t.tolist(), self._key_s.tolist()))

    def best_path(self):
        """(tids, words, total_cost) of the lattice's best path —
        computed natively; exact-equal to shortest_path(self.fst)."""
        from khg_tpu_torch.fstlib import native

        lib = native.get_lib()
        finals = np.full(self._n, np.inf)
        finals[self._final_state] = self._final_w
        weights = self._gc + self._ac
        buf = native._PathBuf()
        c_i32 = ctypes.POINTER(ctypes.c_int32)
        c_f64 = ctypes.POINTER(ctypes.c_double)
        rc = lib.khg_shortest_path(
            self._n,
            self._start,
            finals.ctypes.data_as(c_f64),
            len(self._src),
            self._src.ctypes.data_as(c_i32),
            self._il.ctypes.data_as(c_i32),
            self._ol.ctypes.data_as(c_i32),
            np.ascontiguousarray(weights).ctypes.data_as(c_f64),
            self._dst.ctypes.data_as(c_i32),
            ctypes.byref(buf),
        )
        if rc != 0:
            raise RuntimeError("negative cycle in shortest_path")
        try:
            if not buf.found:
                return None
            tids = (
                np.ctypeslib.as_array(buf.il, shape=(buf.n_il,)).tolist()
                if buf.n_il else []
            )
            words = (
                np.ctypeslib.as_array(buf.ol, shape=(buf.n_ol,)).tolist()
                if buf.n_ol else []
            )
            cost = float(buf.cost)
        finally:
            lib.khg_free_path(ctypes.byref(buf))
        return tids, words, cost


def lattice_decode_native(
    packed: PackedCsrFst,
    loglikes: np.ndarray,  # (T, num_pdfs)
    id2pdf: np.ndarray,
    acoustic_scale: float,
    beam: float,
    max_active: int,
    min_active: int,
    lattice_beam: float,
    prune_interval: int,
    allow_partial: bool,
):
    """Run the native decoder; returns a ``NativeLattice`` (or None)
    plus max_live_links, mirroring LatticeFasterDecoder.decode."""
    from khg_tpu_torch.fstlib import native

    lib = native.get_lib()
    assert lib is not None, "native core unavailable"

    ll = np.ascontiguousarray(loglikes, dtype=np.float32)
    id2pdf = np.ascontiguousarray(id2pdf, dtype=np.int32)
    T, P = ll.shape
    # infinite beams cross the ABI unchanged (C++ doubles carry inf)
    buf = native._LatticeBuf()
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    c_i64 = ctypes.POINTER(ctypes.c_int64)
    c_f32 = ctypes.POINTER(ctypes.c_float)
    c_f64 = ctypes.POINTER(ctypes.c_double)
    rc = lib.khg_lattice_decode(
        packed.num_states,
        packed.start,
        packed.finals.ctypes.data_as(c_f64),
        packed.arc_offsets.ctypes.data_as(c_i64),
        packed.ilabels.ctypes.data_as(c_i32),
        packed.olabels.ctypes.data_as(c_i32),
        packed.weights.ctypes.data_as(c_f64),
        packed.dests.ctypes.data_as(c_i32),
        ll.ctypes.data_as(c_f32),
        T,
        P,
        id2pdf.ctypes.data_as(c_i32),
        float(acoustic_scale),
        float(beam),
        int(min(max_active, 2**31 - 1)),
        int(min_active),
        float(lattice_beam),
        int(prune_interval),
        1 if allow_partial else 0,
        ctypes.byref(buf),
    )
    if rc == 2:
        # np.partition would raise for this max_active/min_active vs the
        # active-token count; mirror the Python path's exception
        raise ValueError(
            "max_active/min_active out of range for the active-token "
            "count (np.partition index semantics)"
        )
    if rc != 0:
        return None, 0
    try:
        n = buf.num_states
        na = buf.num_arcs

        def copy(ptr, count, dtype):
            if count == 0:
                return np.zeros(0, dtype=dtype)
            return np.ctypeslib.as_array(ptr, shape=(count,)).astype(
                dtype, copy=True
            )

        lat = NativeLattice(
            n,
            int(buf.start),
            copy(buf.src, na, np.int32),
            copy(buf.il, na, np.int32),
            copy(buf.ol, na, np.int32),
            copy(buf.gc, na, np.float64),
            copy(buf.ac, na, np.float64),
            copy(buf.dst, na, np.int32),
            copy(buf.key_t, n, np.int32),
            copy(buf.key_s, n, np.int32),
            copy(buf.final_state, buf.num_finals, np.int32),
            copy(buf.final_w, buf.num_finals, np.float64),
            buf.partial,
        )
        max_live = int(buf.max_live_links)
    finally:
        lib.khg_free_lattice(ctypes.byref(buf))
    return lat, max_live
