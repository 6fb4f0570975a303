"""Kaldi-compatible BINARY serialization for model objects.

The reference reads/writes Kaldi's binary stream format through
kaldi-native-io (reference semantics: kaldi-hmm-gmm/csrc/
transition-model.cc:37-116, hmm-topology.cc:186-494 [binary branches],
event-map.cc:116-190, context-dep.cc:45-83, const-integer-set-inl.h:63-65).
This module implements the same wire format in pure Python so khg_tpu_torch
checkpoints interoperate with real Kaldi / reference artifacts:

- a binary file starts with the two-byte marker ``\\x00B``;
- ``WriteToken``: ASCII token + one space (same in text and binary);
- ``WriteBasicType<T>``: one size byte ``sizeof(T)`` then the raw
  little-endian value;
- ``WriteIntegerVector<int32>``: size byte 4, raw int32 count, raw data;
- ``Vector<float>::Write``: token ``FV``, int32 dim, raw float32 data
  (``DV``/float64 accepted on read).

Text-mode counterparts live in :mod:`khg_tpu_torch.model.kaldi_io`; the
``save_*``/``load_*`` helpers here dispatch on the marker so callers can
read either format transparently.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from khg_tpu_torch.model import kaldi_io
from khg_tpu_torch.model.context_dep import ContextDependency
from khg_tpu_torch.model.event_map import (
    ConstantEventMap,
    EventMap,
    SplitEventMap,
    TableEventMap,
)
from khg_tpu_torch.model.topology import HmmState, HmmTopology
from khg_tpu_torch.model.transition_model import TransitionModel

BINARY_MARKER = b"\x00B"


class BinWriter:
    """Kaldi binary-mode output stream (kaldiio::Write* semantics)."""

    def __init__(self) -> None:
        self.buf = bytearray()

    def token(self, tok: str) -> None:
        assert tok and " " not in tok, tok
        self.buf += tok.encode("ascii") + b" "

    def int32(self, v: int) -> None:
        self.buf += b"\x04" + struct.pack("<i", int(v))

    def uint32(self, v: int) -> None:
        self.buf += b"\x04" + struct.pack("<I", int(v))

    def float32(self, v: float) -> None:
        self.buf += b"\x04" + struct.pack("<f", float(v))

    def int_vector(self, vals) -> None:
        vals = [int(x) for x in vals]
        self.buf += b"\x04" + struct.pack("<i", len(vals))
        self.buf += struct.pack(f"<{len(vals)}i", *vals)

    def float_vector(self, v: np.ndarray) -> None:
        v = np.asarray(v, dtype=np.float32).ravel()
        self.token("FV")
        self.int32(v.size)
        self.buf += v.astype("<f4").tobytes()

    def getvalue(self) -> bytes:
        return bytes(self.buf)


class BinReader:
    """Kaldi binary-mode input stream (kaldiio::Read* semantics)."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("Unexpected end of binary stream")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def token(self) -> str:
        end = self.data.find(b" ", self.pos)
        if end < 0:
            raise ValueError("Unterminated token in binary stream")
        tok = self.data[self.pos : end].decode("ascii")
        self.pos = end + 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.token()
        if got != tok:
            raise ValueError(f"Expected token {tok!r}, got {got!r}")

    def peek_char(self) -> str:
        if self.pos >= len(self.data):
            raise ValueError("Peek past end of binary stream")
        return chr(self.data[self.pos])

    def _basic(self, fmt4: str, fmt8: str):
        size = self._take(1)[0]
        if size == 4:
            return struct.unpack(fmt4, self._take(4))[0]
        if size == 8:
            return struct.unpack(fmt8, self._take(8))[0]
        raise ValueError(f"Unsupported basic-type size {size}")

    def int32(self) -> int:
        return int(self._basic("<i", "<q"))

    def uint32(self) -> int:
        return int(self._basic("<I", "<Q"))

    def float32(self) -> float:
        return float(self._basic("<f", "<d"))

    def int_vector(self) -> List[int]:
        size = self._take(1)[0]
        if size != 4:
            raise ValueError(f"Unsupported integer-vector element size {size}")
        (n,) = struct.unpack("<i", self._take(4))
        return list(struct.unpack(f"<{n}i", self._take(4 * n)))

    def float_vector(self) -> np.ndarray:
        tok = self.token()
        if tok == "FV":
            n = self.int32()
            return np.frombuffer(self._take(4 * n), dtype="<f4").astype(np.float32)
        if tok == "DV":
            n = self.int32()
            return np.frombuffer(self._take(8 * n), dtype="<f8").astype(np.float32)
        raise ValueError(f"Expected FV/DV vector header, got {tok!r}")


# ------------------------------------------------------------------ topology


def write_topology(w: BinWriter, topo: HmmTopology) -> None:
    """Binary branch of HmmTopology::Write (hmm-topology.cc:241-280)."""
    is_hmm = topo.is_hmm()
    w.token("<Topology>")
    w.int_vector(topo.phones)
    w.int_vector(topo.phone2idx)
    if not is_hmm:
        w.int32(-1)  # extended-format (SelfLoopPdfClass) signal
    w.int32(len(topo.entries))
    for entry in topo.entries:
        w.int32(len(entry))
        for st in entry:
            w.int32(st.forward_pdf_class)
            if not is_hmm:
                w.int32(st.self_loop_pdf_class)
            w.int32(len(st.transitions))
            for dst, prob in st.transitions:
                w.int32(dst)
                w.float32(prob)
    w.token("</Topology>")


def read_topology(r: BinReader) -> HmmTopology:
    """Binary branch of HmmTopology::Read (hmm-topology.cc:122-160)."""
    r.expect("<Topology>")
    topo = HmmTopology()
    topo.phones = r.int_vector()
    topo.phone2idx = r.int_vector()
    sz = r.int32()
    is_hmm = True
    if sz == -1:
        is_hmm = False
        sz = r.int32()
    for _ in range(sz):
        entry = []
        for _ in range(r.int32()):
            fwd = r.int32()
            slf = fwd if is_hmm else r.int32()
            st = HmmState(fwd, slf)
            for _ in range(r.int32()):
                dst = r.int32()
                prob = r.float32()
                st.transitions.append((dst, prob))
            entry.append(st)
        topo.entries.append(entry)
    r.expect("</Topology>")
    topo.check()
    return topo


# ----------------------------------------------------------------- event map


def write_event_map(w: BinWriter, m: Optional[EventMap]) -> None:
    """EventMap::Write incl. NULL children (event-map.cc:116-190)."""
    if m is None:
        w.token("NULL")
    elif isinstance(m, ConstantEventMap):
        w.token("CE")
        w.int32(m.answer)
    elif isinstance(m, TableEventMap):
        w.token("TE")
        w.int32(m.key)
        w.uint32(len(m.table))
        w.token("(")
        for child in m.table:
            write_event_map(w, child)
        w.token(")")
    elif isinstance(m, SplitEventMap):
        w.token("SE")
        w.int32(m.key)
        w.int_vector(sorted(m.yes_set))  # ConstIntegerSet::Write
        w.token("{")
        write_event_map(w, m.yes)
        write_event_map(w, m.no)
        w.token("}")
    else:
        raise TypeError(type(m))


def read_event_map(r: BinReader) -> Optional[EventMap]:
    c = r.peek_char()
    if c == "N":
        r.expect("NULL")
        return None
    if c == "C":
        r.expect("CE")
        return ConstantEventMap(r.int32())
    if c == "T":
        r.expect("TE")
        key = r.int32()
        size = r.uint32()
        r.expect("(")
        table = {}
        for i in range(size):
            child = read_event_map(r)
            if child is not None:
                table[i] = child
        r.expect(")")
        m = TableEventMap(key, table)
        # preserve the written table size even with trailing NULL children
        if len(m.table) < size:
            m.table.extend([None] * (size - len(m.table)))
        return m
    if c == "S":
        r.expect("SE")
        key = r.int32()
        yes_set = r.int_vector()
        r.expect("{")
        yes = read_event_map(r)
        no = read_event_map(r)
        r.expect("}")
        return SplitEventMap(key, yes_set, yes, no)
    raise ValueError(f"EventMap::Read: unexpected character {c!r}")


# --------------------------------------------------------- context dependency


def write_context_dependency(w: BinWriter, tree: ContextDependency) -> None:
    """ContextDependency::Write (context-dep.cc:45-52)."""
    w.token("ContextDependency")
    w.int32(tree.N)
    w.int32(tree.P)
    w.token("ToPdf")
    write_event_map(w, tree.to_pdf)
    w.token("EndContextDependency")


def read_context_dependency(r: BinReader) -> ContextDependency:
    r.expect("ContextDependency")
    N = r.int32()
    P = r.int32()
    tok = r.token()
    if tok == "ToLength":  # back-compat: old trees carried a second map
        read_event_map(r)  # (context-dep.cc:68-72) — read and discard
        tok = r.token()
    if tok != "ToPdf":
        raise ValueError(f"Expected token 'ToPdf', got {tok!r}")
    to_pdf = read_event_map(r)
    r.expect("EndContextDependency")
    return ContextDependency(N, P, to_pdf)


# ----------------------------------------------------------- transition model


def write_transition_model(w: BinWriter, tm: TransitionModel) -> None:
    """TransitionModel::Write (transition-model.cc:37-82)."""
    is_hmm = tm.is_hmm()
    w.token("<TransitionModel>")
    write_topology(w, tm.topo)
    tag = "Triples" if is_hmm else "Tuples"
    w.token(f"<{tag}>")
    w.int32(len(tm.tuples))
    for phone, hmm_state, fwd, slf in tm.tuples:
        w.int32(phone)
        w.int32(hmm_state)
        w.int32(fwd)
        if not is_hmm:
            w.int32(slf)
    w.token(f"</{tag}>")
    w.token("<LogProbs>")
    w.float_vector(tm.log_probs)
    w.token("</LogProbs>")
    w.token("</TransitionModel>")


def read_transition_model(r: BinReader) -> TransitionModel:
    r.expect("<TransitionModel>")
    topo = read_topology(r)
    tag = r.token()
    if tag not in ("<Triples>", "<Tuples>"):
        raise ValueError(f"Expected <Triples>/<Tuples>, got {tag!r}")
    size = r.int32()
    tuples = []
    for _ in range(size):
        phone = r.int32()
        hmm_state = r.int32()
        fwd = r.int32()
        slf = r.int32() if tag == "<Tuples>" else fwd
        tuples.append((phone, hmm_state, fwd, slf))
    end = r.token()
    if end not in ("</Triples>", "</Tuples>"):
        raise ValueError(f"Expected </Triples>/</Tuples>, got {end!r}")
    r.expect("<LogProbs>")
    log_probs = r.float_vector()
    r.expect("</LogProbs>")
    r.expect("</TransitionModel>")

    tm = TransitionModel()
    tm.topo = topo
    tm.tuples = tuples
    tm._compute_derived()
    tm.log_probs = log_probs
    tm._compute_derived_of_probs()
    tm._check()
    return tm


# ------------------------------------------------------------- file framing


def _to_path(path: Union[str, Path]) -> Path:
    return path if isinstance(path, Path) else Path(path)


def save_transition_model(
    path: Union[str, Path], tm: TransitionModel, binary: bool = True
) -> None:
    """Write a TransitionModel file readable by real Kaldi tooling."""
    path = _to_path(path)
    if binary:
        w = BinWriter()
        write_transition_model(w, tm)
        path.write_bytes(BINARY_MARKER + w.getvalue())
    else:
        path.write_text(kaldi_io.write_transition_model(tm))


def load_transition_model(path: Union[str, Path]) -> TransitionModel:
    """Read a Kaldi TransitionModel file, text or binary (auto-detected)."""
    data = _to_path(path).read_bytes()
    if data.startswith(BINARY_MARKER):
        return read_transition_model(BinReader(data[len(BINARY_MARKER) :]))
    return kaldi_io.read_transition_model(data.decode("utf-8"))


def save_tree(
    path: Union[str, Path], tree: ContextDependency, binary: bool = True
) -> None:
    """Write a decision-tree file readable by real Kaldi tooling."""
    path = _to_path(path)
    if binary:
        w = BinWriter()
        write_context_dependency(w, tree)
        path.write_bytes(BINARY_MARKER + w.getvalue())
    else:
        path.write_text(kaldi_io.write_context_dependency(tree))


def load_tree(path: Union[str, Path]) -> ContextDependency:
    """Read a Kaldi tree file, text or binary (auto-detected)."""
    data = _to_path(path).read_bytes()
    if data.startswith(BINARY_MARKER):
        return read_context_dependency(BinReader(data[len(BINARY_MARKER) :]))
    return kaldi_io.read_context_dependency(data.decode("utf-8"))
