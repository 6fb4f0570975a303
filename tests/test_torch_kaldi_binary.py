"""The port's Kaldi binary wire format (khg_tpu_torch/model/kaldi_binary.py):
the cases of tests/test_kaldi_binary.py on the port's copy, and its
writer against khg_tpu's writer and the reference's own files
(tests/golden/{topo,tree,trans}.bin, written by the reference's Write()
methods), byte for byte."""

import struct
from pathlib import Path

import numpy as np
import pytest

from khg_tpu.model import kaldi_binary as j_kb
from khg_tpu_torch.model import kaldi_binary as t_kb
from khg_tpu_torch.model.context_dep import monophone_context_dependency
from khg_tpu_torch.model.event_map import (
    ConstantEventMap,
    SplitEventMap,
    TableEventMap,
)
from khg_tpu_torch.model.topology import HmmState, HmmTopology
from khg_tpu_torch.model.transition_model import TransitionModel
from tests.test_transition_model import build_tm as j_build_tm
from tests.torch_parity import port_copy, reference_copy

GOLD = Path(__file__).parent / "golden"


def build_tm():
    return port_copy(j_build_tm())


def test_primitive_wire_layout():
    w = t_kb.BinWriter()
    w.token("<Tok>")
    w.int32(7)
    w.float32(1.5)
    w.int_vector([1, 2, 3])
    w.float_vector(np.array([0.5, -2.0]))
    data = w.getvalue()
    expected = (
        b"<Tok> "
        + b"\x04" + struct.pack("<i", 7)
        + b"\x04" + struct.pack("<f", 1.5)
        + b"\x04" + struct.pack("<i", 3) + struct.pack("<3i", 1, 2, 3)
        + b"FV " + b"\x04" + struct.pack("<i", 2) + struct.pack("<2f", 0.5, -2.0)
    )
    assert data == expected

    r = t_kb.BinReader(data)
    assert r.token() == "<Tok>"
    assert r.int32() == 7
    assert r.float32() == 1.5
    assert r.int_vector() == [1, 2, 3]
    np.testing.assert_array_equal(r.float_vector(), [0.5, -2.0])


def test_double_vector_read():
    data = b"DV " + b"\x04" + struct.pack("<i", 2) + struct.pack("<2d", 1.25, -3.5)
    v = t_kb.BinReader(data).float_vector()
    assert v.dtype == np.float32
    np.testing.assert_array_equal(v, [1.25, -3.5])


def test_topology_binary_round_trip():
    topo, tree, tm = build_tm()
    w = t_kb.BinWriter()
    t_kb.write_topology(w, topo)
    assert t_kb.read_topology(t_kb.BinReader(w.getvalue())) == topo


def test_topology_binary_non_hmm():
    topo = HmmTopology()
    topo.phones = [1]
    topo.phone2idx = [-1, 0]
    s0 = HmmState(0, 1)
    s0.transitions = [(0, 0.5), (1, 0.5)]
    topo.entries = [[s0, HmmState()]]
    assert not topo.is_hmm()
    w = t_kb.BinWriter()
    t_kb.write_topology(w, topo)
    topo2 = t_kb.read_topology(t_kb.BinReader(w.getvalue()))
    assert topo2 == topo
    assert not topo2.is_hmm()


def test_event_map_binary_round_trip():
    inner = SplitEventMap(0, [1, 3, 5], ConstantEventMap(2), ConstantEventMap(3))
    m = TableEventMap(-1, {0: ConstantEventMap(1), 2: inner})
    assert m.table[1] is None
    w = t_kb.BinWriter()
    t_kb.write_event_map(w, m)
    m2 = t_kb.read_event_map(t_kb.BinReader(w.getvalue()))
    assert isinstance(m2, TableEventMap)
    assert len(m2.table) == len(m.table)
    assert m2.table[1] is None
    assert m2.table[0].answer == 1
    assert isinstance(m2.table[2], SplitEventMap)
    assert sorted(m2.table[2].yes_set) == [1, 3, 5]
    assert m2.table[2].yes.answer == 2
    assert m2.table[2].no.answer == 3


def test_context_dependency_binary_round_trip():
    topo, tree, tm = build_tm()
    w = t_kb.BinWriter()
    t_kb.write_context_dependency(w, tree)
    tree2 = t_kb.read_context_dependency(t_kb.BinReader(w.getvalue()))
    assert tree2.N == tree.N and tree2.P == tree.P
    assert tree2.num_pdfs == tree.num_pdfs
    for phone in topo.phones:
        for pc in range(topo.num_pdf_classes(phone)):
            assert tree2.compute([phone], pc) == tree.compute([phone], pc)


def test_transition_model_binary_round_trip():
    topo, tree, tm = build_tm()
    w = t_kb.BinWriter()
    t_kb.write_transition_model(w, tm)
    tm2 = t_kb.read_transition_model(t_kb.BinReader(w.getvalue()))
    assert tm2.tuples == tm.tuples
    assert tm2.num_transition_ids == tm.num_transition_ids
    np.testing.assert_array_equal(tm2.log_probs, tm.log_probs)
    np.testing.assert_allclose(
        tm2.non_self_loop_log_probs, tm.non_self_loop_log_probs, rtol=1e-5
    )


def test_file_save_load_autodetect(tmp_path):
    topo, tree, tm = build_tm()
    pb = tmp_path / "final.mdl"
    t_kb.save_transition_model(pb, tm, binary=True)
    assert pb.read_bytes().startswith(t_kb.BINARY_MARKER)
    tm_b = t_kb.load_transition_model(pb)
    assert tm_b.tuples == tm.tuples
    pt = tmp_path / "final_text.mdl"
    t_kb.save_transition_model(pt, tm, binary=False)
    assert not pt.read_bytes().startswith(t_kb.BINARY_MARKER)
    tm_t = t_kb.load_transition_model(pt)
    assert tm_t.tuples == tm.tuples
    np.testing.assert_allclose(tm_t.log_probs, tm_b.log_probs, rtol=1e-6)
    tb = tmp_path / "tree"
    t_kb.save_tree(tb, tree, binary=True)
    assert t_kb.load_tree(tb).num_pdfs == tree.num_pdfs
    tt = tmp_path / "tree_text"
    t_kb.save_tree(tt, tree, binary=False)
    assert t_kb.load_tree(tt).num_pdfs == tree.num_pdfs


def _golden_system():
    topo = HmmTopology().read((GOLD / "inputs" / "topo.txt").read_text())
    tree = monophone_context_dependency(
        topo.phones, topo.get_phone_to_num_pdf_classes()
    )
    return topo, tree, TransitionModel(ctx_dep=tree, hmm_topo=topo)


_WRITERS = {
    "topo": ("write_topology", 0),
    "tree": ("write_context_dependency", 1),
    "trans": ("write_transition_model", 2),
}


@pytest.mark.parametrize("name", sorted(_WRITERS))
def test_writer_bytes_equal_khg_tpu_and_reference_files(name):
    """The port writes the reference's file byte for byte, and the same
    bytes as khg_tpu's writer on the same object."""
    fn, which = _WRITERS[name]
    obj = _golden_system()[which]
    w = t_kb.BinWriter()
    getattr(t_kb, fn)(w, obj)
    ours = t_kb.BINARY_MARKER + w.getvalue()
    wj = j_kb.BinWriter()
    getattr(j_kb, fn)(wj, reference_copy(obj))
    assert ours == j_kb.BINARY_MARKER + wj.getvalue()
    assert ours == (GOLD / f"{name}.bin").read_bytes()


def test_reads_reference_binary_files():
    topo, tree, tm = _golden_system()
    data = (GOLD / "topo.bin").read_bytes()
    t_bin = t_kb.read_topology(t_kb.BinReader(data[len(t_kb.BINARY_MARKER):]))
    assert t_bin.phones == topo.phones and t_bin.entries == topo.entries
    t_tree = t_kb.load_tree(GOLD / "tree.bin")
    for phone in topo.phones:
        for pc in range(topo.num_pdf_classes(phone)):
            assert t_tree.compute([phone], pc) == tree.compute([phone], pc)
    t_tm = t_kb.load_transition_model(GOLD / "trans.bin")
    assert t_tm.tuples == tm.tuples
    np.testing.assert_allclose(t_tm.log_probs, tm.log_probs, rtol=1e-6, atol=1e-6)
