"""The port's DOT renderers (khg_tpu_torch/utils/viz.py): the cases of
tests/test_viz_careful.py on the port's copy (the careful-alignment
graph through the port's Viterbi, device="cpu"), and the same DOT
strings as khg_tpu's renderers."""

import numpy as np
import torch

from khg_tpu.model.event_map import K_PDF_CLASS as J_K_PDF_CLASS
from khg_tpu.utils import viz as j_viz
from khg_tpu_torch.align.packed import pack_graph, pack_graph_batch
from khg_tpu_torch.align.viterbi import viterbi_align_batch
from khg_tpu_torch.gmm.likelihoods import loglikes_np
from khg_tpu_torch.graph.h_builder import (
    add_transition_probs,
    modify_graph_for_careful_alignment,
)
from khg_tpu_torch.model.event_map import K_PDF_CLASS
from khg_tpu_torch.utils.convert import batched_graphs_to_torch
from khg_tpu_torch.utils.viz import draw_fst, draw_hmm_topology, draw_tree
from tests.test_align import random_am
from tests.test_graph_compiler import build_yesno_like as j_build_yesno_like
from tests.torch_parity import build_yesno_like, port_copy


def _systems():
    return j_build_yesno_like(), build_yesno_like()


def test_draw_topology_and_tree():
    _ref, (lp, topo, tree, tm, gc) = _systems()
    dot = draw_hmm_topology(topo, lp.get_sil_phone_id())
    assert dot.startswith("digraph")
    assert "doublecircle" in dot
    assert dot.count("->") == sum(
        len(st.transitions)
        for st in topo.topology_for_phone(lp.get_sil_phone_id())
    )
    tree_dot = draw_tree(tree, phone_syms=lp.id2phone)
    assert "pdf 0" in tree_dot and "pdf 10" in tree_dot
    assert "SIL" in tree_dot


def test_draw_fst():
    _ref, (lp, topo, tree, tm, gc) = _systems()
    dot = draw_fst(gc.compile_graph_from_text([lp.word2id["NO"]]), osymbols=lp.id2word)
    assert "digraph" in dot and "NO" in dot


def test_careful_alignment_graph():
    _ref, (lp, topo, tree, tm, gc) = _systems()
    rng = np.random.default_rng(11)
    am = port_copy(random_am(tree.num_pdfs, 6, rng))
    g = gc.compile_graph_from_text([lp.word2id["NO"]]).copy()
    add_transition_probs(tm, g, transition_scale=1.0, self_loop_scale=0.1)
    careful = modify_graph_for_careful_alignment(g)
    id2pdf = tm.id2pdf_array()
    T = 10
    feats = rng.standard_normal((1, T, 6)).astype(np.float32)
    ll = torch.as_tensor(loglikes_np(am.pack(), feats, device="cpu"))
    lens = torch.tensor([T], dtype=torch.int32)
    id2pdf_t = torch.as_tensor(id2pdf.astype(np.int64))
    res = [
        viterbi_align_batch(
            batched_graphs_to_torch(pack_graph_batch([pack_graph(x, id2pdf)]), "cpu"),
            ll, lens, id2pdf_t, acoustic_scale=0.5,
        )
        for x in (g, careful)
    ]
    assert not bool(res[1].failed[0])
    assert res[0].tids[0].tolist() == res[1].tids[0].tolist()


def test_draw_tree_query_highlight():
    _ref, (lp, topo, tree, tm, gc) = _systems()
    phone = lp.get_sil_phone_id()
    want_pdf = tree.compute([phone], 1)
    dot = draw_tree(tree, phone_syms=lp.id2phone, query={0: phone, K_PDF_CLASS: 1})
    red_lines = [ln for ln in dot.splitlines() if 'color="red"' in ln]
    assert red_lines
    red_leaves = [ln for ln in red_lines if "ellipse" in ln]
    assert len(red_leaves) == 1
    assert f"pdf {want_pdf}" in red_leaves[0]
    plain = draw_tree(tree, phone_syms=lp.id2phone)
    assert 'color="red"' not in plain
    assert plain.count("->") == dot.count("->")


def test_dot_strings_equal_khg_tpu():
    (jlp, jtopo, jtree, jtm, jgc), (lp, topo, tree, tm, gc) = _systems()
    sil = lp.get_sil_phone_id()
    for phone in topo.phones:
        assert draw_hmm_topology(topo, phone) == j_viz.draw_hmm_topology(jtopo, phone)
    assert draw_tree(tree, phone_syms=lp.id2phone) == j_viz.draw_tree(
        jtree, phone_syms=jlp.id2phone)
    assert draw_tree(tree, phone_syms=lp.id2phone, query={0: sil, K_PDF_CLASS: 1}) == \
        j_viz.draw_tree(jtree, phone_syms=jlp.id2phone, query={0: sil, J_K_PDF_CLASS: 1})
    words = [lp.word2id["YES"], lp.word2id["NO"]]
    assert draw_fst(gc.compile_graph_from_text(words), osymbols=lp.id2word) == \
        j_viz.draw_fst(jgc.compile_graph_from_text(words), osymbols=jlp.id2word)
