"""Careful alignment (EStepPipeline.pack_graphs(careful=True)) and
viterbi_align_batch's state_pdf in the port against khg_tpu, on the
CPU: the same transition model, graphs and log-likelihoods in both.

Careful graphs concatenate a final-stripped copy of each graph, so a
path that runs past the graph's end and around into the copy can never
end: the batch holds one utterance too short for its graph, which must
fail in both packages.  Packed arrays are compared exactly, Viterbi
costs bitwise, tids and failure flags exactly."""

import copy

import numpy as np
import pytest
import torch

from khg_tpu.align.packed import pack_graph_batch as j_pack_graph_batch
from khg_tpu.align.packed import uniform_dest_pdf as j_uniform_dest_pdf
from khg_tpu.align.viterbi import viterbi_align_batch as j_viterbi
from khg_tpu.gmm.likelihoods import loglikes_np
from khg_tpu.recipes.pipeline import EStepPipeline as JPipeline
from khg_tpu_torch.align.packed import pack_graph_batch, uniform_dest_pdf
from khg_tpu_torch.align.viterbi import viterbi_align_batch
from khg_tpu_torch.recipes.pipeline import EStepPipeline
from khg_tpu_torch.utils.convert import batched_graphs_to_torch
from tests.test_align import random_am
from tests.test_graph_compiler import build_yesno_like
from tests.torch_parity import port_copy

KW = dict(acoustic_scale=0.1, self_loop_scale=0.1, batch_size=4)
WORDS = [["YES"], ["NO", "NO"], ["YES", "NO", "YES"], ["NO", "YES"]]
LENS = [14, 23, 31, 3]  # the last is too short for its graph: it fails
FIELDS = ("in_src", "in_tid", "in_pdf", "in_cost", "out_dst", "out_tid",
          "out_pdf", "out_cost", "init_cost", "final_cost")


@pytest.fixture(scope="module")
def system():
    lp, _topo, tree, tm, gc = build_yesno_like()
    rng = np.random.default_rng(13)
    am = random_am(tree.num_pdfs, 6, rng)
    graphs = [gc.compile_graph_from_text([lp.word2id[w] for w in ws]) for ws in WORDS]
    feats = np.zeros((len(LENS), max(LENS), 6), np.float32)
    for i, n in enumerate(LENS):
        feats[i, :n] = rng.standard_normal((n, 6))
    ll = loglikes_np(am.pack(), feats)
    pipe_j = JPipeline(copy.deepcopy(tm), **KW)
    pipe_t = EStepPipeline(port_copy(tm), device="cpu", **KW)
    return graphs, ll, pipe_j, pipe_t


def _packed(system, careful):
    graphs, _ll, pipe_j, pipe_t = system
    return (pipe_j.pack_graphs(graphs, careful=careful),
            pipe_t.pack_graphs(port_copy(graphs), careful=careful))


@pytest.mark.parametrize("careful", [False, True])
def test_pack_graphs_equal_khg_tpu(system, careful):
    """Every array of every packed graph equal to khg_tpu's; careful
    graphs have twice the plain ones' states, and one more."""
    pj, pt = _packed(system, careful)
    assert len(pj) == len(pt) == len(WORDS)
    for a, b in zip(pj, pt):
        for f in FIELDS:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    if careful:
        plain = _packed(system, False)[1]
        for c, p in zip(pt, plain):
            assert c.in_src.shape[0] == 2 * p.in_src.shape[0] + 1


def _align(system, careful, with_state_pdf):
    _graphs, ll, pipe_j, pipe_t = system
    pj, pt = _packed(system, careful)
    bj = j_pack_graph_batch(pj, states_pad_to=8, indeg_pad_to=2)
    bt = pack_graph_batch(pt, states_pad_to=8, indeg_pad_to=2)
    nf = np.asarray(LENS, np.int32)
    sp_j = j_uniform_dest_pdf(bj) if with_state_pdf else None
    ref = j_viterbi(bj, ll, nf, pipe_j.tm.id2pdf_array(), acoustic_scale=0.1,
                    state_pdf=sp_j)
    sp_t = None
    if with_state_pdf:
        sp_np = uniform_dest_pdf(bt)
        assert sp_np is not None
        np.testing.assert_array_equal(sp_np, sp_j)
        sp_t = torch.as_tensor(sp_np)
    got = viterbi_align_batch(
        batched_graphs_to_torch(bt, "cpu"), torch.as_tensor(np.array(ll)),
        torch.as_tensor(nf), torch.as_tensor(pipe_t.tm.id2pdf_array()),
        acoustic_scale=0.1, state_pdf=sp_t)
    return ref, got


@pytest.mark.parametrize("careful", [False, True])
def test_careful_viterbi_equals_khg_tpu(system, careful):
    """Costs bitwise, tids and failure flags equal; the short utterance
    fails in both, every other one aligns, and careful graphs give the
    plain graphs' costs and alignments."""
    ref, got = _align(system, careful, with_state_pdf=False)
    np.testing.assert_array_equal(got.total_cost.numpy(), np.asarray(ref.total_cost))
    np.testing.assert_array_equal(got.tids.numpy(), np.asarray(ref.tids))
    np.testing.assert_array_equal(got.failed.numpy(), np.asarray(ref.failed))
    assert got.failed.tolist() == [False, False, False, True]
    ok = ~got.failed
    np.testing.assert_allclose(got.acoustic_cost[ok].numpy(),
                               np.asarray(ref.acoustic_cost)[ok.numpy()], rtol=1e-6)
    if careful:
        _r, plain = _align(system, False, with_state_pdf=False)
        np.testing.assert_array_equal(got.total_cost[ok].numpy(),
                                      plain.total_cost[ok].numpy())
        np.testing.assert_array_equal(got.tids[ok].numpy(), plain.tids[ok].numpy())


@pytest.mark.parametrize("careful", [False, True])
def test_state_pdf_equals_khg_tpu(system, careful):
    """state_pdf given: the port equals its own result without it to
    the bit, and khg_tpu's per-state path on every feasible utterance
    (costs bitwise, tids equal), with the same failure flags."""
    ref, got = _align(system, careful, with_state_pdf=True)
    _r, without = _align(system, careful, with_state_pdf=False)
    for f in ("tids", "total_cost", "acoustic_cost", "failed"):
        assert torch.equal(getattr(got, f), getattr(without, f)), f
    np.testing.assert_array_equal(got.failed.numpy(), np.asarray(ref.failed))
    ok = (~got.failed).numpy()
    assert ok.sum() == 3
    np.testing.assert_array_equal(got.total_cost.numpy()[ok], np.asarray(ref.total_cost)[ok])
    np.testing.assert_array_equal(got.tids.numpy()[ok], np.asarray(ref.tids)[ok])
