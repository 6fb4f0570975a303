"""The port's dense forward-backward (khg_tpu_torch/align/forward_backward.py)
against khg_tpu's on the same graphs and loglikes: the general per-arc
route, the state_pdf route and the time-chunked route, with variable
lengths and an utterance too short for any complete path."""

import math

import numpy as np
import pytest
import torch

from khg_tpu.align.forward_backward import forward_backward_batch as j_fb
from khg_tpu.align.packed import pack_graph, pack_graph_batch, uniform_dest_pdf
from khg_tpu.gmm.likelihoods import loglikes_np
from khg_tpu_torch.align.forward_backward import forward_backward_batch
from khg_tpu_torch.utils.convert import batched_graphs_to_torch
from tests.test_align import aligned_graph, setup  # noqa: F401
from tests.test_forward_backward import _parallel_eps_fst, host_log_z


def _problem(setup, lens, words, seed):  # noqa: F811
    lp, topo, tree, tm, gc, am, _ = setup
    rng = np.random.default_rng(seed)
    id2pdf = tm.id2pdf_array()
    graphs = [aligned_graph(gc, tm, [lp.word2id[w] for w in ws]) for ws in words]
    packed = [pack_graph(g, id2pdf) for g in graphs]
    feats = np.zeros((len(lens), max(lens), 6), dtype=np.float32)
    for i, t in enumerate(lens):
        feats[i, :t] = rng.standard_normal((t, 6)).astype(np.float32)
    ll = np.array(loglikes_np(am.pack(), feats))
    arrays = pack_graph_batch(packed, states_pad_to=8, indeg_pad_to=2,
                              semiring="log")
    return graphs, arrays, ll, np.array(lens, np.int32), tm


def _port(arrays, ll, nf, tm, scale, sp=None, chunk=None):
    return forward_backward_batch(
        batched_graphs_to_torch(arrays, "cpu"), torch.as_tensor(ll),
        torch.as_tensor(nf), tm.num_transition_ids, acoustic_scale=scale,
        state_pdf=None if sp is None else torch.as_tensor(sp),
        time_chunk=chunk,
    )


def _assert_fb_close(got, ref):
    """log Z rtol 1e-5, gamma atol 1e-4, tid counts atol 1e-3 (the
    bounds of khg_tpu's own banded-vs-dense FB test); failures equal.
    Posteriors of failed utterances are meaningless: compared where a
    complete path exists."""
    failed = np.asarray(ref.failed)
    np.testing.assert_array_equal(got.failed.numpy(), failed)
    np.testing.assert_allclose(got.log_z.numpy(), np.asarray(ref.log_z), rtol=1e-5)
    ok = ~failed
    np.testing.assert_allclose(got.gamma.numpy()[ok], np.asarray(ref.gamma)[ok],
                               atol=1e-4)
    np.testing.assert_allclose(got.tid_counts.numpy()[ok],
                               np.asarray(ref.tid_counts)[ok], atol=1e-3)
    assert got.tid_counts.numpy()[:, 0].max() == 0.0


@pytest.mark.parametrize("route", ["general", "state_pdf", "time_chunk"])
def test_forward_backward_matches_jax(setup, route):  # noqa: F811
    """Variable lengths, padding frames, and one utterance of 3 frames
    that no complete path of "YES NO" fits."""
    words = [["YES"], ["NO", "YES"], ["YES", "NO"], ["NO"]]
    lens = [9, 22, 3, 16]
    graphs, arrays, ll, nf, tm = _problem(setup, lens, words, seed=3)
    sp = None if route == "general" else uniform_dest_pdf(arrays)
    chunk = 5 if route == "time_chunk" else None
    got = _port(arrays, ll, nf, tm, 0.7, sp, chunk)
    ref = j_fb(arrays, ll, nf, tm.num_transition_ids, acoustic_scale=0.7,
               state_pdf=sp, time_chunk=chunk)
    assert got.failed.tolist() == [False, False, True, False]
    _assert_fb_close(got, ref)
    g = got.gamma.numpy()
    for i, t in enumerate(lens):
        if i != 2:
            np.testing.assert_allclose(g[i, :t].sum(1), 1.0, rtol=1e-4)
        assert (g[i, t:] == 0).all()  # padding frames carry no mass
    id2pdf = tm.id2pdf_array()
    for i in (0, 1, 3):  # against a brute-force sum over FST paths
        want = host_log_z(graphs[i], ll[i, : lens[i]], id2pdf, acoustic_scale=0.7)
        assert math.isclose(float(got.log_z[i]), want, rel_tol=1e-5)


@pytest.mark.parametrize("chunk", [1, 4, 7, 64])
def test_time_chunk_is_bit_identical(setup, chunk):  # noqa: F811
    """Recomputing each chunk's alphas repeats the same operations: the
    checkpointed memory plan gives the unchunked results bit for bit."""
    words = [["YES", "NO"], ["NO"]]
    _g, arrays, ll, nf, tm = _problem(setup, [21, 13], words, seed=5)
    sp = uniform_dest_pdf(arrays)
    base = _port(arrays, ll, nf, tm, 0.6, sp)
    chk = _port(arrays, ll, nf, tm, 0.6, sp, chunk)
    for a, b in zip(base, chk):
        assert torch.equal(a, b)


def test_general_and_state_pdf_routes_agree(setup):  # noqa: F811
    """Same math, different association (khg_tpu's bounds)."""
    words = [["YES", "NO"], ["NO"]]
    _g, arrays, ll, nf, tm = _problem(setup, [18, 11], words, seed=7)
    a = _port(arrays, ll, nf, tm, 0.7)
    b = _port(arrays, ll, nf, tm, 0.7, uniform_dest_pdf(arrays))
    np.testing.assert_allclose(b.log_z.numpy(), a.log_z.numpy(), rtol=1e-6)
    np.testing.assert_allclose(b.gamma.numpy(), a.gamma.numpy(), atol=5e-5)
    np.testing.assert_allclose(b.tid_counts.numpy(), a.tid_counts.numpy(),
                               atol=1e-4)


def test_log_semiring_pack_matches_brute_force():
    """Parallel epsilon paths: the log-semiring pack sums their mass, as
    a brute-force sum over paths does (and as khg_tpu does)."""
    from khg_tpu_torch.align.packed import pack_graph as t_pack_graph
    from khg_tpu_torch.align.packed import pack_graph_batch as t_pack_batch
    from tests.torch_parity import port_copy

    fst = _parallel_eps_fst()
    id2pdf = np.array([0, 0, 1], dtype=np.int32)
    ll = np.random.default_rng(0).standard_normal((1, 7, 2)).astype(np.float32)
    lens = np.array([7], np.int32)
    want = host_log_z(fst, ll[0], id2pdf, acoustic_scale=0.9)
    graphs = t_pack_batch([t_pack_graph(port_copy(fst), id2pdf)], semiring="log")
    got = forward_backward_batch(
        batched_graphs_to_torch(graphs, "cpu"), torch.as_tensor(ll),
        torch.as_tensor(lens), 2, acoustic_scale=0.9,
    )
    assert math.isclose(float(got.log_z[0]), want, rel_tol=1e-5)
    ref = j_fb(pack_graph_batch([pack_graph(fst, id2pdf)], semiring="log"),
               ll, lens, 2, acoustic_scale=0.9)
    _assert_fb_close(got, ref)
