"""Viterbi alignment in the port against khg_tpu on the same graphs
and loglikes: the banded plain version (what the CUDA kernel computes,
operation for operation) against the Pallas banded kernel in interpret
mode and the banded host reference, its external-acoustic (sac) mode
against the Pallas kernel's, and the eager DP against the XLA scan."""

import numpy as np
import pytest
import torch

from khg_tpu.align.banded import band_renumber, pack_banded, viterbi_banded_host
from khg_tpu.align.packed import uniform_dest_pdf
from khg_tpu.align.pallas_banded import viterbi_align_banded as j_banded
from khg_tpu.align.viterbi import viterbi_align_batch as j_viterbi
from khg_tpu_torch.align.banded_kernel import (
    banded_cuda,
    banded_sac_cuda,
    viterbi_align_banded,
)
from khg_tpu_torch.align.viterbi import viterbi_align_batch
from khg_tpu_torch.utils.convert import banded_to_torch, batched_graphs_to_torch
from tests.test_align import host_viterbi, setup  # noqa: F401
from tests.test_banded import _problem


def _problem_np(setup, lens, words):  # noqa: F811
    """tests/test_banded.py's problem with writable numpy arrays."""
    graphs, arrays, ll, nf, id2pdf = _problem(setup, lens, words)
    return graphs, arrays, np.array(ll), nf, id2pdf


def _banded(setup, lens, words):  # noqa: F811
    graphs, arrays, ll, nf, id2pdf = _problem_np(setup, lens, words)
    ren, _ = band_renumber(arrays)
    banded, offsets = pack_banded(ren, uniform_dest_pdf(ren))
    return graphs, arrays, banded, offsets, ll, nf, id2pdf


def _words(lp, *seqs):
    return [[lp.word2id[w] for w in s] for s in seqs]


@pytest.mark.parametrize("scale", [0.5, 0.1])
def test_banded_plain_matches_pallas_interpret(setup, scale):  # noqa: F811
    """Costs bit-equal and tids equal to the Pallas kernel (interpret
    mode) and to the banded host reference."""
    lp = setup[0]
    words = _words(lp, ["YES"], ["NO", "NO"], ["YES", "NO"])
    lens = [12, 19, 30]
    graphs, arrays, banded, offsets, ll, nf, id2pdf = _banded(setup, lens, words)
    res = viterbi_align_banded(
        banded_to_torch(banded, "cpu"), offsets, torch.as_tensor(ll),
        torch.as_tensor(nf), torch.as_tensor(id2pdf), acoustic_scale=scale,
    )
    ref = j_banded(
        banded, offsets, ll, nf, id2pdf, acoustic_scale=scale,
        block_b=2, time_chunk=16, lane=8, interpret=True,
    )
    assert not res.failed.any()
    np.testing.assert_array_equal(res.total_cost.numpy(), np.asarray(ref.total_cost))
    np.testing.assert_array_equal(res.tids.numpy(), np.asarray(ref.tids))
    np.testing.assert_allclose(
        res.acoustic_cost.numpy(), np.asarray(ref.acoustic_cost),
        rtol=1e-6, atol=1e-5,
    )
    h_tids, h_costs = viterbi_banded_host(banded, offsets, ll, nf, scale)
    np.testing.assert_array_equal(res.tids.numpy(), h_tids)
    np.testing.assert_array_equal(res.total_cost.numpy(), h_costs)
    for i, g in enumerate(graphs):  # the per-arc FST reference agrees too
        host = host_viterbi(g, ll[i, : lens[i]], id2pdf, acoustic_scale=scale)
        assert res.tids.numpy()[i, : lens[i]].tolist() == host[0], i


def test_banded_plain_infeasible_fails(setup):  # noqa: F811
    lp = setup[0]
    _g, _a, banded, offsets, ll, nf, id2pdf = _banded(
        setup, [3], _words(lp, ["YES", "NO"])
    )
    res = viterbi_align_banded(
        banded_to_torch(banded, "cpu"), offsets, torch.as_tensor(ll),
        torch.as_tensor(nf), torch.as_tensor(id2pdf), acoustic_scale=0.5,
    )
    assert bool(res.failed[0])


@pytest.mark.parametrize("uniform", [False, True])
def test_eager_viterbi_matches_jax(setup, uniform):  # noqa: F811
    """The eager DP (per-arc select) against khg_tpu's XLA scan, with and
    without khg_tpu's per-state gather: tids equal, costs within 1e-6
    relative, failures equal (one utterance too short to align)."""
    lp = setup[0]
    words = _words(lp, ["YES"], ["NO", "YES", "NO"], ["YES", "NO"])
    lens = [15, 40, 3]
    _graphs, arrays, ll, nf, id2pdf = _problem_np(setup, lens, words)
    sp = uniform_dest_pdf(arrays) if uniform else None
    if uniform:
        assert sp is not None
    res = viterbi_align_batch(
        batched_graphs_to_torch(arrays, "cpu"), torch.as_tensor(ll),
        torch.as_tensor(nf), torch.as_tensor(id2pdf), acoustic_scale=0.5,
    )
    ref = j_viterbi(arrays, ll, nf, id2pdf, acoustic_scale=0.5, state_pdf=sp)
    np.testing.assert_array_equal(res.failed.numpy(), np.asarray(ref.failed))
    ok = ~res.failed.numpy()
    assert ok.sum() == 2
    np.testing.assert_array_equal(res.tids.numpy()[ok], np.asarray(ref.tids)[ok])
    np.testing.assert_allclose(
        res.total_cost.numpy()[ok], np.asarray(ref.total_cost)[ok], rtol=1e-6
    )
    np.testing.assert_allclose(
        res.acoustic_cost.numpy()[ok], np.asarray(ref.acoustic_cost)[ok],
        rtol=1e-6,
    )


def test_banded_and_eager_agree(setup):  # noqa: F811
    """Both port formulations find the same best-path costs."""
    lp = setup[0]
    words = _words(lp, ["NO"], ["YES", "YES"])
    lens = [14, 27]
    _graphs, arrays, banded, offsets, ll, nf, id2pdf = _banded(setup, lens, words)
    args = (torch.as_tensor(ll), torch.as_tensor(nf), torch.as_tensor(id2pdf))
    b = viterbi_align_banded(banded_to_torch(banded, "cpu"), offsets, *args,
                             acoustic_scale=0.5)
    e = viterbi_align_batch(batched_graphs_to_torch(arrays, "cpu"), *args,
                            acoustic_scale=0.5)
    np.testing.assert_allclose(b.total_cost.numpy(), e.total_cost.numpy(),
                               rtol=1e-6)


def _fused_sac_costs(tables, offsets, sac, nf, scale):
    """banded_plain's total costs with ``best - scale * ac`` rounded
    once (a fused multiply-add, emulated in f64)."""
    pc = tables.plane_cost
    alpha = tables.init_cost.clone()
    nft = torch.as_tensor(nf).long()
    ac = torch.as_tensor(sac).double()
    sc = float(np.float32(scale))
    for t in range(int(nft.max())):
        rolled = torch.stack([torch.roll(alpha, int(d), dims=1) for d in offsets], 1)
        best = torch.min(rolled + pc, dim=1).values
        new = torch.clamp((best.double() - sc * ac[:, t]).float(), max=1e30)
        alpha = torch.where((t < nft)[:, None], new, alpha)
    return torch.min(alpha + tables.final_cost, dim=1).values.numpy()


@pytest.mark.parametrize("scale", [0.5, 0.1])
def test_banded_sac_matches_pallas_interpret(setup, scale):  # noqa: F811
    """External-acoustic mode: a random (B, T, S) per-state lattice in
    place of the loglikes.  Tids equal to the Pallas kernel in interpret
    mode, acoustic cost zeros in both, costs bit-equal where
    scale * ac is exact in f32 (0.5).  At 0.1 XLA's CPU compiler
    contracts the Pallas kernel's ``best - scale * ac`` into one fused
    multiply-add when ac is read straight from the lattice (it does not
    in loglike mode, where ac comes out of a product), so the costs are
    held to one ulp there, and to the bit against the same recursion
    computed with one rounding.  A lattice gathered from the loglikes
    reproduces the loglike mode bit for bit."""
    lp = setup[0]
    words = _words(lp, ["YES"], ["NO", "YES"], ["YES", "NO"])
    lens = [13, 22, 30]
    _g, _a, banded, offsets, ll, nf, id2pdf = _banded(setup, lens, words)
    B, T = ll.shape[:2]
    S = banded.state_pdf.shape[1]
    rng = np.random.default_rng(12)
    sac = (-20.0 + 5.0 * rng.standard_normal((B, T, S))).astype(np.float32)
    tables = banded_to_torch(banded, "cpu")
    res = viterbi_align_banded(
        tables, offsets, None, torch.as_tensor(nf), torch.as_tensor(id2pdf),
        acoustic_scale=scale, sac=torch.as_tensor(sac),
    )
    ref = j_banded(
        banded, offsets, None, nf, id2pdf, acoustic_scale=scale,
        block_b=2, time_chunk=16, lane=8, interpret=True, sac=sac,
    )
    np.testing.assert_array_equal(res.tids.numpy(), np.asarray(ref.tids))
    if scale == 0.5:
        np.testing.assert_array_equal(res.total_cost.numpy(),
                                      np.asarray(ref.total_cost))
    else:
        np.testing.assert_allclose(res.total_cost.numpy(),
                                   np.asarray(ref.total_cost), rtol=2.4e-7)
        np.testing.assert_array_equal(
            _fused_sac_costs(tables, offsets, sac, nf, scale),
            np.asarray(ref.total_cost))
    assert not res.acoustic_cost.any() and not np.asarray(ref.acoustic_cost).any()
    gathered = np.take_along_axis(ll, banded.state_pdf[:, None, :].astype(np.int64)
                                  .repeat(T, 1), axis=2)
    a = viterbi_align_banded(tables, offsets, None, torch.as_tensor(nf),
                             torch.as_tensor(id2pdf), acoustic_scale=scale,
                             sac=torch.as_tensor(gathered))
    b = viterbi_align_banded(tables, offsets, torch.as_tensor(ll),
                             torch.as_tensor(nf), torch.as_tensor(id2pdf),
                             acoustic_scale=scale)
    assert torch.equal(a.total_cost, b.total_cost) and torch.equal(a.tids, b.tids)


def test_banded_cuda_wrapper_rejects_cpu_tensors(setup):  # noqa: F811
    lp = setup[0]
    _g, _a, banded, offsets, ll, nf, _ = _banded(setup, [12], _words(lp, ["YES"]))
    with pytest.raises(ValueError):
        banded_cuda(banded_to_torch(banded, "cpu"), offsets,
                    torch.as_tensor(ll), torch.as_tensor(nf), 0.5)
    with pytest.raises(ValueError):
        banded_sac_cuda(banded_to_torch(banded, "cpu"), offsets,
                        torch.as_tensor(ll), torch.as_tensor(nf), 0.5)
