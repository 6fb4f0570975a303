"""Soft EM (Baum-Welch) in the port against khg_tpu on the same inputs:
the soft stats, one accumulate_forward_backward pass, and whole
resident soft-EM passes of EStepPipeline, for the dense ("xla") and the
banded backends; and the port's resident loop against its own per-pass
host loop."""

import copy
import math

import numpy as np
import pytest
import torch

from khg_tpu.est.flags import GMM_ALL
from khg_tpu.est.mle import MleDiagGmmOptions
from khg_tpu.model.transition_model import MleTransitionUpdateConfig
from khg_tpu.recipes.pipeline import EStepPipeline as JPipeline
from khg_tpu.recipes.yesno import make_synthetic_corpus, train_yesno
from khg_tpu.stats.accum import AccumAmDiagGmm as JAccum
from khg_tpu.stats.accum import accumulate_am_stats_soft as j_soft
from khg_tpu_torch.est.mle import mle_am_diag_gmm_update
from khg_tpu_torch.recipes.pipeline import EStepPipeline
from khg_tpu_torch.stats.accum import AccumAmDiagGmm, accumulate_am_stats_soft
from khg_tpu_torch.utils.convert import model_to_torch
from tests.test_align import random_am
from tests.torch_parity import port_copy

KW = dict(acoustic_scale=1.0, self_loop_scale=0.1, batch_size=2)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(29)
    lp, corpus = make_synthetic_corpus(num_utts=7, dim=8, rng=rng)
    result = train_yesno(
        lp, corpus, num_iters=3, total_gauss=22, max_iter_inc=2,
        realign_iters="1 2",
    )
    return corpus, result


def _took_banded(pipe, expect: bool):
    """Whether the port's batches went the banded way (on the CPU the
    kernels' plain versions run, so there are no launches to count)."""
    routes = [v[1] is not None for v in pipe._batch_graph_cache.values()]
    assert routes and all(r == expect for r in routes), routes


def test_accumulate_am_stats_soft_matches_jax():
    """Soft stats (occ, moments, log-like, frames) within 1e-5 relative,
    with frames of zero posterior mass."""
    rng = np.random.default_rng(0)
    am = random_am(6, 5, rng, max_mix=3)
    packed = am.pack(mix_pad_to=4)
    B, T = 3, 11
    feats = rng.standard_normal((B, T, 5)).astype(np.float32)
    gamma = rng.dirichlet(np.ones(6), (B, T)).astype(np.float32)
    gamma[rng.uniform(size=(B, T)) < 0.2] = 0.0
    gamma[gamma < 0.05] = 0.0
    g, m, v = model_to_torch(
        packed.gconsts, packed.means_invvars, packed.inv_vars, device="cpu"
    )
    got = accumulate_am_stats_soft(g, m, v, torch.as_tensor(feats),
                                   torch.as_tensor(gamma))
    ref = j_soft(packed.gconsts, packed.means_invvars, packed.inv_vars,
                 feats, gamma)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "banded"])
def test_accumulate_forward_backward_matches_jax(system, backend):
    """One soft E-step over graphs with the transition probs applied:
    total log Z within 1e-5 relative, accumulators and expected
    transition counts close."""
    corpus, result = system
    tm = result.transition_model
    pipe_j = JPipeline(tm, align_backend=backend, **KW)
    acc_j = JAccum()
    acc_j.init(result.am, flags=GMM_ALL)
    t_j = tm.init_stats()
    lz_j = pipe_j.accumulate_forward_backward(
        result.am, pipe_j.pack_graphs(result.graphs), corpus.feats, acc_j, t_j
    )
    am_t = port_copy(result.am)
    tm_t = port_copy(tm)
    pipe_t = EStepPipeline(tm_t, align_backend=backend, device="cpu", **KW)
    acc_t = AccumAmDiagGmm()
    acc_t.init(am_t, flags=GMM_ALL)
    t_t = tm_t.init_stats()
    lz_t = pipe_t.accumulate_forward_backward(
        am_t, pipe_t.pack_graphs(port_copy(result.graphs)), corpus.feats,
        acc_t, t_t,
    )
    _took_banded(pipe_t, backend == "banded")
    assert math.isclose(lz_t, lz_j, rel_tol=1e-5)
    np.testing.assert_allclose(t_t, t_j, rtol=1e-4, atol=1e-3)
    # summed posterior mass: posteriors near 1 are clamped at 1, so f32
    # noise in alpha + beta - log Z only ever lowers them; the two
    # packages' noise differs at the 1e-5 level (khg_tpu bounds its
    # sharded soft tot_frames at 1e-4 for the same reason)
    assert math.isclose(acc_t.tot_count, acc_j.tot_count, rel_tol=1e-4)
    assert math.isclose(acc_t.tot_log_like, acc_j.tot_log_like, rel_tol=1e-4)
    for p in range(am_t.num_pdfs):
        a, b = acc_t.get_acc(p), acc_j.get_acc(p)
        for x, y in ((a.occupancy, b.occupancy),
                     (a.mean_accumulator, b.mean_accumulator),
                     (a.variance_accumulator, b.variance_accumulator)):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-3)


def _port_resident(result, corpus, backend, passes, opts, tcfg):
    tm_t = port_copy(result.transition_model)
    pipe_t = EStepPipeline(tm_t, align_backend=backend, device="cpu", **KW)
    am_t = port_copy(result.am)
    model_t, rec_t = pipe_t.fb_em_passes_resident(
        pipe_t.pack_model_device(am_t),
        pipe_t.pack_graphs_base(port_copy(result.graphs)), corpus.feats,
        passes, mle_config=port_copy(opts), transition_cfg=port_copy(tcfg),
    )
    _took_banded(pipe_t, backend == "banded")
    pipe_t.apply_model_to_am(model_t, am_t)
    return am_t, tm_t, rec_t


def _assert_models_close(am_a, am_b):
    """khg_tpu's bounds for the resident soft loop against its host loop."""
    for p in range(am_b.num_pdfs):
        ga, gb = am_a.get_pdf(p), am_b.get_pdf(p)
        assert ga.num_gauss == gb.num_gauss, p
        np.testing.assert_allclose(ga.weights, gb.weights, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(ga.means_invvars, gb.means_invvars,
                                   rtol=5e-3, atol=2e-3)


@pytest.mark.parametrize("backend", ["xla", "banded"])
def test_fb_em_passes_resident_matches_jax(system, backend):
    """Three resident soft-EM passes: per-pass log Z sums within 3e-5
    relative, transition log-probs within 3e-4 and final GMMs close
    (khg_tpu's bounds for its resident soft loop against its host
    loop); utterance counts equal."""
    corpus, result = system
    opts, tcfg = MleDiagGmmOptions(), MleTransitionUpdateConfig()
    tm_j = copy.deepcopy(result.transition_model)
    pipe_j = JPipeline(tm_j, align_backend=backend, **KW)
    am_j = result.am.copy()
    model_j, rec_j = pipe_j.fb_em_passes_resident(
        pipe_j.pack_model_device(am_j), pipe_j.pack_graphs_base(result.graphs),
        corpus.feats, 3, mle_config=opts, transition_cfg=tcfg,
    )
    pipe_j.apply_model_to_am(model_j, am_j)
    am_t, tm_t, rec_t = _port_resident(result, corpus, backend, 3, opts, tcfg)
    assert rec_t.shape == rec_j.shape == (3, 8)
    assert int(rec_t[:, 4].sum()) == 0 and (rec_t[:, 5] == 0).all()
    np.testing.assert_allclose(rec_t[:, 2], rec_j[:, 2], rtol=3e-5)
    np.testing.assert_array_equal(rec_t[:, 3:6], rec_j[:, 3:6])
    # the columns summed from posterior mass (tot_log_like, tot_frames,
    # transition objective and count) carry the two packages' different
    # f32 noise (see test_accumulate_forward_backward_matches_jax), which
    # each M-step carries into the next pass: 2e-5 after one pass, up to
    # 3e-4 after three.  khg_tpu's own test leaves them unbounded.
    np.testing.assert_allclose(rec_t[:, [0, 1, 6, 7]], rec_j[:, [0, 1, 6, 7]],
                               rtol=5e-4)
    np.testing.assert_allclose(tm_t.log_probs[1:], tm_j.log_probs[1:],
                               rtol=0, atol=3e-4)
    _assert_models_close(am_t, am_j)


@pytest.mark.parametrize("backend", ["xla", "banded"])
def test_fb_em_passes_resident_matches_per_pass_host_loop(system, backend):
    """N resident soft passes == N x {refresh_transition_costs;
    accumulate_forward_backward; host GMM update; host transition
    update}, in the port alone."""
    corpus, result = system
    opts = port_copy(MleDiagGmmOptions())
    tcfg = port_copy(MleTransitionUpdateConfig())
    passes = 3
    tm_h = port_copy(result.transition_model)
    pipe_h = EStepPipeline(tm_h, align_backend=backend, device="cpu", **KW)
    base_h = pipe_h.pack_graphs_base(port_copy(result.graphs))
    am_h = port_copy(result.am)
    log_zs = []
    for _ in range(passes):
        accs = AccumAmDiagGmm()
        accs.init(am_h, flags=GMM_ALL)
        tacc = tm_h.init_stats()
        log_zs.append(pipe_h.accumulate_forward_backward(
            am_h, pipe_h.refresh_transition_costs(base_h), corpus.feats,
            accs, tacc,
        ))
        mle_am_diag_gmm_update(opts, accs, 0b111, am_h)
        tm_h.mle_update(tacc, tcfg)
    am_d, tm_d, rec = _port_resident(result, corpus, backend, passes, opts, tcfg)
    np.testing.assert_allclose(rec[:, 2], log_zs, rtol=3e-5)
    assert log_zs[-1] > log_zs[0]
    np.testing.assert_allclose(tm_d.log_probs[1:], tm_h.log_probs[1:],
                               rtol=0, atol=3e-4)
    _assert_models_close(am_d, am_h)
