"""The wide-model stats fold in the port against khg_tpu on the same
numpy inputs: accumulate_am_stats_local (the plain version of the stats
fold kernel, stats/fold_kernel.py) against khg_tpu's local-state fold
and its Pallas fold kernel in interpret mode, per-state scoring against
khg_tpu's, and the per-frame gather branch of accumulate_am_stats
against its all-scores branch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khg_tpu.gmm.likelihoods import component_scores_per_state as j_scores_ps
from khg_tpu.gmm.likelihoods import loglikes_per_state as j_ll_ps
from khg_tpu.stats.accum import accumulate_am_stats_local as j_local
from khg_tpu.stats.pallas_fold import accumulate_am_stats_fold_pallas
from khg_tpu_torch.gmm.likelihoods import (
    component_scores_per_state,
    loglikes_per_state,
)
from khg_tpu_torch.stats import accum
from khg_tpu_torch.stats.accum import accumulate_am_stats, accumulate_am_stats_local
from khg_tpu_torch.stats.fold_kernel import (
    accumulate_am_stats_fold,
    fold_cuda,
    fold_kernel_fits,
)
from tests.test_pallas_fold import _problem
import tests.torch_parity  # noqa: F401  (two torch threads per worker)

PROBLEMS = {
    "seed0": dict(seed=0),
    "seed1": dict(seed=1),
    "frac-weights-pad3": dict(seed=7, frac_weights=True, pad_components=3),
    "ragged": dict(seed=3, B=3, T=17, S0=5, K=8),
    "wide-P257-K32": dict(seed=11, B=4, T=40, D=16, P=257, K=32, S0=24),
}


def _assert_close(got, ref, tol=2e-4):
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(got[3]), float(ref[3]), rtol=tol)
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-6)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_local_fold_matches_jax_and_pallas_interpret(name):
    """occ, moments and tot_log_like within 2e-4, tot_frames within
    1e-6, against khg_tpu's local fold and its Pallas fold kernel."""
    args = _problem(**PROBLEMS[name])
    got = accumulate_am_stats_local(*map(torch.as_tensor, args))
    ref = j_local(*map(jnp.asarray, args))
    pal = accumulate_am_stats_fold_pallas(*map(jnp.asarray, args), interpret=True)
    _assert_close(got, ref)
    _assert_close(got, pal)


def test_local_fold_padding_components_get_zero_occupancy():
    args = _problem(7, frac_weights=True, pad_components=3)
    got = accumulate_am_stats_fold(*map(torch.as_tensor, args))
    assert float(got.occ[:, -3:].abs().max()) == 0.0
    assert torch.isfinite(got.mean_acc).all() and torch.isfinite(got.var_acc).all()


def test_local_fold_drops_frames_of_absent_pdfs():
    """A w>0 frame whose pdf is not among its utterance's states drops
    out of every output, as in khg_tpu."""
    g, m, v, x, pid, w, sp = _problem(5)
    pid = pid.copy()
    pid[0, :4] = (sp[0].max() + 1) % g.shape[0]
    while np.isin(pid[0, 0], sp[0]):
        pid[0, :4] = (pid[0, 0] + 1) % g.shape[0]
    w = w.copy()
    w[0, :4] = 1.0
    args = (g, m, v, x, pid, w, sp)
    got = accumulate_am_stats_local(*map(torch.as_tensor, args))
    _assert_close(got, j_local(*map(jnp.asarray, args)))
    assert float(got.tot_frames) == float(w.sum() - 4.0)
    np.testing.assert_allclose(float(got.occ.sum()), float(got.tot_frames), rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(seed=2, pad_components=2),
                                dict(seed=4, B=3, T=17, S0=5, K=8,
                                     pad_components=1)])
def test_per_state_scores_match_jax(kw):
    """(B, T, S, K) scores and (B, T, S) loglikes within 1e-5 relative;
    padding components score -inf in both."""
    g, m, v, x, _pid, _w, sp = _problem(**kw)
    tg, tm, tv, tx, tsp = map(torch.as_tensor, (g, m, v, x, sp))
    jg, jm, jv, jx, jsp = map(jnp.asarray, (g, m, v, x, sp))
    got = component_scores_per_state(tg, tm, tv, tsp, tx)
    ref = np.asarray(j_scores_ps(jg, jm, jv, jsp, jx))
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got.numpy()))
    assert (~fin).any()
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], rtol=1e-5, atol=1e-5)
    got_ll = loglikes_per_state(tg, tm, tv, tsp, tx)
    ref_ll = np.asarray(j_ll_ps(jg, jm, jv, jsp, jx))
    np.testing.assert_allclose(got_ll.numpy(), ref_ll, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("frac", [False, True])
def test_gather_branch_matches_all_scores_branch(monkeypatch, frac):
    """Above the score-size limit accumulate_am_stats gathers each
    frame's pdf rows; it agrees with the all-scores branch within 1e-5."""
    args = list(map(torch.as_tensor, _problem(9, frac_weights=frac,
                                              pad_components=2)[:6]))
    ref = accumulate_am_stats(*args)
    monkeypatch.setattr(accum, "_SCORES_ALL_MAX_BYTES", 0)
    got = accumulate_am_stats(*args)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_fold_kernel_wrapper_on_cpu():
    """On CPU tensors the fold runs its plain version; the kernel's
    wrapper refuses CPU tensors; the kernels take every K (up to D =
    19,359)."""
    args = list(map(torch.as_tensor, _problem(6)))
    got = accumulate_am_stats_fold(*args)
    ref = accumulate_am_stats_local(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        fold_cuda(*args)
    assert fold_kernel_fits(32, 80) and fold_kernel_fits(64, 400)
    assert fold_kernel_fits(359, 80) and fold_kernel_fits(100_000, 80)
    assert fold_kernel_fits(8, 19359) and not fold_kernel_fits(8, 19360)
