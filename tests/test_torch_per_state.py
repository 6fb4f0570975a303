"""Per-state scoring in bf16 (component_scores_per_state and
loglikes_per_state with compute_dtype="bfloat16") and the local-state
fold on precomputed scores (accumulate_am_stats_local(state_scores=))
in the port against khg_tpu, on the CPU.

Tolerances.  bf16 scores against khg_tpu's bf16 scores: rtol and atol
1e-5, the f32 per-state test's (tests/test_torch_fold.py).  Both
packages round the same f32 operands to bf16 to nearest even, every
product of two bf16 values is exact in f32, and only the order of the
f32 sums over 2D terms differs.  bf16 against f32: within
BF16_REL * sum_d |x2_d A_d| (+1e-5 of it for the f32 sums) of each
score, since each rounded operand is off by at most 2^-8 of itself
(bf16 keeps 8 significant bits).
The fold on given scores: bit-equal to the fold that scores itself,
and within test_torch_fold.py's 2e-4 of khg_tpu's fold on its own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khg_tpu.gmm.likelihoods import component_scores_per_state as j_scores_ps
from khg_tpu.gmm.likelihoods import loglikes_per_state as j_ll_ps
from khg_tpu.stats.accum import accumulate_am_stats_local as j_local
from khg_tpu_torch.gmm.likelihoods import (
    component_scores_per_state,
    expand_feats,
    loglikes_per_state,
    stack_model,
)
from khg_tpu_torch.stats.accum import accumulate_am_stats_local
from tests.test_pallas_fold import _problem
import tests.torch_parity  # noqa: F401  (two torch threads per worker)

# (1 + 2^-8)^2 - 1: both operands of a product rounded to bf16
BF16_REL = 2.0 ** -7 + 2.0 ** -16

PROBLEMS = {
    "pad2": dict(seed=2, pad_components=2),
    "ragged": dict(seed=4, B=3, T=17, S0=5, K=8, pad_components=1),
    "wide-D16": dict(seed=8, B=2, T=30, D=16, P=64, K=12, S0=9),
}


def score_terms(g, m, v, sp, x):
    """(B, T, S, K) sum over d of |x2_d A_d|, the magnitude of the
    terms each per-state score adds."""
    P, K, D = m.shape
    A, _g = stack_model(g, m, v)
    A_state = A.reshape(P, K, 2 * D)[sp.long()].abs()
    return torch.einsum("btd,bskd->btsk", expand_feats(x).abs(), A_state)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_bf16_per_state_scores_match_jax(name):
    g, m, v, x, _pid, _w, sp = _problem(**PROBLEMS[name])
    tg, tm, tv, tx, tsp = map(torch.as_tensor, (g, m, v, x, sp))
    jg, jm, jv, jx, jsp = map(jnp.asarray, (g, m, v, x, sp))
    got = component_scores_per_state(tg, tm, tv, tsp, tx, compute_dtype="bfloat16")
    ref = np.asarray(j_scores_ps(jg, jm, jv, jsp, jx, compute_dtype="bfloat16"))
    assert got.dtype == torch.float32
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], rtol=1e-5, atol=1e-5)
    got_ll = loglikes_per_state(tg, tm, tv, tsp, tx, compute_dtype="bfloat16")
    ref_ll = np.asarray(j_ll_ps(jg, jm, jv, jsp, jx, compute_dtype="bfloat16"))
    np.testing.assert_allclose(got_ll.numpy(), ref_ll, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_bf16_per_state_scores_against_f32(name):
    """bf16 within its rounding bound of f32, and not equal to it."""
    g, m, v, x, _pid, _w, sp = _problem(**PROBLEMS[name])
    args = list(map(torch.as_tensor, (g, m, v, sp, x)))
    f32 = component_scores_per_state(*args)
    bf16 = component_scores_per_state(*args, compute_dtype="bfloat16")
    fin = torch.isfinite(f32)
    assert torch.equal(fin, torch.isfinite(bf16))
    gap = (bf16 - f32)[fin].abs()
    limit = (BF16_REL + 1e-5) * score_terms(*args)[fin] + 1e-6
    assert bool((gap <= limit).all()), float((gap / limit).max())
    assert float(gap.max()) > 0.0


@pytest.mark.parametrize("name", list(PROBLEMS) + ["frac-weights"])
def test_fold_on_given_state_scores(name):
    """f32 state_scores given: bit-equal to the fold that scores
    itself.  f32 or bf16 scores given: within 2e-4 of khg_tpu's fold
    on its own scores of the same dtype."""
    kw = PROBLEMS.get(name, dict(seed=7, frac_weights=True, pad_components=3))
    args = _problem(**kw)
    g, m, v, x, pid, w, sp = map(torch.as_tensor, args)
    own = accumulate_am_stats_local(g, m, v, x, pid, w, sp)
    for dtype in (None, "bfloat16"):
        scores = component_scores_per_state(g, m, v, sp, x, compute_dtype=dtype)
        got = accumulate_am_stats_local(g, m, v, x, pid, w, sp, state_scores=scores)
        if dtype is None:
            for a, b in zip(got, own):
                assert torch.equal(a, b)
        jargs = list(map(jnp.asarray, args))
        jscores = j_scores_ps(*jargs[:3], jargs[6], jargs[3], compute_dtype=dtype)
        ref = j_local(*jargs, state_scores=jscores)
        for a, b in zip(got[:3], ref[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(float(got[3]), float(ref[3]), rtol=2e-4)
        np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-6)
