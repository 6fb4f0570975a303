"""The port's E-step and M-step pieces against khg_tpu on the same
inputs: hard stats (segment sums against one-hot GEMMs), the dense
M-step, the device transition update and cost deltas, the compensated
carry, and whole resident EM passes of EStepPipeline."""

import copy
import math

import numpy as np
import pytest
import torch

from khg_tpu.est.flags import GMM_ALL
from khg_tpu.est.mle import MleDiagGmmOptions
from khg_tpu.fstlib.fst import equal_align
from khg_tpu.model.transition_device import (
    build_transition_struct as j_struct,
    transition_cost_deltas_device as j_deltas,
    transition_mle_update_device as j_tupdate,
)
from khg_tpu.model.transition_model import MleTransitionUpdateConfig
from khg_tpu.parallel.mesh import _dense_mstep as j_mstep
from khg_tpu.recipes.pipeline import EStepPipeline as JPipeline
from khg_tpu.recipes.yesno import make_synthetic_corpus, train_yesno
from khg_tpu.stats.accum import AccumAmDiagGmm as JAccum
from khg_tpu.stats.accum import accumulate_am_stats as j_stats
from khg_tpu.stats.accum import accumulate_transition_stats as j_tstats
from khg_tpu_torch.model.transition_device import (
    build_transition_struct,
    transition_cost_deltas_device,
    transition_mle_update_device,
)
from khg_tpu_torch.parallel.mesh import _dense_mstep, _mstep_kwargs
from khg_tpu_torch.recipes import pipeline as port_pipeline
from khg_tpu_torch.recipes.pipeline import EStepPipeline, _kahan_add
from khg_tpu_torch.stats.accum import AccumAmDiagGmm
from khg_tpu_torch.stats.accum import (
    accumulate_am_stats,
    accumulate_transition_stats,
    segment_sum,
)
from khg_tpu_torch.utils.convert import model_to_torch
from tests.test_align import random_am
from tests.test_transition_device import _rand_counts, build_tm
from tests.torch_parity import port_copy


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(11)
    lp, corpus = make_synthetic_corpus(num_utts=7, dim=8, rng=rng)
    result = train_yesno(
        lp, corpus, num_iters=3, total_gauss=22, max_iter_inc=2,
        realign_iters="1 2",
    )
    return corpus, result


def _stats_problem(seed):
    rng = np.random.default_rng(seed)
    am = random_am(6, 5, rng, max_mix=3)
    packed = am.pack(mix_pad_to=4)
    B, T = 3, 11
    feats = rng.standard_normal((B, T, 5)).astype(np.float32)
    pdf_ids = rng.integers(0, 6, (B, T)).astype(np.int32)
    w = (rng.uniform(size=(B, T)) > 0.2).astype(np.float32)
    return packed, feats, pdf_ids, w


def test_accumulate_am_stats_matches_jax():
    """Hard stats (occ, moments, log-like, frames) within 1e-5 relative."""
    packed, feats, pdf_ids, w = _stats_problem(0)
    g, m, v = model_to_torch(
        packed.gconsts, packed.means_invvars, packed.inv_vars, device="cpu"
    )
    got = accumulate_am_stats(
        g, m, v, torch.as_tensor(feats), torch.as_tensor(pdf_ids),
        torch.as_tensor(w),
    )
    ref = j_stats(packed.gconsts, packed.means_invvars, packed.inv_vars,
                  feats, pdf_ids, w)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", [(), (3,), (4, 5)])
def test_sorted_segment_sum_equals_serial_index_add(shape):
    """The stats' sorted segment sum adds in the same order as the
    CPU's serial index_add_: bit-equal, empty segments included."""
    rng = np.random.default_rng(6)
    index = torch.as_tensor(rng.integers(0, 9, 500))
    index[index == 4] = 5  # segment 4 stays empty
    src = torch.as_tensor((100 * rng.standard_normal((500,) + shape)).astype(np.float32))
    ref = torch.zeros((11,) + shape).index_add_(0, index, src)
    got = segment_sum(src, index, 11)
    assert got.shape == ref.shape
    assert torch.equal(got, ref)


def test_accumulate_transition_stats_matches_jax():
    rng = np.random.default_rng(1)
    tids = rng.integers(0, 30, (4, 9)).astype(np.int32)
    nf = np.array([9, 0, 4, 7], np.int32)
    got = accumulate_transition_stats(torch.as_tensor(tids),
                                      torch.as_tensor(nf), 29)
    np.testing.assert_array_equal(got.numpy(), j_tstats(tids, nf, 29))


@pytest.mark.parametrize("remove", [True, False])
@pytest.mark.parametrize("floor_vec", [False, True])
def test_dense_mstep_matches_jax(remove, floor_vec):
    """Closed-form M-step within 1e-5 relative, with starved
    components (removed or kept) and a variance floor vector."""
    packed, feats, pdf_ids, w = _stats_problem(2)
    s = j_stats(packed.gconsts, packed.means_invvars, packed.inv_vars,
                feats, pdf_ids, w)
    rng = np.random.default_rng(3)
    P, K = packed.gconsts.shape
    weights = np.where(np.isfinite(packed.gconsts),
                       rng.uniform(0.1, 1.0, (P, K)), 0.0).astype(np.float32)
    opts = MleDiagGmmOptions(
        min_gaussian_occupancy=0.5, remove_low_count_gaussians=remove
    )
    if floor_vec:
        opts.variance_floor_vector = np.full(5, 0.05, np.float32)
    kw = _mstep_kwargs(opts)
    args = [np.asarray(x) for x in (s.occ, s.mean_acc, s.var_acc)] + [
        packed.gconsts, packed.means_invvars, packed.inv_vars, weights
    ]
    ref = j_mstep(*args, **kw)
    got = _dense_mstep(*[torch.as_tensor(np.array(a)) for a in args], **kw)
    for a, b in zip(got, ref):
        a, b = a.numpy(), np.asarray(b)
        assert np.array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sparse", [False, True])
def test_transition_update_and_deltas_match_jax(sparse):
    """Device transition update (log-probs, objective, count) and cost
    deltas (split and equal scales) within 1e-5 relative."""
    import jax.numpy as jnp

    tm = build_tm()
    rng = np.random.default_rng(4)
    counts = _rand_counts(tm, rng, sparse=sparse)
    logp = np.asarray(tm.log_probs, np.float32)
    ref = j_tupdate(jnp.asarray(counts), jnp.asarray(logp), j_struct(tm),
                    floor=0.01, mincount=5.0)
    struct = build_transition_struct(port_copy(tm))
    got = transition_mle_update_device(
        torch.as_tensor(counts), torch.as_tensor(logp), struct,
        floor=0.01, mincount=5.0,
    )
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for ts, sls in ((1.0, 0.1), (1.0, 1.0)):
        d_ref = j_deltas(ref[0], j_struct(tm), ts, sls)
        d_got = transition_cost_deltas_device(got[0], struct, ts, sls)
        np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref),
                                   rtol=1e-5, atol=1e-6)


def test_kahan_carry_precision_many_folds():
    """The compensated f32 carry stays within one ULP of the exact sum
    where a naive sequential f32 sum drifts by more than 100."""
    rng = np.random.default_rng(0)
    xs = (3e4 + rng.standard_normal(16384) * 10).astype(np.float32)
    c = torch.zeros(1)
    comp = torch.zeros(1)
    for v in torch.as_tensor(xs):
        c, comp = _kahan_add(c, comp, v[None])
    exact = float(np.sum(xs.astype(np.float64)))
    naive = np.float32(0)
    for v in xs:
        naive = np.float32(naive + v)
    assert abs(float(naive) - exact) > 100.0
    assert abs(float(c[0]) - exact) <= float(np.spacing(np.float32(exact)))


@pytest.mark.parametrize(
    "align,like",
    [("banded", "xla"), ("xla", "xla"), ("banded", "pallas")],
)
def test_em_passes_resident_matches_jax(system, align, like):
    """Three fully resident passes: per-pass records within 2e-5
    relative, final transition log-probs within 1e-5, final GMMs and
    occupancies close.  The port's "pallas" backend (the fused
    kernel's plain version on the CPU) is held to khg_tpu's "xla"
    backend, whose Pallas kernel has no CPU mode inside the pipeline."""
    corpus, result = system
    opts, tcfg = MleDiagGmmOptions(), MleTransitionUpdateConfig()
    kw = dict(acoustic_scale=1.0, self_loop_scale=0.1, batch_size=2,
              align_backend=align)

    tm_j = copy.deepcopy(result.transition_model)
    pipe_j = JPipeline(tm_j, **kw)
    am_j = result.am.copy()
    model_j, rec_j, occ_j = pipe_j.em_passes_resident(
        pipe_j.pack_model_device(am_j), pipe_j.pack_graphs_base(result.graphs),
        corpus.feats, 3, mle_config=opts, transition_cfg=tcfg,
        return_occ=True,
    )
    pipe_j.apply_model_to_am(model_j, am_j)

    tm_t = port_copy(result.transition_model)
    pipe_t = EStepPipeline(tm_t, likelihood_backend=like, device="cpu", **kw)
    am_t = port_copy(result.am)
    model_t, rec_t, occ_t = pipe_t.em_passes_resident(
        pipe_t.pack_model_device(am_t),
        pipe_t.pack_graphs_base(port_copy(result.graphs)),
        corpus.feats, 3, mle_config=port_copy(opts),
        transition_cfg=port_copy(tcfg), return_occ=True,
    )
    pipe_t.apply_model_to_am(model_t, am_t)

    assert rec_t.shape == rec_j.shape == (3, 8)
    np.testing.assert_allclose(rec_t, rec_j, rtol=2e-5, atol=1e-3)
    np.testing.assert_allclose(tm_t.log_probs[1:], tm_j.log_probs[1:],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(occ_t, occ_j, rtol=2e-5, atol=1e-3)
    for p in range(am_j.num_pdfs):
        gj, gt = am_j.get_pdf(p), am_t.get_pdf(p)
        assert gj.num_gauss == gt.num_gauss, p
        np.testing.assert_allclose(gt.weights, gj.weights, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(gt.means_invvars, gj.means_invvars,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gt.inv_vars, gj.inv_vars, rtol=1e-4,
                                   atol=1e-4)


def test_accumulate_from_alignments_matches_jax(system):
    """Equal-align stats (pass 0 of corpus training): GMM accumulators
    within 2e-5 relative, transition stats exact."""
    corpus, result = system
    rng = np.random.default_rng(5)
    alis = [equal_align(g, f.shape[0], rng)[0]
            for g, f in zip(result.graphs, corpus.feats)]
    kw = dict(acoustic_scale=1.0, self_loop_scale=0.1, batch_size=3)
    pipe_j = JPipeline(result.transition_model, **kw)
    acc_j = JAccum()
    acc_j.init(result.am, flags=GMM_ALL)
    t_j = result.transition_model.init_stats()
    tot_j = pipe_j.accumulate_from_alignments(result.am, corpus.feats, alis,
                                              acc_j, t_j)
    am_t = port_copy(result.am)
    tm_t = port_copy(result.transition_model)
    pipe_t = EStepPipeline(tm_t, device="cpu", **kw)
    acc_t = AccumAmDiagGmm()
    acc_t.init(am_t, flags=GMM_ALL)
    t_t = tm_t.init_stats()
    tot_t = pipe_t.accumulate_from_alignments(am_t, corpus.feats, alis,
                                              acc_t, t_t)
    assert math.isclose(tot_t, tot_j, rel_tol=2e-5)
    np.testing.assert_array_equal(t_t, t_j)
    assert acc_t.tot_count == acc_j.tot_count
    for p in range(am_t.num_pdfs):
        a, b = acc_t.get_acc(p), acc_j.get_acc(p)
        for x, y in ((a.occupancy, b.occupancy),
                     (a.mean_accumulator, b.mean_accumulator),
                     (a.variance_accumulator, b.variance_accumulator)):
            np.testing.assert_allclose(x, y, rtol=2e-5, atol=1e-4)


def test_wide_models_not_ported(system, monkeypatch):
    """More pdfs than the full-scoring limit took a path the port did
    not have; it has it now (tests/test_torch_wide_em.py holds it to
    khg_tpu).  The wide route (per-state scoring, the banded kernel on
    that lattice, the local-state fold) and the narrow route (full-P
    scoring and fold) give the same records within 1e-5 relative, with
    equal frame and utterance counts and 0 failures."""
    corpus, result = system

    def passes():
        pipe = EStepPipeline(port_copy(result.transition_model), device="cpu",
                             acoustic_scale=1.0, self_loop_scale=0.1,
                             batch_size=2, align_backend="banded")
        am = port_copy(result.am)
        return pipe.em_passes_resident(
            pipe.pack_model_device(am),
            pipe.pack_graphs_base(port_copy(result.graphs)), corpus.feats, 2,
        )[1]

    narrow = passes()
    monkeypatch.setattr(port_pipeline, "EXTERNAL_AC_PDFS", 1)
    wide = passes()
    assert not wide[:, 4].any()
    np.testing.assert_array_equal(wide[:, [1, 3, 4, 5]], narrow[:, [1, 3, 4, 5]])
    np.testing.assert_allclose(wide, narrow, rtol=1e-5, atol=1e-3)
