"""EStepPipeline.align_and_accumulate and em_pass_resident in the port
against khg_tpu's on the same model, graphs and features (khg_tpu on
the CPU, the port with device="cpu").

Tolerances: alignments, failure counts, done counts, frame counts and
transition counts exact; tot_like and the GMM accumulators within 1e-5
of the largest magnitude of the quantity compared (f32 sums of the same
terms in another order; measured <= 6e-7).  The new model of the
resident pass within 5e-5: the f32 M-step's var = E[x^2] - mean^2
cancels, which amplifies the stats' ~1e-7 differences about a hundred
times (measured 1.8e-5 on means_invvars)."""

import copy

import numpy as np
import pytest

from khg_tpu.est.flags import GMM_ALL
from khg_tpu.est.mle import MleDiagGmmOptions
from khg_tpu.recipes.pipeline import EStepPipeline as JPipeline
from khg_tpu.recipes.yesno import make_synthetic_corpus, train_yesno
from khg_tpu.stats.accum import AccumAmDiagGmm as JAccum
from khg_tpu_torch.recipes.pipeline import EStepPipeline
from khg_tpu_torch.stats.accum import AccumAmDiagGmm
from tests.torch_parity import port_copy

RTOL = 1e-5
MODEL_RTOL = 5e-5
KW = dict(acoustic_scale=0.1, self_loop_scale=0.1, batch_size=3)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    assert float(np.abs(got - ref).max(initial=0.0)) <= rtol * scale


@pytest.fixture(scope="module")
def system():
    """A model khg_tpu trained for 3 passes on 8 synthetic utterances
    (one of them given a graph it cannot align: a failure), and both
    packages' pipelines with graphs carrying the transition probs."""
    rng = np.random.default_rng(21)
    lp, corpus = make_synthetic_corpus(num_utts=8, dim=7, rng=rng)
    result = train_yesno(lp, corpus, num_iters=3, total_gauss=24,
                         max_iter_inc=2, realign_iters="1 2")
    feats = list(corpus.feats)
    feats[5] = feats[5][:4]  # too few frames for its graph: fails
    pipe_j = JPipeline(copy.deepcopy(result.transition_model), **KW)
    pipe_t = EStepPipeline(port_copy(result.transition_model), device="cpu", **KW)
    packed_j = pipe_j.pack_graphs(result.graphs)
    packed_t = pipe_t.pack_graphs(port_copy(result.graphs))
    return result, feats, (pipe_j, packed_j), (pipe_t, packed_t)


def _accs(am, cls):
    acc = cls()
    acc.init(am, flags=GMM_ALL)
    return acc


def _check_accs(acc_t, acc_j):
    assert acc_t.total_frames == acc_j.total_frames
    _close(acc_t.total_log_like, acc_j.total_log_like)
    for p in range(len(acc_j.accs)):
        a, b = acc_t.get_acc(p), acc_j.get_acc(p)
        _close(a.occupancy, b.occupancy)
        _close(a.mean_accumulator, b.mean_accumulator)
        _close(a.variance_accumulator, b.variance_accumulator)


def test_alignments_only(system):
    """accumulate=False (train_yesno's realignment): same alignments,
    the failure counted, no alignment for it."""
    result, feats, (pipe_j, packed_j), (pipe_t, packed_t) = system
    ref = pipe_j.align_and_accumulate(result.am, packed_j, feats,
                                      accumulate=False)
    got = pipe_t.align_and_accumulate(port_copy(result.am), packed_t, feats,
                                      accumulate=False)
    assert got.alignments == ref.alignments
    assert got.alignments[5] is None
    assert (got.num_done, got.num_error, got.frame_count) == (
        ref.num_done, ref.num_error, ref.frame_count) == (
        7, 1, sum(f.shape[0] for i, f in enumerate(feats) if i != 5))
    _close(got.tot_like, ref.tot_like)


@pytest.mark.parametrize("return_alignments", [True, False],
                         ids=["alignments", "carry"])
def test_alignments_and_stats(system, return_alignments):
    """accumulate=True: the GMM accumulators and transition counts of
    both routes (per-batch stats with the alignments, or the device
    carry with one fetch and no alignments)."""
    result, feats, (pipe_j, packed_j), (pipe_t, packed_t) = system
    am_t = port_copy(result.am)
    acc_j, acc_t = _accs(result.am, JAccum), _accs(am_t, AccumAmDiagGmm)
    tr_j = result.transition_model.init_stats()
    tr_t = pipe_t.tm.init_stats()
    ref = pipe_j.align_and_accumulate(result.am, packed_j, feats, acc_j, tr_j,
                                      return_alignments=return_alignments)
    got = pipe_t.align_and_accumulate(am_t, packed_t, feats, acc_t, tr_t,
                                      return_alignments=return_alignments,
                                      max_in_flight=2)
    if return_alignments:
        assert got.alignments == ref.alignments
    else:
        assert got.alignments is None and ref.alignments is None
    assert (got.num_done, got.num_error, got.frame_count) == (
        ref.num_done, ref.num_error, ref.frame_count)
    _close(got.tot_like, ref.tot_like)
    np.testing.assert_array_equal(tr_t, tr_j)
    _check_accs(acc_t, acc_j)


def test_carry_route_equals_alignment_route(system):
    """The port's two accumulate routes agree with each other: the same
    transition counts and likelihood, GMM stats within RTOL."""
    result, feats, _j, (pipe_t, packed_t) = system
    am = port_copy(result.am)
    outs = []
    for ra in (True, False):
        acc, tr = _accs(am, AccumAmDiagGmm), pipe_t.tm.init_stats()
        res = pipe_t.align_and_accumulate(am, packed_t, feats, acc, tr,
                                          return_alignments=ra)
        outs.append((res, acc, tr))
    (r1, a1, t1), (r2, a2, t2) = outs
    np.testing.assert_array_equal(t1, t2)
    _close(r2.tot_like, r1.tot_like)
    _check_accs(a2, a1)


def test_em_pass_resident(system):
    """One resident pass: the new model within MODEL_RTOL (device tuple
    and host write-back), tid counts exact, the summary equal."""
    result, feats, (pipe_j, packed_j), (pipe_t, packed_t) = system
    opts = MleDiagGmmOptions()
    am_j, am_t = result.am.copy(), port_copy(result.am)
    model_j, counts_j, res_j = pipe_j.em_pass_resident(
        pipe_j.pack_model_device(am_j), packed_j, feats, mle_config=opts)
    model_t, counts_t, res_t = pipe_t.em_pass_resident(
        pipe_t.pack_model_device(am_t), packed_t, feats,
        mle_config=port_copy(opts))
    np.testing.assert_array_equal(counts_t, np.asarray(counts_j, np.float64))
    assert res_t.alignments is None
    assert (res_t.num_done, res_t.num_error, res_t.frame_count) == (
        res_j.num_done, res_j.num_error, res_j.frame_count)
    _close(res_t.tot_like, res_j.tot_like)
    for x, y in zip(model_t, model_j):
        x, y = x.numpy(), np.asarray(y)
        fin = np.isfinite(y)
        np.testing.assert_array_equal(np.isfinite(x), fin)
        _close(x[fin], y[fin], MODEL_RTOL)
    pipe_j.apply_model_to_am(model_j, am_j)
    pipe_t.apply_model_to_am(model_t, am_t)
    for p in range(am_j.num_pdfs):
        gj, gt = am_j.get_pdf(p), am_t.get_pdf(p)
        assert gj.num_gauss == gt.num_gauss
        _close(gt.means_invvars, gj.means_invvars, MODEL_RTOL)
        _close(gt.inv_vars, gj.inv_vars, MODEL_RTOL)
        _close(gt.weights, gj.weights, MODEL_RTOL)


def test_needs_one_graph_per_utterance(system):
    result, feats, _j, (pipe_t, packed_t) = system
    with pytest.raises(ValueError):
        pipe_t.align_and_accumulate(port_copy(result.am), packed_t[:-1], feats)
    with pytest.raises(ValueError):
        pipe_t.align_and_accumulate(port_copy(result.am), packed_t, feats,
                                    accumulate=False, return_alignments=False)
