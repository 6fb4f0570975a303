"""The wide-model (triphone-scale) resident hard-EM path in the port
against khg_tpu: both packages' EXTERNAL_AC_PDFS gates are set to 1, so
every model is "wide": banded batches score per graph state, align on
that lattice (the banded kernel's external-acoustic mode) and fold
their stats through the graph states (the stats fold's plain version);
other batches score all pdfs and fold with accumulate_am_stats."""

import copy

import numpy as np
import pytest

import khg_tpu.align.pallas_banded as j_pb
from khg_tpu.est.mle import MleDiagGmmOptions
from khg_tpu.model.transition_model import MleTransitionUpdateConfig
from khg_tpu.recipes.pipeline import EStepPipeline as JPipeline
from khg_tpu.recipes.yesno import make_synthetic_corpus, train_yesno
from khg_tpu_torch.recipes import pipeline as port_pipeline
from khg_tpu_torch.recipes.pipeline import EStepPipeline
from khg_tpu_torch.stats import fold_kernel
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


def _passes(system, align, passes=2, port=True):
    corpus, result = system
    kw = dict(acoustic_scale=1.0, self_loop_scale=0.1, batch_size=2,
              align_backend=align)
    opts, tcfg = MleDiagGmmOptions(), MleTransitionUpdateConfig()
    if port:
        pipe = EStepPipeline(port_copy(result.transition_model), device="cpu", **kw)
        am = port_copy(result.am)
        graphs = port_copy(result.graphs)
        opts, tcfg = port_copy(opts), port_copy(tcfg)
    else:
        pipe = JPipeline(copy.deepcopy(result.transition_model), **kw)
        am = result.am.copy()
        graphs = result.graphs
    _model, rec, occ = pipe.em_passes_resident(
        pipe.pack_model_device(am), pipe.pack_graphs_base(graphs),
        corpus.feats, passes, mle_config=opts, transition_cfg=tcfg,
        return_occ=True,
    )
    return rec, occ, pipe


@pytest.mark.parametrize("align", ["banded", "xla"])
def test_wide_resident_passes_match_jax(system, monkeypatch, align):
    """Two wide resident passes: records within 1e-5 relative, equal
    frame and utterance counts, final occupancies close.  The banded
    run goes through the stats fold (and not the full-P fold)."""
    monkeypatch.setattr(j_pb, "EXTERNAL_AC_PDFS", 1)
    monkeypatch.setattr(port_pipeline, "EXTERNAL_AC_PDFS", 1)
    folds = []
    real_fold = fold_kernel.accumulate_am_stats_local

    def counted(*a, **k):
        folds.append(1)
        return real_fold(*a, **k)

    monkeypatch.setattr(fold_kernel, "accumulate_am_stats_local", counted)
    rec_j, occ_j, _ = _passes(system, align, port=False)
    rec_t, occ_t, pipe = _passes(system, align)
    assert pipe._is_wide()
    assert rec_t.shape == rec_j.shape == (2, 8)
    np.testing.assert_array_equal(rec_t[:, [1, 3, 4, 5]], rec_j[:, [1, 3, 4, 5]])
    assert not rec_t[:, 4].any()
    np.testing.assert_allclose(rec_t, rec_j, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(occ_t, occ_j, rtol=1e-5, atol=1e-3)
    assert (len(folds) > 0) == (align == "banded")

