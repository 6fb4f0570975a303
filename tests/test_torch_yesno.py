"""The port's realigning EM loop (khg_tpu_torch/recipes/yesno.py:
train_yesno, with its E-steps on EStepPipeline, device="cpu") against
khg_tpu's on the same corpus, against the reference loop's goldens
(tests/golden/em_loop_golden.json, written by
tools/refgold/em_loop_runner.cc), and against itself across a
checkpoint resume.

Tolerances: the discrete schedule (Gaussian count after every est step,
and the order of realignments and accumulations) exact; the per-pass
average log-likelihood within tests/test_em_loop_golden.py's envelope
(``traj_atol``: 2e-3 a pass on the toy run), which holds f32
arithmetic-order differences compounding through mix-up; a resumed run
bit-equal to an uninterrupted one."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools" / "refgold"))

import make_em_problem as prob  # noqa: E402

from khg_tpu.recipes import pipeline as j_pipeline  # noqa: E402
from khg_tpu.recipes import yesno as j_yesno  # noqa: E402
from khg_tpu_torch.recipes import pipeline as t_pipeline  # noqa: E402
from khg_tpu_torch.recipes import yesno as t_yesno  # noqa: E402
from tests.test_em_loop_golden import GOLDEN_FILES, traj_atol  # noqa: E402


def _train(mod, config, **kw):
    cfg = prob.CONFIGS[config]
    lp, corpus = mod.make_synthetic_corpus(
        num_utts=cfg["num_utts"], dim=cfg["dim"],
        rng=np.random.default_rng(cfg["corpus_seed"]),
    )
    return mod.train_yesno(
        lp, corpus,
        num_iters=kw.pop("num_iters", cfg["num_iters"]),
        realign_iters=cfg["realign_iters"],
        total_gauss=cfg["total_gauss"],
        max_iter_inc=cfg["max_iter_inc"],
        acoustic_scale=prob.ACOUSTIC_SCALE,
        self_loop_scale=prob.SELF_LOOP_SCALE,
        boost=cfg["boost"],
        seed=cfg["train_seed"],
        perturb_factor=0.0,
        det_split_perturb=cfg["det_split_perturb"],
        **kw,
    )


def _spy_steps(monkeypatch, pipe_cls):
    """Record the E-steps train_yesno takes, in order: "R" for a
    realignment, "A" for an accumulation."""
    steps = []
    for name, tag in (("align_and_accumulate", "R"),
                      ("accumulate_from_alignments", "A")):
        real = getattr(pipe_cls, name)

        def spy(self, *a, _real=real, _tag=tag, **k):
            steps.append(_tag)
            return _real(self, *a, **k)

        monkeypatch.setattr(pipe_cls, name, spy)
    return steps


@pytest.fixture(scope="module")
def toy_runs():
    """khg_tpu's and the port's toy runs, with their E-step sequences."""
    with pytest.MonkeyPatch.context() as mp:
        j_steps = _spy_steps(mp, j_pipeline.EStepPipeline)
        t_steps = _spy_steps(mp, t_pipeline.EStepPipeline)
        ref = _train(j_yesno, "toy")
        got = _train(t_yesno, "toy", device="cpu")
    return ref, got, j_steps, t_steps


def test_synthetic_corpus_is_khg_tpu_s():
    lp_j, c_j = j_yesno.make_synthetic_corpus(num_utts=5, dim=4)
    lp_t, c_t = t_yesno.make_synthetic_corpus(num_utts=5, dim=4)
    assert c_t.word_seqs == c_j.word_seqs
    assert c_t.phone_alignments == c_j.phone_alignments
    for a, b in zip(c_t.feats, c_j.feats):
        np.testing.assert_array_equal(a, b)
    assert lp_t.word2id == lp_j.word2id and lp_t.phone2id == lp_j.phone2id


def test_train_yesno_matches_khg_tpu(toy_runs):
    """Toy config: the same E-step sequence (realignments on the same
    passes), the same Gaussian schedule, the trajectory within 2e-3 a
    pass, and learning (the last pass well above the flat start)."""
    ref, got, j_steps, t_steps = toy_runs
    assert t_steps == j_steps and "R" in t_steps
    assert got.num_gauss_after_est == ref.num_gauss_after_est
    assert got.info == ref.info
    atol = traj_atol("toy", len(ref.avg_loglikes))
    np.testing.assert_allclose(got.avg_loglikes, ref.avg_loglikes, rtol=0,
                               atol=atol[0])
    assert got.avg_loglikes[-1] > got.avg_loglikes[0] + 1.0
    assert all(a is not None for a in got.alignments)


def test_train_yesno_matches_reference_golden(toy_runs):
    """The port against the reference loop's toy golden: Gaussian
    schedule exact, trajectory within test_em_loop_golden.py's
    envelope."""
    golden = json.loads(GOLDEN_FILES["toy"].read_text())
    got = toy_runs[1]
    assert got.num_gauss_after_est == golden["num_gauss_after_est"]
    assert got.info["number_of_gaussians"] == golden["final_num_gauss"]
    ref = np.asarray(golden["pass_avg_loglike"])
    diff = np.abs(np.asarray(got.avg_loglikes) - ref)
    atol = traj_atol("toy", len(ref))
    assert diff.shape == ref.shape and (diff <= atol).all(), (
        np.nonzero(diff > atol)[0].tolist(), diff.max())


def test_resume_is_bit_exact(tmp_path):
    """4 passes with checkpoints, then a call for 8 resumes from the
    pass-4 checkpoint (model, graphs, alignments, Gaussian schedule and
    the numpy rng state): bit-equal to 8 uninterrupted passes."""
    full = _train(t_yesno, "toy", device="cpu")
    ck = tmp_path / "ck"
    ck.mkdir()
    _train(t_yesno, "toy", num_iters=4, checkpoint_dir=str(ck), device="cpu")
    assert sorted(p.name for p in ck.iterdir()) == [
        f"iter_{i}.ckpt" for i in range(4)]
    resumed = _train(t_yesno, "toy", checkpoint_dir=str(ck), device="cpu")
    assert resumed.avg_loglikes == full.avg_loglikes
    assert resumed.num_gauss_after_est == full.num_gauss_after_est
    assert resumed.alignments == full.alignments
    for p in range(full.am.num_pdfs):
        a, b = full.am.get_pdf(p), resumed.am.get_pdf(p)
        for x, y in ((a.weights, b.weights), (a.means_invvars, b.means_invvars),
                     (a.inv_vars, b.inv_vars), (a.gconsts, b.gconsts)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(full.transition_model.log_probs,
                                  resumed.transition_model.log_probs)


def test_train_audiomnist_matches_khg_tpu():
    """recipes/audiomnist.train_audiomnist at 6 utterances, 4 passes:
    the Gaussian schedule exact, the trajectory within 2e-3 a pass.
    (Mix-up hands out Gaussians by each pdf's total occupancy, which in
    hard EM is its frame count up to f32 rounding: where two pdfs hold
    the same count, as two do at 8 utterances and 120 Gaussians, the
    rounding noise of either package breaks the tie.)"""
    from khg_tpu.recipes.audiomnist import train_audiomnist as j_train
    from khg_tpu_torch.recipes.audiomnist import train_audiomnist as t_train

    kw = dict(num_utts=6, num_iters=4, total_gauss=80, max_iter_inc=2)
    ref = j_train(**kw)
    got = t_train(device="cpu", **kw)
    assert got.num_gauss_after_est == ref.num_gauss_after_est
    np.testing.assert_allclose(got.avg_loglikes, ref.avg_loglikes, rtol=0,
                               atol=2e-3)
    assert got.avg_loglikes[-1] > got.avg_loglikes[0] + 1.0


def test_audiomnist_wav_corpus_and_training(tmp_path):
    """write_audiomnist_corpus writes khg_tpu's WAVs byte for byte (one
    seed), and train_audiomnist_wav trains on them on the CPU: the
    log-likelihood rises and no alignment is missing."""
    import filecmp

    from khg_tpu.recipes.audiomnist import write_audiomnist_corpus as j_write
    from khg_tpu_torch.recipes.audiomnist import (
        train_audiomnist_wav,
        write_audiomnist_corpus,
    )

    got = write_audiomnist_corpus(tmp_path / "port", num_utts=5, seed=3)
    ref = j_write(tmp_path / "jax", num_utts=5, seed=3)
    assert [p.name for p in got] == [p.name for p in ref]
    assert all(filecmp.cmp(a, b, shallow=False) for a, b in zip(got, ref))
    res = train_audiomnist_wav(tmp_path / "port", num_iters=3, total_gauss=80,
                               device="cpu")
    assert res.avg_loglikes[-1] > res.avg_loglikes[0] + 1.0
    assert len(res.alignments) == 5 and all(a is not None for a in res.alignments)
