"""Why the port's Gaussian schedule leaves khg_tpu's on the long EM
golden config (tools/refgold/make_em_problem.py "long"; khg_tpu's own
schedule is tests/golden/em_loop_golden_long.json's): a tie at the
mix-up's min-count gate, which f32 rounding breaks.

Both packages run train_yesno's first six passes on the config (the
mix-up schedule does not depend on num_iters), and every mixture resize
is recorded with the per-pdf occupancies it was given.  Through the
seventh resize (target 71) both deal the same number of Gaussians.
There pdf 6 holds exactly 160 aligned frames, 8 x min_count 20, and
get_split_targets freezes a pdf once (n + 1) * min_count >= its
occupancy: a sum of f32 component posteriors, 160 up to rounding in
either package, on either side of 160 depending on the order of the
sums.  The cases pin that reading: the occupancies agree to f32
rounding (a frame count each), the tie sits where the schedules part,
and the same occupancies give the same targets in both packages."""

import numpy as np
import pytest

import khg_tpu.recipes.steps as j_steps
import khg_tpu_torch.recipes.steps as t_steps
from khg_tpu.gmm.am_gmm import get_split_targets as j_targets
from khg_tpu.recipes.yesno import make_synthetic_corpus
from khg_tpu.recipes.yesno import train_yesno as j_train
from khg_tpu_torch.gmm.am_gmm import get_split_targets as t_targets
from khg_tpu_torch.recipes.yesno import train_yesno as t_train
from tests.torch_parity import port_copy
from tools.refgold import make_em_problem as prob

CFG = prob.CONFIGS["long"]
PASSES = 6  # resizes 0..6: equal-align, then passes 1..6
MIN_COUNT, POWER = 20.0, 0.2


def _run(train, steps, monkeypatch, port):
    """(resize records, Gaussian schedule) of PASSES passes: each
    record is (mixup target, per-pdf f32 occupancies, Gaussians per pdf
    after the resize, per-component occupancies of every pdf)."""
    lp, corpus = make_synthetic_corpus(
        num_utts=CFG["num_utts"], dim=CFG["dim"],
        rng=np.random.default_rng(CFG["corpus_seed"]))
    kw = {}
    if port:
        lp, corpus, kw = port_copy(lp), port_copy(corpus), dict(device="cpu")
    seen = []
    real = steps._resize_mixtures

    def spy(am, accs, mixup, *args):
        real(am, accs, mixup, *args)
        comps = [np.asarray(accs.get_acc(i).occupancy, np.float64)
                 for i in range(accs.num_accs)]
        occ = np.array([accs.get_acc(i).occupancy.sum() for i in range(accs.num_accs)],
                       np.float32)
        seen.append((mixup, occ, [am.get_pdf(p).num_gauss for p in range(am.num_pdfs)],
                     comps))

    monkeypatch.setattr(steps, "_resize_mixtures", spy)
    res = train(lp, corpus, num_iters=PASSES, realign_iters=CFG["realign_iters"],
                total_gauss=CFG["total_gauss"], max_iter_inc=CFG["max_iter_inc"],
                acoustic_scale=prob.ACOUSTIC_SCALE, self_loop_scale=prob.SELF_LOOP_SCALE,
                boost=CFG["boost"], seed=CFG["train_seed"], perturb_factor=0.0,
                det_split_perturb=CFG["det_split_perturb"], **kw)
    return seen, list(res.num_gauss_after_est)


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        ref = _run(j_train, j_steps, mp, port=False)
    with pytest.MonkeyPatch.context() as mp:
        got = _run(t_train, t_steps, mp, port=True)
    return ref, got


def test_schedules_agree_up_to_the_tie(runs):
    (ref, ref_sched), (got, got_sched) = runs
    assert len(ref) == len(got) == PASSES + 1
    assert ref_sched == got_sched == [11, 11, 23, 35, 47, 59, 71]
    # the Gaussian counts per pdf agree through the sixth resize
    for (_m, _o, a, _c), (_n, _p, b, _d) in zip(ref[:-1], got[:-1]):
        assert a == b


def test_occupancies_are_frame_counts_up_to_rounding(runs):
    """Hard alignments: each pdf's occupancy is a whole number of
    frames, which both packages reach up to f32 rounding of their sums
    (at most 4 ulps of it here)."""
    (ref, _), (got, _) = runs
    for (_m, a, _x, _c), (_n, b, _y, _d) in zip(ref, got):
        frames = np.round(a.astype(np.float64))
        np.testing.assert_array_equal(frames, np.round(b.astype(np.float64)))
        ulp = np.spacing(np.maximum(frames, 1.0).astype(np.float32)).astype(np.float64)
        assert (np.abs(a - frames) <= 4 * ulp).all()
        assert (np.abs(b - frames) <= 4 * ulp).all()


def test_the_tie_at_the_min_count_gate(runs):
    """At the seventh resize (target 71) pdf 6 holds 160 = 8 x 20
    frames with 7 Gaussians: a tie at the gate, where the two packages'
    roundings of 160 deal pdf 6, and so pdf 4, different counts."""
    (ref, _), (got, _) = runs
    mixup, occ_j, after_j, _c = ref[-1]
    _m, occ_t, after_t, _d = got[-1]
    assert mixup == 71
    pdf = 6
    assert np.round(float(occ_j[pdf])) == 160.0 == 8 * MIN_COUNT
    assert after_j != after_t
    differ = [p for p in range(len(after_j)) if after_j[p] != after_t[p]]
    assert pdf in differ and sum(after_j) == sum(after_t) == mixup
    gated = [p for p in differ
             if abs(float(occ_j[p]) - MIN_COUNT * round(float(occ_j[p]) / MIN_COUNT)) < 1e-3]
    assert gated == [pdf]


@pytest.mark.parametrize("which", ["khg_tpu", "port"])
def test_same_occupancies_same_targets(runs, which):
    """Given one package's occupancies, both packages'
    get_split_targets deal the same targets, at every resize."""
    (ref, _), (got, _) = runs
    for mixup, occ, _after, _comps in (ref if which == "khg_tpu" else got):
        assert j_targets(occ, mixup, POWER, MIN_COUNT) == t_targets(occ, mixup, POWER, MIN_COUNT)


if __name__ == "__main__":
    # prints the records at the tie, and how far the two packages'
    # per-component occupancies lie apart at each resize:
    #   PYTHONPATH=. python tests/test_torch_mixup_tie.py
    import math

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, train, steps, port in (("khg_tpu", j_train, j_steps, False),
                                         ("port", t_train, t_steps, True)):
            seen, sched = _run(train, steps, mp, port)
            mixup, occ, after, comps = seen[-1]
            out[name] = seen
            print(f"{name}: schedule {sched}; resize to {mixup}: occupancies "
                  f"{[float(x) for x in occ]}; Gaussians {after}; pdf 6's "
                  f"component occupancies sum to {math.fsum(comps[6])!r} in f64")
    for k, (a, b) in enumerate(zip(out["khg_tpu"], out["port"])):
        ca, cb = np.concatenate(a[3]), np.concatenate(b[3])
        rel = np.abs(ca - cb) / np.maximum(np.abs(ca), 1e-30)
        print(f"resize {k} (target {a[0]}): per-component occupancies apart by "
              f"at most {rel.max():.3e} relative")
