"""The port's waveform yesno recipe (khg_tpu_torch/recipes/yesno_wav.py)
and its two staged runners (khg_tpu_torch/egs/yesno_{synth,wav}.py)
against khg_tpu's, on the CPU.

- the synthesized WAVs are byte-equal to write_yesno_corpus's for one
  seed, and validate_yesno_waves reports the same;
- extract_features with each option against khg_tpu's on its fused
  frontend (the Pallas kernel in interpret mode; the port's kernel C
  and its plain version share that folded-f32 formulation): ids,
  transcripts and paths equal; log-mel within FBANK_ATOL (1.2e-2: twice
  the folded f32 frontend's distance from the exact function on quiet
  speech frames; synthetic silence reaches 4.5e-3 here); MFCC and its
  deltas within that limit carried through the linear maps that follow
  the log-mel: times the largest row L1 norm of the lifted DCT matrix,
  times the delta taps' L1 norm;
- both runners at smoke scale write the same wer.txt (hypotheses per
  utterance included) as egs/yesno_synth/run.py and egs/yesno_wav/run.py
  run through khg_tpu."""

import filecmp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from khg_tpu.recipes import yesno_wav as j_yw
from khg_tpu_torch.egs import yesno_synth as port_synth
from khg_tpu_torch.egs import yesno_wav as port_wav
from khg_tpu_torch.features.delta import DeltaConfig, delta_scales
from khg_tpu_torch.features.fbank import FbankConfig
from khg_tpu_torch.features.mfcc import MfccConfig, lifted_dct_matrix
from khg_tpu_torch.recipes import yesno_wav as t_yw

REPO = Path(__file__).resolve().parents[1]
# the folded f32 frontend (khg_tpu's Pallas kernel, the port's kernel C
# and its plain version) is ~6e-3 from the exact function in the lowest
# mel filters on speech frames (PERF.md, tools/fbank_exactness.py), so
# two f32 summation orders may differ by twice that on quiet frames
FBANK_ATOL = 1.2e-2


@pytest.fixture(scope="module")
def waves(tmp_path_factory):
    """Six 3-word recordings from seed 5, written by both packages."""
    root = tmp_path_factory.mktemp("yesno_waves")
    j_paths = j_yw.write_yesno_corpus(root / "jax", num_utts=6, words_per_utt=3, seed=5)
    t_paths = t_yw.write_yesno_corpus(root / "port", num_utts=6, words_per_utt=3, seed=5)
    return j_paths, t_paths


def test_synthesized_waves_byte_equal(waves):
    j_paths, t_paths = waves
    assert [p.name for p in t_paths] == [p.name for p in j_paths]
    for a, b in zip(t_paths, j_paths):
        assert filecmp.cmp(a, b, shallow=False), a.name


def test_validate_yesno_waves_reports_equal(waves, tmp_path):
    j_paths, t_paths = waves
    for d in (t_paths[0].parent, j_paths[0].parent):
        assert t_yw.validate_yesno_waves(d) == j_yw.validate_yesno_waves(d)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "x_2.wav").write_bytes(t_paths[0].read_bytes())
    (bad / "1_0_1.wav").write_bytes(t_paths[0].read_bytes())
    rep = t_yw.validate_yesno_waves(bad)
    assert rep == j_yw.validate_yesno_waves(bad)
    assert rep["bad_names"] == ["x_2.wav"] and not rep["is_real_corpus_shape"]
    with pytest.raises(ValueError):
        t_yw.validate_yesno_waves(bad, strict=True)
    corpus = t_yw.load_yesno_corpus(t_paths[0].parent)
    ref = j_yw.load_yesno_corpus(t_paths[0].parent)
    assert corpus.utt_ids == ref.utt_ids and corpus.word_seqs == ref.word_seqs
    lp, jlp = t_yw.make_yesno_lexiconp(), j_yw.make_yesno_lexiconp()
    assert lp.word2id == jlp.word2id and lp.phone2id == jlp.phone2id


def _limit(feature_type, delta_order, cfg):
    """Absolute limit of a feature column block: the frontend's 1e-3
    through the lifted DCT (MFCC) and the delta taps."""
    lim = 1.0
    if feature_type == "mfcc":
        lim *= float(np.abs(lifted_dct_matrix(cfg)).sum(0).max())
    taps = delta_scales(DeltaConfig(order=max(delta_order, 0)))
    return lim * max(float(np.abs(t).sum()) for t in taps)


EXTRACT_CASES = {
    "fbank": dict(),
    "fbank-deltas": dict(delta_order=2),
    "speed-perturb": dict(speed_perturb_factors=(0.9, 1.0, 1.1)),
    "mfcc": dict(feature_type="mfcc"),
    "mfcc-deltas-perturb": dict(feature_type="mfcc", delta_order=2,
                                speed_perturb_factors=(1.1, 0.9)),
}


@pytest.fixture
def jax_fused_frontend(monkeypatch):
    """khg_tpu's extract_features on its fused frontend (the Pallas
    kernel in interpret mode): the same folded-f32 formulation as the
    port's kernel C and its plain version."""
    from khg_tpu.features import mfcc as j_mfcc
    from khg_tpu.features import pallas_fbank

    fb, mf = pallas_fbank.compute_fbank_pallas, j_mfcc.compute_mfcc_pallas
    monkeypatch.setattr(pallas_fbank, "compute_fbank_pallas",
                        lambda w, c, interpret=True: fb(w, c, True))
    monkeypatch.setattr(j_mfcc, "compute_mfcc_pallas",
                        lambda w, c, interpret=True: mf(w, c, True))


@pytest.mark.parametrize("case", list(EXTRACT_CASES))
def test_extract_features_matches_khg_tpu(waves, case, jax_fused_frontend,
                                          monkeypatch):
    """At the runners' frontend (8 kHz, 23 mel bins).  khg_tpu's run
    takes the port's speed-perturbed waves: the two resamplers agree to
    1e-6 of the peak (tests/test_torch_features.py), ~6e-3 in samples
    here, and this test holds the features to the frontend's tolerance,
    which presumes the same waves."""
    from khg_tpu.features import resample as j_resample
    from khg_tpu_torch.features import resample as t_resample

    monkeypatch.setattr(
        j_resample, "speed_perturb_corpus",
        lambda w, sr, factors: t_resample.speed_perturb_corpus(
            w, sr, factors, device="cpu"))
    from khg_tpu.features.fbank import FbankConfig as JFbankConfig

    kw = EXTRACT_CASES[case]
    d = waves[1][0].parent
    ref = j_yw.extract_features(j_yw.load_yesno_corpus(d),
                                JFbankConfig(sample_rate=8000, num_mel_bins=23),
                                use_pallas=True, **kw)
    got = t_yw.extract_features(t_yw.load_yesno_corpus(d),
                                FbankConfig(sample_rate=8000, num_mel_bins=23),
                                device="cpu", **kw)
    assert got.utt_ids == ref.utt_ids
    assert got.word_seqs == ref.word_seqs
    assert [str(p) for p in got.wav_paths] == [str(p) for p in ref.wav_paths]
    if "speed_perturb_factors" in kw:
        assert len(got.utt_ids) == 6 * len(kw["speed_perturb_factors"])
        assert any(u.endswith("_sp1.1") for u in got.utt_ids)
    fcfg = FbankConfig(sample_rate=8000, num_mel_bins=23)
    limit = FBANK_ATOL * _limit(kw.get("feature_type", "fbank"),
                                kw.get("delta_order", 0), MfccConfig(fbank=fcfg))
    for g, r in zip(got.feats, ref.feats):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == np.float32
        assert float(np.abs(g - r).max()) <= limit, case


def test_extract_features_pads_rows_to_a_power_of_two(waves, monkeypatch):
    """Each bucket chunk's rows are padded with zero waves up to a power
    of two, as khg_tpu pads them."""
    from khg_tpu_torch.features import fbank_kernel

    rows = []
    real = t_yw.fbank_fused

    def spy(x, cfg):
        rows.append(x.shape[0])
        return real(x, cfg)

    monkeypatch.setattr(t_yw, "fbank_fused", spy)
    corpus = t_yw.load_yesno_corpus(waves[1][0].parent)
    t_yw.extract_features(corpus, device="cpu", max_batch=4)
    assert all(r & (r - 1) == 0 for r in rows) and sum(rows) >= 6
    assert fbank_kernel.fbank_fused is not spy


def _jax_run(script, exp, args):
    env = dict(os.environ, KHG_PLATFORM="cpu")
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run(
        [sys.executable, str(REPO / "egs" / script / "run.py"),
         "--exp-dir", str(exp), *args],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=400,
    )
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return (exp / "wer.txt").read_text()


def test_yesno_synth_runner_matches_run_py(tmp_path):
    """egs/yesno_synth/run.py's defaults at 8 utterances, 8 passes."""
    args = ["--num-utts", "8", "--num-iters", "8", "--total-gauss", "60"]
    ref = _jax_run("yesno_synth", tmp_path / "jax", args)
    out = port_synth.main(["--exp-dir", str(tmp_path / "port"), "--device", "cpu", *args])
    assert (tmp_path / "port" / "wer.txt").read_text() == ref
    assert out["decode"].report == ref
    for name in ("final.ckpt", "final.txt", "corpus.pkl", "lang/L.fst.txt"):
        assert (tmp_path / "port" / name).exists()
    # stage 3 again from the artifacts: the same report
    again = port_synth.main(["--exp-dir", str(tmp_path / "port"), "--stage", "3",
                             "--device", "cpu", *args])
    assert again["decode"].report == ref


@pytest.mark.parametrize("perturb", [False, True], ids=["plain", "speed-perturb"])
def test_yesno_wav_runner_matches_run_py(tmp_path, perturb):
    """egs/yesno_wav/run.py at 12 utterances (6/6 split), 6 passes, 40
    Gaussians; with --speed-perturb the 6 training utterances become 18
    while the test half stays unperturbed."""
    args = ["--num-utts", "12", "--num-iters", "6", "--total-gauss", "40"]
    if perturb:
        args.append("--speed-perturb")
    ref = _jax_run("yesno_wav", tmp_path / "jax", args)
    out = port_wav.main(["--exp-dir", str(tmp_path / "port"), "--device", "cpu", *args])
    assert (tmp_path / "port" / "wer.txt").read_text() == ref
    assert out["num_train"] == (18 if perturb else 6)
    assert out["test_ids"] == list(range(6, 12))
    assert out["train"].avg_loglikes[-1] > out["train"].avg_loglikes[0]
    for a, b in zip(sorted((tmp_path / "port" / "waves").iterdir()),
                    sorted((tmp_path / "jax" / "waves").iterdir())):
        assert a.name == b.name and filecmp.cmp(a, b, shallow=False)
    for name in ("phones.txt", "words.txt", "topo", "L.fst.txt", "L_disambig.fst.txt"):
        assert ((tmp_path / "port" / "lang" / name).read_bytes()
                == (tmp_path / "jax" / "lang" / name).read_bytes()), name


@pytest.mark.parametrize("module", ["yesno_synth", "yesno_wav"])
def test_runner_needs_a_card_unless_asked(tmp_path, module):
    """--device defaults to cuda, which raises where there is none."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", f"khg_tpu_torch.egs.{module}",
         "--exp-dir", str(tmp_path / "exp")],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120,
    )
    assert p.returncode != 0
    assert "CUDA" in p.stderr
    assert not (tmp_path / "exp").exists()
