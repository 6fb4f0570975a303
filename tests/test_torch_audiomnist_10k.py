"""Stage 3 of the corpus recipe in the port (khg_tpu_torch/egs/
audiomnist_10k.py) against egs/audiomnist_10k/run.py's stage 3 rendered
through khg_tpu, on a model and features that khg_tpu trained and
extracted; and the port's staged runner end to end on the CPU at
tests/test_audiomnist_10k.py's smoke scale."""

import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from khg_tpu_torch.egs import audiomnist_10k as port_runner
from tests.torch_parity import port_copy

REPO = Path(__file__).resolve().parents[1]


def _run_py():
    """egs/audiomnist_10k/run.py as a module (its import only sets
    defaults of JAX's cache settings, restored here)."""
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "audiomnist_10k_run", REPO / "egs" / "audiomnist_10k" / "run.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


SMOKE = ("--num-utts", "60", "--num-test", "12", "--num-iters", "8",
         "--total-gauss", "150", "--max-iter-inc", "4", "--stretch", "2",
         "--batch-size", "16")


@pytest.fixture(scope="module")
def jax_system(tmp_path_factory):
    """egs/audiomnist_10k/run.py (khg_tpu) run whole on the CPU at
    tests/test_audiomnist_10k.py's smoke scale: its corpus, features,
    trained model and wer.txt; the last 12 utterances are held out."""
    import pickle

    from khg_tpu.lang.lexicon import Lexicon, Lexiconp
    from khg_tpu.recipes.audiomnist import digits_lexicon, load_audiomnist_corpus
    from khg_tpu.utils.checkpoint import load_checkpoint

    exp = tmp_path_factory.mktemp("jax_exp")
    env = dict(os.environ, KHG_PLATFORM="cpu")
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run(
        [sys.executable, str(REPO / "egs" / "audiomnist_10k" / "run.py"),
         "--exp-dir", str(exp), *SMOKE],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=400,
    )
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    corpus = load_audiomnist_corpus(exp / "waves")
    with open(exp / "feats.pkl", "rb") as f:
        corpus.feats = pickle.load(f)
    lp = Lexiconp.from_lexicon(Lexicon(word2phones=digits_lexicon())).add_lex_disambig()
    n = len(corpus.utt_ids)
    return (lp, corpus, list(range(n - 12, n)), load_checkpoint(exp / "final.ckpt"),
            (exp / "wer.txt").read_text())


def jax_stage3(lp, corpus, test_ids, am, tm, tree):
    """run.py:218-283 through khg_tpu, with its chip branch of the
    scoring (model packed to 8 components, 128-frame buckets, rows padded
    to a power of two, one jitted loglikes call per bucket), on the CPU.
    Returns (per-utterance scores, hypotheses, wer.txt's text)."""
    from khg_tpu.decode.arpa import arpa_to_fst
    from khg_tpu.decode.graph import build_hclg
    from khg_tpu.decode.lattice import (
        LatticeFasterDecoder,
        LatticeFasterDecoderConfig,
        decode_utterances_parallel,
    )
    from khg_tpu.decode.wer import write_error_stats
    from khg_tpu.gmm.likelihoods import loglikes as gmm_loglikes

    G = arpa_to_fst(_run_py().digit_unigram_arpa(), lp.word2id)
    hclg = build_hclg(lp, G, tm, tree)
    decoder = LatticeFasterDecoder(
        hclg, LatticeFasterDecoderConfig(beam=40.0, lattice_beam=6.0)
    )
    pm = am.pack(mix_pad_to=8)
    g_, m_, v_ = (jnp.asarray(x) for x in (pm.gconsts, pm.means_invvars, pm.inv_vars))
    score = jax.jit(lambda f: gmm_loglikes(g_, m_, v_, f))
    buckets = {}
    for i in test_ids:
        t = corpus.feats[i].shape[0]
        buckets.setdefault(-(-t // 128) * 128, []).append(i)
    ll_by_id = {}
    for tb, ids in sorted(buckets.items()):
        rows = 1 << (len(ids) - 1).bit_length()
        fb = np.zeros((rows, tb, corpus.feats[ids[0]].shape[1]), np.float32)
        for r, i in enumerate(ids):
            fb[r, : corpus.feats[i].shape[0]] = corpus.feats[i]
        out = np.asarray(score(jnp.asarray(fb)))
        for r, i in enumerate(ids):
            ll_by_id[i] = out[r, : corpus.feats[i].shape[0]]
    lls = [ll_by_id[i] for i in test_ids]
    decoded = decode_utterances_parallel(decoder, lls, tm.id2pdf_array(),
                                         acoustic_scale=2.0)
    results, hyps = [], []
    for i, (ok, _tids, words, _like) in zip(test_ids, decoded):
        hyp = [lp.id2word[w] for w in words] if ok else []
        hyps.append(hyp)
        results.append((corpus.utt_ids[i], corpus.word_seqs[i], hyp))
    f = io.StringIO()
    write_error_stats(f, "audiomnist_10k_test", results, enable_log=False)
    return lls, hyps, f.getvalue()


def test_digit_unigram_arpa_is_run_py_s():
    assert port_runner.digit_unigram_arpa() == _run_py().digit_unigram_arpa()


def test_stage3_matches_jax(jax_system):
    """score_held_out + decode_held_out on the CPU against run.py's
    stage 3 through khg_tpu on run.py's model and features: identical
    hypotheses and wer.txt (also the wer.txt run.py wrote, scoring on its
    CPU branch), scores within 1e-5 relative to their magnitude (f32
    sums of component terms in another order)."""
    lp, corpus, test_ids, state, run_report = jax_system
    models = [state[k] for k in ("acoustic_model", "transition_model", "tree")]
    ref_lls, ref_hyps, ref_report = jax_stage3(lp, corpus, test_ids, *models)
    assert ref_report == run_report
    am, tm, tree = (port_copy(x) for x in models)
    feats = [corpus.feats[i] for i in test_ids]
    scores = port_runner.score_held_out(am, feats, "cpu")
    for s, r in zip(scores, ref_lls):
        assert s.shape == r.shape and s.device.type == "cpu"
        assert float(np.abs(s.numpy() - r).max()) <= 1e-5 * np.abs(r).max()
    out = port_runner.decode_held_out(
        port_runner.digit_lexiconp(), tm, tree, scores,
        [corpus.utt_ids[i] for i in test_ids], [corpus.word_seqs[i] for i in test_ids],
    )
    assert out.hyps == ref_hyps
    assert out.report == ref_report
    assert out.wer <= 5.0, out.report


def test_score_held_out_buckets(jax_system, monkeypatch):
    """One scoring call per 128-frame bucket, its rows a power of two."""
    from khg_tpu_torch.gmm import fused_loglikes

    _lp, corpus, test_ids, state, _report = jax_system
    feats = [corpus.feats[i] for i in test_ids]
    shapes = []
    real = fused_loglikes.loglikes_fused

    def spy(g, m, v, x, compute_dtype=None):
        shapes.append(tuple(x.shape))
        return real(g, m, v, x, compute_dtype)

    monkeypatch.setattr(fused_loglikes, "loglikes_fused", spy)
    port_runner.score_held_out(port_copy(state["acoustic_model"]), feats, "cpu")
    lens = [f.shape[0] for f in feats]
    tbs = sorted({-(-n // 128) * 128 for n in lens})
    assert [s[1] for s in shapes] == tbs
    for rows, tb, d in shapes:
        n = sum(-(-t // 128) * 128 == tb for t in lens)
        assert rows == 1 << (n - 1).bit_length() and d == 23


def _run(exp, stage=0, extra=()):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, "-m", "khg_tpu_torch.egs.audiomnist_10k",
         "--exp-dir", str(exp), "--stage", str(stage), "--device", "cpu",
         *SMOKE, *extra],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=400,
    )


def test_port_runner_end_to_end(tmp_path):
    """All four stages as a subprocess with --device cpu: WER <= 5%, the
    artifacts written, the --json record with run.py's keys, and a
    stage-3 resume giving the same report."""
    import json

    exp = tmp_path / "exp"
    p = _run(exp, extra=("--json",))
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    report = (exp / "wer.txt").read_text()
    wer = report.splitlines()[0]
    assert "%WER" in wer
    assert float(wer.split("%WER")[1].split("%")[0]) <= 5.0, wer
    for name in ("final.ckpt", "final.txt", "feats.pkl"):
        assert (exp / name).exists()
    assert len(list((exp / "waves").glob("*.wav"))) == 60
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    for key in ("corpus_train_utts", "corpus_train_wall_s", "corpus_train_passes",
                "corpus_train_num_gauss", "corpus_train_final_ll",
                "corpus_train_wer_pct", "corpus_stage_decode_s",
                "corpus_stage_hclg_s", "corpus_stage_score_s",
                "corpus_stage_decode_audio_sec_per_s"):
        assert key in rec, key
    assert rec["corpus_train_utts"] == 48 and rec["corpus_train_passes"] == 8

    p2 = _run(exp, stage=3)
    assert p2.returncode == 0, p2.stdout[-3000:] + p2.stderr[-3000:]
    assert (exp / "wer.txt").read_text() == report


def test_port_runner_needs_a_card_unless_asked(tmp_path):
    """--device defaults to cuda, which raises where there is none."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "khg_tpu_torch.egs.audiomnist_10k",
         "--exp-dir", str(tmp_path / "exp")],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120,
    )
    assert p.returncode != 0
    assert "CUDA" in p.stderr
    assert not (tmp_path / "exp" / "waves").exists()
