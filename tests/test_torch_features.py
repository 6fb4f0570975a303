"""The port's waveform resampling / speed perturbation, delta features
and MFCC (khg_tpu_torch/features/{resample,delta,mfcc}.py, on the CPU)
against khg_tpu's on the same seeded inputs, and against the MFCC +
delta golden.

Tolerances: resampled lengths exact and values within 1e-6 of the
wave's peak (f32 sums of the same filter taps in another order); deltas
within 1e-6 relative to the features' magnitude (the same f32 terms in
the same order; measured bit-equal); MFCC within tests/test_mfcc_delta.py's
Pallas-vs-XLA tolerance (rtol 2e-4, atol 2e-3), which holds the folded
f32 frontend against the direct one; MFCC + deltas within the golden's
(2e-3)."""

import numpy as np
import pytest
import torch

from khg_tpu.features import delta as j_delta
from khg_tpu.features import mfcc as j_mfcc
from khg_tpu.features import resample as j_resample
from khg_tpu.features.fbank import FbankConfig as JFbankConfig
from khg_tpu_torch.features import delta as t_delta
from khg_tpu_torch.features import mfcc as t_mfcc
from khg_tpu_torch.features import resample as t_resample
from khg_tpu_torch.features.fbank import FbankConfig
from tests.test_fbank import _golden_wave


def _speech_like(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000.0
    w = 3000 * np.sin(2 * np.pi * (150 + 400 * t) * t) + rng.standard_normal(n) * 300
    return np.round(w).astype(np.float32)


@pytest.mark.parametrize("sr_in,sr_out", [
    (8000, 16000), (16000, 8000), (8000, 7200), (8000, 22050), (8000, 48000),
    (44100, 8000),
], ids=lambda v: str(v))
def test_resample_waveform_matches_khg_tpu(sr_in, sr_out):
    """Includes q > 2p (8 -> 22.05 and 48 kHz), where a right slack of
    half + p alone would truncate the tail."""
    x = _speech_like(1237, 3)
    ref = np.asarray(j_resample.resample_waveform(x, sr_in, sr_out))
    got = t_resample.resample_waveform(x, sr_in, sr_out, device="cpu")
    assert got.dtype == np.float32
    assert got.shape == ref.shape == (j_resample._out_len(1237, *t_resample._as_ratio(sr_in, sr_out)),)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(x).max()


def test_polyphase_filter_is_khg_tpu_s():
    for p, q in ((9, 10), (11, 10), (1, 6), (160, 441)):
        np.testing.assert_array_equal(t_resample._polyphase_filter(p, q, 10),
                                      j_resample._polyphase_filter(p, q, 10))


@pytest.mark.parametrize("factor", [0.9, 1.0, 1.1, 0.85])
def test_perturb_speed_matches_khg_tpu(factor):
    x = _speech_like(2003, 4)
    ref = np.asarray(j_resample.perturb_speed(x, 8000, factor))
    got = t_resample.perturb_speed(x, 8000, factor, device="cpu")
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(x).max()


def test_speed_perturb_corpus_matches_khg_tpu_and_one_at_a_time():
    """Each output equals perturb_speed on its source (bit for bit) and
    khg_tpu's (1e-6 of the peak); order and source indices as
    khg_tpu's."""
    waves = [_speech_like(n, s) for s, n in enumerate((900, 1201, 900, 1500, 1201))]
    ref, ref_src = j_resample.speed_perturb_corpus(waves, 8000)
    got, got_src = t_resample.speed_perturb_corpus(waves, 8000, device="cpu")
    assert got_src == ref_src == [0, 1, 2, 3, 4] * 3
    peak = max(np.abs(w).max() for w in waves)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == np.asarray(r).shape
        assert np.abs(g - np.asarray(r)).max() <= 1e-6 * peak
        f = (0.9, 1.0, 1.1)[k // 5]
        one = t_resample.perturb_speed(waves[k % 5], 8000, f, device="cpu")
        np.testing.assert_array_equal(g, one)


def test_resample_needs_a_device_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_resample.resample_waveform(np.zeros(10, np.float32), 8000, 16000)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_add_deltas_matches_khg_tpu(order, window):
    rng = np.random.default_rng(10 * order + window)
    feats = rng.standard_normal((2, 37, 13)).astype(np.float32) * 5
    cfg_j = j_delta.DeltaConfig(order=order, window=window)
    cfg_t = t_delta.DeltaConfig(order=order, window=window)
    for a, b in zip(t_delta.delta_scales(cfg_t), j_delta.delta_scales(cfg_j)):
        np.testing.assert_array_equal(a, b)
    for x in (feats, feats[0], feats[0, :3]):  # batched, one, short
        ref = np.asarray(j_delta.add_deltas(x, cfg_j))
        got = t_delta.add_deltas(torch.as_tensor(x), cfg_t).numpy()
        assert got.shape == ref.shape == x.shape[:-1] + (13 * (order + 1),)
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


MFCC_CFGS = [
    ("8k", dict(sample_rate=8000, num_mel_bins=23, high_freq=-400.0), {}),
    ("8k-yesno", dict(sample_rate=8000, num_mel_bins=23), {}),
    ("no-energy", dict(sample_rate=16000, num_mel_bins=23),
     dict(use_energy=False)),
    ("wide", dict(sample_rate=16000, num_mel_bins=40, low_freq=40.0),
     dict(num_ceps=20, use_energy=False, cepstral_lifter=30.0)),
]


@pytest.mark.parametrize("name,fb,kw", MFCC_CFGS, ids=[c[0] for c in MFCC_CFGS])
def test_mfcc_matches_khg_tpu(name, fb, kw):
    """compute_mfcc_batch (the fbank kernel's plain version + fp32 DCT)
    against khg_tpu's XLA path and its Pallas kernel in interpret mode."""
    cfg_j = j_mfcc.MfccConfig(fbank=JFbankConfig(**fb), **kw)
    cfg_t = t_mfcc.MfccConfig(fbank=FbankConfig(**fb), **kw)
    np.testing.assert_array_equal(t_mfcc.lifted_dct_matrix(cfg_t),
                                  j_mfcc.lifted_dct_matrix(cfg_j))
    rng = np.random.default_rng(11)
    waves = (rng.standard_normal((2, int(0.8 * fb["sample_rate"]))) * 3000).astype(np.float32)
    got = t_mfcc.compute_mfcc_batch(torch.as_tensor(waves), cfg_t).numpy()
    for ref in (np.asarray(j_mfcc.compute_mfcc_batch(waves, cfg_j)),
                np.asarray(j_mfcc.compute_mfcc_pallas(waves, cfg_j, interpret=True))):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-3)
    one = t_mfcc.compute_mfcc(waves[1], cfg_t, device="cpu")
    np.testing.assert_allclose(one, got[1], rtol=1e-6, atol=1e-5)


def test_mfcc_deltas_match_golden():
    """MFCC + deltas of the golden wave against tests/golden/mfcc_golden.npz
    (written by the torch oracle of tests/torch_fbank_oracle.py)."""
    from pathlib import Path

    cfg = t_mfcc.MfccConfig(fbank=FbankConfig(sample_rate=8000, num_mel_bins=23,
                                              high_freq=-400.0))
    feats = t_mfcc.compute_mfcc(_golden_wave(), cfg, device="cpu")
    got = t_delta.add_deltas(feats).numpy()
    golden = np.load(Path(__file__).parent / "golden" / "mfcc_golden.npz")["feats"]
    assert got.shape == golden.shape
    np.testing.assert_allclose(got, golden, rtol=2e-3, atol=2e-3)


def test_mfcc_needs_a_device_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mfcc.compute_mfcc_batch(np.zeros((1, 800), np.float32))
