"""Dither in the port's frontend (features/fbank.py dither_waves,
compute_fbank(_batch) and compute_mfcc(_batch) with a dither_generator)
against khg_tpu's dither_key, on the CPU.

JAX's noise bits cannot be drawn by torch, so the cross-package cases
feed JAX's own noise to the undithered port: khg_tpu with key k must
equal the port on w + dither * jax.random.normal(k, w.shape), which
shows the noise enters at the same point (after the f32 cast, before
framing, so a mirrored edge sample carries its source's noise).

Tolerances: 1e-3 absolute against khg_tpu, fbank and MFCC alike
(tests/test_torch_fbank.py's for the port's plain f32 fbank against
khg_tpu's XLA path; on these waves the gaps are ~1e-5 for fbank and
~6e-5 for MFCC, whose folded f32 frontend differs from khg_tpu's
direct one); the port against itself to the bit."""

import jax
import numpy as np
import pytest
import torch

from khg_tpu.features import fbank as j_fbank
from khg_tpu.features import mfcc as j_mfcc
from khg_tpu_torch.features import fbank as t_fbank
from khg_tpu_torch.features import mfcc as t_mfcc
from khg_tpu_torch.features.fbank_kernel import fbank_fused
import tests.torch_parity  # noqa: F401  (two torch threads per worker)

DITHER = 1.0
FB = dict(sample_rate=8000, num_mel_bins=23)


def _waves(rows=2, seed=5):
    """Speech-level integer-valued waves of 0.7 s at 8 kHz."""
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal((rows, 5600)) * 300).astype(np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _cfgs(dither):
    jf = j_fbank.FbankConfig(dither=dither, **FB)
    tf = t_fbank.FbankConfig(dither=dither, **FB)
    return jf, tf, j_mfcc.MfccConfig(fbank=jf), t_mfcc.MfccConfig(fbank=tf)


def _port(kind, waves, tf, tm, gen=None):
    """The port's features of ``waves`` (2-D) as numpy, by ``kind``."""
    if kind == "fbank":
        return np.stack([t_fbank.compute_fbank(w, tf, gen, device="cpu") for w in waves])
    if kind == "fbank_batch":
        return t_fbank.compute_fbank_batch(torch.as_tensor(waves), tf, gen).numpy()
    if kind == "mfcc":
        return np.stack([t_mfcc.compute_mfcc(w, tm, gen, device="cpu") for w in waves])
    return t_mfcc.compute_mfcc_batch(torch.as_tensor(waves), tm, gen).numpy()


def _ref(kind, waves, jf, jm, keys=None):
    """khg_tpu's features of ``waves`` (one key a row, or none)."""
    if kind == "fbank":
        return np.stack([j_fbank.compute_fbank(w, jf, None if keys is None else k)
                         for w, k in zip(waves, keys or [None] * len(waves))])
    if kind == "fbank_batch":
        return np.asarray(j_fbank.compute_fbank_batch(waves, jf, keys))
    if kind == "mfcc":
        return np.stack([j_mfcc.compute_mfcc(w, jm, None if keys is None else k)
                         for w, k in zip(waves, keys or [None] * len(waves))])
    return np.asarray(j_mfcc.compute_mfcc_batch(waves, jm, keys))


def _close(kind, got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


KINDS = ["fbank", "fbank_batch", "mfcc", "mfcc_batch"]


@pytest.mark.parametrize("kind", KINDS)
def test_dither_without_generator_adds_nothing(kind):
    """(a) dither=1.0 and no generator: khg_tpu's features with no key,
    and the port's equal to its undithered ones to the bit."""
    waves = _waves()
    jf, tf, jm, tm = _cfgs(DITHER)
    got = _port(kind, waves, tf, tm)
    _close(kind, got, _ref(kind, waves, jf, jm))
    _jf0, tf0, _jm0, tm0 = _cfgs(0.0)
    np.testing.assert_array_equal(got, _port(kind, waves, tf0, tm0))


def test_compute_fbank_with_dither_no_longer_raises():
    w = _waves(1)[0]
    jf, tf, _jm, _tm = _cfgs(DITHER)
    got = t_fbank.compute_fbank(w, tf, device="cpu")
    np.testing.assert_allclose(got, j_fbank.compute_fbank(w, jf), rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_seeded_generator_is_dither_waves(kind):
    """(b) a seeded generator gives the undithered port on
    dither_waves(w) from an identically seeded generator, to the bit."""
    waves = _waves()
    _jf, tf, _jm, tm = _cfgs(DITHER)
    _jf0, tf0, _jm0, tm0 = _cfgs(0.0)
    got = _port(kind, waves, tf, tm, _gen(3)) if kind.endswith("batch") else np.stack(
        [_port(kind, w[None], tf, tm, g)[0]
         for w, g in zip(waves, (_gen(3), _gen(4)))])
    if kind.endswith("batch"):
        noisy = t_fbank.dither_waves(torch.as_tensor(waves), DITHER, _gen(3)).numpy()
    else:
        noisy = np.stack([t_fbank.dither_waves(torch.as_tensor(w), DITHER, g).numpy()
                          for w, g in zip(waves, (_gen(3), _gen(4)))])
    assert not np.array_equal(noisy, waves)
    np.testing.assert_array_equal(got, _port(kind, noisy, tf0, tm0))


@pytest.mark.parametrize("kind", KINDS)
def test_jax_key_noise_enters_where_the_port_adds_it(kind):
    """(c) khg_tpu with key k against the undithered port on
    w + dither * jax.random.normal(k, w.shape), default centred frames
    (snip_edges=False: mirrored edges carry their source's noise)."""
    waves = _waves()
    jf, _tf, jm, _tm = _cfgs(DITHER)
    _jf0, tf0, _jm0, tm0 = _cfgs(0.0)
    if kind.endswith("batch"):
        key = jax.random.PRNGKey(7)
        ref = _ref(kind, waves, jf, jm, key)
        noise = np.asarray(DITHER * jax.random.normal(key, waves.shape))
    else:
        keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
        ref = _ref(kind, waves, jf, jm, keys)
        noise = np.stack([np.asarray(DITHER * jax.random.normal(k, waves.shape[1:]))
                          for k in keys])
    got = _port(kind, waves + noise, tf0, tm0)
    _close(kind, got, ref)
    # the noise moved the features: the check is not vacuous
    assert np.abs(got - _port(kind, waves, tf0, tm0)).max() > 1e-2


@pytest.mark.parametrize("dither", [1.0, 0.25])
def test_noise_moments(dither):
    """(d) over 2e5 samples the noise's mean lies within 5 sigma of 0
    (sigma = dither / sqrt(n)) and its standard deviation within 5 sigma
    of dither (sigma ~ dither / sqrt(2n))."""
    n = 200_000
    base = torch.full((2, n // 2), 17.0)
    noise = (t_fbank.dither_waves(base, dither, _gen(11)) - base).double()
    assert noise.dtype == torch.float64 and noise.shape == base.shape
    mean, std = float(noise.mean()), float(noise.std())
    assert abs(mean) <= 5 * dither / np.sqrt(n)
    assert abs(std - dither) <= 5 * dither / np.sqrt(2 * n)
    assert torch.equal(t_fbank.dither_waves(base, dither, None), base)
    assert torch.equal(t_fbank.dither_waves(base, 0.0, _gen(11)), base)


@pytest.mark.parametrize("kind", KINDS)
def test_same_seed_same_features(kind):
    """(e) one seed gives the same features twice; another seed others."""
    waves = _waves()
    _jf, tf, _jm, tm = _cfgs(DITHER)
    a = _port(kind, waves, tf, tm, _gen(21))
    b = _port(kind, waves, tf, tm, _gen(21))
    c = _port(kind, waves, tf, tm, _gen(22))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_fused_frontend_still_refuses_dither():
    """Kernel C's entry point takes no noise, as khg_tpu's Pallas one."""
    _jf, tf, _jm, _tm = _cfgs(DITHER)
    with pytest.raises(ValueError, match="dither"):
        fbank_fused(torch.as_tensor(_waves()), tf)


@pytest.mark.parametrize("feature_type", ["fbank", "mfcc"])
def test_extract_features_refuses_dither(tmp_path, feature_type):
    """extract_features runs kernel C's entry point for either feature
    type, so it refuses dither as khg_tpu's Pallas frontend does."""
    from khg_tpu_torch.data.wav import write_wav
    from khg_tpu_torch.recipes.yesno_wav import WavCorpus, extract_features

    write_wav(tmp_path / "u.wav", _waves(1)[0], 8000)
    corpus = WavCorpus(["u"], [tmp_path / "u.wav"], [["YES"]], [])
    _jf, tf, _jm, tm = _cfgs(DITHER)
    with pytest.raises(ValueError, match="dither"):
        extract_features(corpus, tf, feature_type=feature_type,
                         mfcc_cfg=tm if feature_type == "mfcc" else None, device="cpu")
    _jf0, tf0, _jm0, tm0 = _cfgs(0.0)
    out = extract_features(corpus, tf0, feature_type=feature_type,
                           mfcc_cfg=tm0 if feature_type == "mfcc" else None, device="cpu")
    assert np.isfinite(out.feats[0]).all()
