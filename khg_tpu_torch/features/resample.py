"""Waveform resampling and speed perturbation (PyTorch port of
khg_tpu/features/resample.py).

The reference's recipes triple the training set with lhotse
``cut_set.perturb_speed(0.9/1.1)`` before fbank extraction
(reference egs/yesno/local/compute_fbank_yesno.py:68).  Speed
perturbation is waveform resampling by 1/factor with the sample rate
relabeled: a factor-f copy is the same audio played f times faster
(duration/f, pitch*f).

Rational-ratio windowed-sinc resampling as ONE strided convolution on
the device, as khg_tpu's ``lax.conv_general_dilated``: the wave is
upsampled by q by inserting q-1 zeros between samples (khg_tpu's
``lhs_dilation``), filtered by a Hann-windowed sinc lowpass and
downsampled by p (the stride) in one ``conv1d`` in full fp32 (cuDNN's
TF32 is off, see khg_tpu_torch/__init__.py).  The filter is built on
the host once per (p, q), in f64, and cached.

Semantics follow the classic streaming resamplers (Kaldi's
LinearResample / sox): cutoff a little below the lower Nyquist,
``num_zeros`` sinc lobes per side, even-symmetric filter, output length
ceil(n * q / p).
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from khg_tpu_torch.utils.platform import DeviceLike, resolve_device

__all__ = ["resample_waveform", "perturb_speed", "speed_perturb_corpus"]


def _as_ratio(sr_in: int, sr_out: int) -> Tuple[int, int]:
    """(p, q) with sr_out/sr_in == q/p in lowest terms."""
    f = Fraction(int(sr_out), int(sr_in))
    return f.denominator, f.numerator


@functools.lru_cache(maxsize=32)
def _polyphase_filter(p: int, q: int, num_zeros: int) -> np.ndarray:
    """Hann-windowed sinc lowpass for up-q/down-p resampling, f32.

    Designed at the upsampled rate (sr_in * q): cutoff 0.95 of the
    smaller Nyquist, gain q (each output draws from 1/q nonzero
    upsampled taps).  Odd length, centered."""
    cutoff = 0.95 * 0.5 / max(p, q)  # cycles per upsampled sample
    half = int(np.ceil(num_zeros / (2.0 * cutoff)))
    t = np.arange(-half, half + 1, dtype=np.float64)
    taps = 2.0 * cutoff * np.sinc(2.0 * cutoff * t)
    window = 0.5 + 0.5 * np.cos(np.pi * t / half)  # Hann, zero at edges
    return (q * taps * window).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _filter_on(p: int, q: int, num_zeros: int, device: str) -> torch.Tensor:
    """The filter reversed (conv1d correlates), as a (1, 1, taps) tensor."""
    h = _polyphase_filter(p, q, num_zeros)
    return torch.as_tensor(h[::-1].copy(), device=device)[None, None, :]


def _out_len(n: int, p: int, q: int) -> int:
    return int(-(-n * q // p))  # ceil(n*q/p)


def resample_waveform(
    wav, sr_in: int, sr_out: int, num_zeros: int = 10,
    device: DeviceLike = None,
) -> np.ndarray:
    """Resample a 1-D waveform from sr_in to sr_out (f32 in, f32 out)
    by one strided convolution on ``device`` (None means CUDA and
    raises without a card; "cpu" for the CPU).  Output length
    ceil(n * sr_out / sr_in); edges are zero-padded (the filter sees
    silence outside the signal, as in Kaldi's LinearResample)."""
    dev = resolve_device(device)
    wav = np.asarray(wav, dtype=np.float32)
    if wav.ndim != 1:
        raise ValueError("resample_waveform takes one utterance")
    if sr_in == sr_out:
        return wav
    p, q = _as_ratio(sr_in, sr_out)
    h = _filter_on(p, q, num_zeros, str(dev))
    half = (h.shape[-1] - 1) // 2
    n = wav.shape[0]
    n_out = _out_len(n, p, q)
    # zero-stuff (q-1 zeros between samples), then pad `half` on the left
    # (centres the filter on output 0 at input time 0) and half+p+q on
    # the right: the padded length (n-1)q+1+2*half+p+q minus the filter
    # span 2*half+1 gives floor(nq/p)+2 >= ceil(nq/p) outputs for ANY
    # p/q (half+p alone under-produced for q > 2p, truncating the tail
    # when upsampling by more than 2x)
    up = torch.zeros(half + (n - 1) * q + 1 + half + p + q, device=dev)
    up[half : half + (n - 1) * q + 1 : q] = torch.as_tensor(wav, device=dev)
    out = F.conv1d(up[None, None, :], h, stride=p)[0, 0]
    assert out.shape[0] >= n_out, (out.shape, n_out, p, q)
    return out[:n_out].cpu().numpy()


def _speed_ratio(factor: float) -> Tuple[int, int]:
    """(sr_in, sr_out) in lowest terms for a speed factor: n -> n/factor
    samples, so sr_out/sr_in = 1/factor."""
    f = Fraction(factor).limit_denominator(1000)
    p, q = f.numerator, f.denominator
    g = int(np.gcd(p, q))
    return p // g, q // g


def perturb_speed(
    wav, sample_rate: int, factor: float, num_zeros: int = 10,
    device: DeviceLike = None,
) -> np.ndarray:
    """Speed-perturbed copy at the SAME sample rate (sox `speed`,
    lhotse perturb_speed): duration /factor, pitch and formants *factor.

    Implemented as resampling from sample_rate to sample_rate/factor
    and relabeling; factor must give a rational ratio (0.9, 1.1, ... do).
    ``sample_rate`` is accepted for lhotse API symmetry and unused: the
    p/q ratio from ``factor`` fully determines the anti-alias filter.
    """
    if factor == 1.0:
        resolve_device(device)
        return np.asarray(wav, dtype=np.float32)
    sr_in, sr_out = _speed_ratio(factor)
    return resample_waveform(wav, sr_in=sr_in, sr_out=sr_out,
                             num_zeros=num_zeros, device=device)


def speed_perturb_corpus(
    wavs: Sequence[np.ndarray],
    sample_rate: int,
    factors: Sequence[float] = (0.9, 1.0, 1.1),
    num_zeros: int = 10,
    device: DeviceLike = None,
):
    """lhotse-style corpus tripling: one copy per factor, original order
    preserved within each factor block (cut_set + perturb(0.9) +
    perturb(1.1) semantics).  Returns (wavs_out, src_indices) where
    src_indices[i] is the original utterance index of output i — use it
    to replicate transcripts.  One convolution per utterance, as
    khg_tpu (a batched convolution may pick another summation order)."""
    resolve_device(device)
    out, src = [], []
    for f in factors:
        for i, w in enumerate(wavs):
            out.append(perturb_speed(w, sample_rate, f, num_zeros, device))
            src.append(i)
    return out, src
