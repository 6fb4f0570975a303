"""Log-mel filterbank features (PyTorch port of khg_tpu/features/fbank.py).

``FbankConfig`` and the numpy matrix builders (window, mel banks, DFT
matrices, frame count) are copied from khg_tpu unchanged;
``compute_fbank_batch`` (``compute_fbank`` for one wave) is the plain
PyTorch counterpart of khg_tpu's XLA path: framing is an index gather,
DC removal, pre-emphasis and windowing are elementwise, and the DFT and
mel projection are two matrix products.  The fused CUDA frontend lives in
``features/fbank_kernel.py``.

Defaults follow the Kaldi/lhotse fbank convention: 25 ms windows, 10 ms
shift, preemphasis 0.97, povey window, 80 mel bins, snip_edges=False.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from khg_tpu_torch.utils.platform import DeviceLike, resolve_device


@dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 80
    low_freq: float = 20.0
    high_freq: float = 0.0  # <= 0: offset from Nyquist
    preemph_coeff: float = 0.97
    window_type: str = "povey"  # povey | hamming | hanning | rectangular
    remove_dc_offset: bool = True
    snip_edges: bool = False
    use_energy: bool = False
    raw_energy: bool = True   # energy before preemphasis/windowing
    energy_floor: float = 0.0  # absolute floor on frame energy (0 = off)
    dither: float = 0.0
    use_log_fbank: bool = True
    use_power: bool = True    # power spectrum; False = magnitude

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000)

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.frame_length:
            n *= 2
        return n


def _window(cfg: FbankConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2 * math.pi / (n - 1)
    i = np.arange(n)
    if cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif cfg.window_type == "rectangular":
        w = np.ones(n)
    else:
        raise ValueError(cfg.window_type)
    return w.astype(np.float32)


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """(num_bins, fft_size//2 + 1) triangular mel filter matrix."""
    num_fft_bins = cfg.fft_size // 2
    nyquist = 0.5 * cfg.sample_rate
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_low = _mel_scale(cfg.low_freq)
    mel_high = _mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    fft_bin_width = cfg.sample_rate / cfg.fft_size

    bins = np.zeros((cfg.num_mel_bins, num_fft_bins + 1), dtype=np.float32)
    for b in range(cfg.num_mel_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        for i in range(num_fft_bins):
            mel = _mel_scale(fft_bin_width * i)
            if left < mel < right:
                if mel <= center:
                    bins[b, i] = (mel - left) / (center - left)
                else:
                    bins[b, i] = (right - mel) / (right - center)
    return bins


def _dft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices (n_fft, n_fft//2+1) — the GEMM form of rfft."""
    k = np.arange(n_fft // 2 + 1)
    t = np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(t, k) / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def num_frames(cfg: FbankConfig, num_samples: int) -> int:
    if cfg.snip_edges:
        if num_samples < cfg.frame_length:
            return 0
        return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift
    return (num_samples + cfg.frame_shift // 2) // cfg.frame_shift



def frame_indices(cfg: FbankConfig, num_samples: int, T: int) -> np.ndarray:
    """(T, frame_length) sample index of every frame position; with
    snip_edges=False frames are centred and the edges mirror without
    repeating the edge sample (kaldi style)."""
    frame_len = cfg.frame_length
    shift = cfg.frame_shift
    if cfg.snip_edges:
        return np.arange(T)[:, None] * shift + np.arange(frame_len)[None, :]
    mid = np.arange(T) * shift + shift // 2
    idx = mid[:, None] + (np.arange(frame_len) - frame_len // 2)[None, :]
    idx = np.where(idx < 0, -idx - 1, idx)
    return np.where(idx >= num_samples, 2 * num_samples - 1 - idx, idx)


def _log_energy(frames: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """Per-frame log energy with the Kaldi floor semantics (last axis)."""
    e = torch.sum(frames * frames, dim=-1)
    loge = torch.log(torch.clamp(e, min=1.1754944e-38))
    if cfg.energy_floor > 0.0:
        loge = torch.clamp(loge, min=math.log(cfg.energy_floor))
    return loge


def dither_waves(
    waves: torch.Tensor, dither: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """``waves`` (cast to f32) plus ``dither`` times standard normal
    noise drawn from ``generator``; unchanged when ``dither`` is 0 or no
    generator is given (khg_tpu adds nothing without a key).

    The generator must live on the waves' device.  CPU and CUDA Philox
    streams differ, so a seed reproduces its noise on one device type
    only; JAX's bits are not reproduced at all."""
    waves = waves.to(torch.float32)
    if dither == 0.0 or generator is None:
        return waves
    return waves + dither * torch.randn(
        waves.shape, generator=generator, device=waves.device,
        dtype=torch.float32,
    )


def compute_fbank_batch(
    waves: torch.Tensor, cfg: FbankConfig = FbankConfig(),
    dither_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(B, num_samples) equal-length batch -> (B, T, num_mel_bins [+1]).

    With ``cfg.dither`` and a ``dither_generator`` the noise of
    ``dither_waves`` is added to the whole wave before framing, so a
    mirrored edge sample carries its source's noise (as khg_tpu; not
    Kaldi's per-frame noise)."""
    waves = dither_waves(waves, cfg.dither, dither_generator)
    T = num_frames(cfg, waves.shape[-1])
    dev = waves.device
    idx = torch.as_tensor(
        frame_indices(cfg, waves.shape[-1], T), dtype=torch.int64, device=dev
    )
    frames = waves[..., idx]  # (B, T, frame_len)
    if cfg.remove_dc_offset:
        frames = frames - torch.mean(frames, dim=-1, keepdim=True)
    log_energy = None
    if cfg.use_energy and cfg.raw_energy:
        log_energy = _log_energy(frames, cfg)
    if cfg.preemph_coeff != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemph_coeff * prev
    frames = frames * torch.as_tensor(_window(cfg), device=dev)
    if cfg.use_energy and not cfg.raw_energy:
        log_energy = _log_energy(frames, cfg)
    pad = cfg.fft_size - cfg.frame_length
    if pad:
        frames = torch.nn.functional.pad(frames, (0, pad))
    cos_m, sin_m = (torch.as_tensor(m, device=dev) for m in _dft_matrices(cfg.fft_size))
    re = torch.matmul(frames, cos_m)
    im = torch.matmul(frames, sin_m)
    power = re * re + im * im
    if not cfg.use_power:
        power = torch.sqrt(power)
    mel = torch.as_tensor(mel_banks(cfg), device=dev)
    feats = torch.matmul(power, mel.T)
    if cfg.use_log_fbank:
        feats = torch.log(torch.clamp(feats, min=1.1754944e-38))
    if log_energy is not None:
        feats = torch.cat([log_energy[..., None], feats], dim=-1)
    return feats


def compute_fbank(
    wave: np.ndarray, cfg: FbankConfig = FbankConfig(),
    dither_generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """(num_samples,) waveform -> (T, num_mel_bins [+1]) features as
    numpy, computed by ``compute_fbank_batch`` on ``device`` (None:
    CUDA), dithered as it dithers."""
    w = torch.as_tensor(np.asarray(wave, np.float32), device=resolve_device(device))
    return compute_fbank_batch(w[None], cfg, dither_generator)[0].cpu().numpy()
