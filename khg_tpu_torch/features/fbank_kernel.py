"""Fused waveform -> log-mel frontend: the CUDA kernel ``csrc/fbank.cu``
and its plain PyTorch version.

Port of khg_tpu/features/pallas_fbank.py.  The frontend is linear up to
the power spectrum: DC removal, pre-emphasis, window and real DFT fold
into two host-precomputed (frame_len, F) matrices (formed in f64, as in
khg_tpu), so a frame's spectrum is two dot products and no elementwise
preprocessing survives into the kernel.  The reflect-pad gather that
builds the padded wave stays plain PyTorch outside the kernel, as it
stays XLA outside the Pallas kernel in khg_tpu.

The kernel takes those products on the tensor cores in TF32, as the
TPU kernel takes them on its matrix unit at ``Precision.HIGHEST``: both
operands are split into three TF32 parts that sum to them exactly
(``split_tf32``), and the six products of frame part i and table part j
with i + j <= 2 reproduce the product of the f32 operands.  The table
(``kernel_tables``) holds Re and Im of each bin that a mel filter uses
side by side, split and laid out in the order of the tensor cores'
operand fragments; ``fbank_plan`` mirrors the launcher's block shape and
shared memory.

``fbank_fused`` takes the kernel for CUDA tensors and the plain version
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from khg_tpu_torch.features.fbank import (
    FbankConfig,
    _dft_matrices,
    _window,
    mel_banks,
    num_frames,
)

_FLT_MIN = 1.1754944e-38


@functools.lru_cache(maxsize=8)
def folded_frontend(cfg: FbankConfig):
    """(M_re, M_im), each (frame_len, F) f32, computed in f64: the
    composition of DC removal, pre-emphasis, window and rDFT."""
    flen = cfg.frame_length
    cos_m, sin_m = _dft_matrices(cfg.fft_size)
    C = cos_m[:flen].astype(np.float64)
    S = sin_m[:flen].astype(np.float64)
    L = np.diag(_window(cfg).astype(np.float64))
    if cfg.preemph_coeff != 0.0:
        c = cfg.preemph_coeff
        E = np.eye(flen)
        E[0, 0] = 1.0 - c
        E[np.arange(flen - 1), np.arange(1, flen)] = -c
        L = E @ L
    if cfg.remove_dc_offset:
        L = (np.eye(flen) - np.full((flen, flen), 1.0 / flen)) @ L
    return (L @ C).astype(np.float32), (L @ S).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _pad_index(cfg: FbankConfig, num_samples: int, T: int) -> np.ndarray:
    """Sample index of the padded wave: frame t covers padded samples
    [t*shift, t*shift + frame_len), the same samples features/fbank.py
    frames cover (centred, mirror-reflected when snip_edges=False)."""
    shift = cfg.frame_shift
    total = (T - 1) * shift + cfg.frame_length
    left = 0 if cfg.snip_edges else cfg.frame_length // 2 - shift // 2
    v = np.arange(total) - left
    v = np.abs(v + (v < 0))  # -1 -> 0, -2 -> 1 (mirror w/o edge repeat)
    v = np.where(v >= num_samples, np.maximum(2 * num_samples - 1 - v, 0), v)
    return v.astype(np.int64)


@functools.lru_cache(maxsize=32)
def _pad_index_on(cfg: FbankConfig, num_samples: int, T: int, device: str):
    return torch.as_tensor(_pad_index(cfg, num_samples, T), device=device)


def _padded_wave(waves: torch.Tensor, cfg: FbankConfig, T: int) -> torch.Tensor:
    """(B, N) waves -> (B, (T-1)*shift + frame_len) padded samples."""
    idx = _pad_index_on(cfg, waves.shape[-1], T, str(waves.device))
    return waves[:, idx].contiguous()


def _tables(cfg: FbankConfig, device):
    """(M_re, M_im, mel^T) on ``device``, uploaded once per config."""
    return _tables_on(cfg, str(torch.device(device)))


@functools.lru_cache(maxsize=8)
def _tables_on(cfg: FbankConfig, device: str):
    m_re, m_im = folded_frontend(cfg)
    mel_t = np.ascontiguousarray(mel_banks(cfg).T)  # (F, M)
    return tuple(torch.as_tensor(x, device=device) for x in (m_re, m_im, mel_t))


def fbank_plain(padded: torch.Tensor, cfg: FbankConfig, T: int):
    """Plain PyTorch version of the kernel on the padded wave (B, L):
    returns (feats (B, T, M), log_energy (B, T))."""
    flen, shift = cfg.frame_length, cfg.frame_shift
    m_re, m_im, mel_t = _tables(cfg, padded.device)
    idx = (
        torch.arange(T, device=padded.device)[:, None] * shift
        + torch.arange(flen, device=padded.device)[None, :]
    )
    frames = padded[:, idx]  # (B, T, flen)
    s1 = frames.sum(-1)
    s2 = (frames * frames).sum(-1)
    e = s2 - s1 * s1 * (1.0 / flen) if cfg.remove_dc_offset else s2
    loge = torch.log(torch.clamp(e, min=_FLT_MIN))
    if cfg.energy_floor > 0.0:
        loge = torch.clamp(loge, min=math.log(cfg.energy_floor))
    re = frames @ m_re
    im = frames @ m_im
    power = re * re + im * im
    if not cfg.use_power:
        power = torch.sqrt(power)
    feats = power @ mel_t
    if cfg.use_log_fbank:
        feats = torch.log(torch.clamp(feats, min=_FLT_MIN))
    return feats, loge


# the launcher's constants (csrc/fbank.cu)
SMEM_LIMIT = 232448      # shared memory a block may take on an H100 (bytes)
FRAMES = 64              # frames a block: wgmma's M
CHUNK = 64               # table columns per chunk: 32 bins, Re and Im
STAGE_K = 16             # table rows per ring stage: two mma k-steps of 8
STAGES = 3               # ring stages
STAGE_FLOATS = 2 * 3 * (CHUNK // 8) * 64   # one stage: 3 parts, fragment order
PW_PAD = 8                                 # power row of a bin: frames + 8


def split_tf32(x, parts: int = 3) -> np.ndarray:
    """(parts, *x.shape) f32: ``x`` (f32) as a sum of TF32 values, each
    rounded to nearest (ties away from zero, as ``cvt.rna.tf32.f32``)
    from what the parts before it left.  A TF32 value is an f32 whose
    low 13 mantissa bits are 0: 11 significant bits, so three parts sum
    to every finite f32 of magnitude 2**-113 to 2**127 exactly, and
    integers up to 2**16 need two.  TF32 keeps f32's exponents but only
    10 fraction bits, so below that range the parts are multiples of
    2**-136 and miss the input by at most 2**-137."""
    rest = np.array(x, dtype=np.float32)
    out = np.empty((parts,) + rest.shape, dtype=np.float32)
    for i in range(parts):
        bits = rest.view(np.uint32)
        finite = (bits & 0x7F800000) != 0x7F800000
        rounded = np.where(finite, (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000), bits)
        out[i] = rounded.astype(np.uint32).view(np.float32)
        with np.errstate(invalid="ignore"):
            rest = np.where(finite, rest - out[i], np.float32(0)).astype(np.float32)
    return out


class FbankPlan(NamedTuple):
    """How ``csrc/fbank.cu`` cuts a config (blocks of ``FRAMES`` frames):
    ``kp`` the frame length rounded up to ``STAGE_K``, ``stride`` the
    padded row of the wave span in shared memory, ``rows`` its rows, and
    ``smem`` the bytes a block requests."""

    kp: int
    stride: int
    rows: int
    smem: int


def fbank_smem_bytes(frames: int, shift: int, kp: int, stride: int, M: int) -> int:
    """Mirror of the launcher's shared-memory request: the wave span
    (rounded up to 16 bytes), the ring's stages, one chunk's power (32
    bins x frames + 8) and the mel sums (M x frames + 1)."""
    rows = frames + (kp - 1) // shift
    span = -(-rows * stride // 4) * 4
    return 4 * (span + STAGES * STAGE_FLOATS + CHUNK // 2 * (frames + PW_PAD)
                + M * (frames + 1))


@functools.lru_cache(maxsize=32)
def fbank_plan(cfg: FbankConfig) -> FbankPlan:
    """The kernel's cut of ``cfg`` into blocks of ``FRAMES`` frames;
    raises ``ValueError`` for a config whose block does not fit the
    shared memory (e.g. 25 ms frames at 96 kHz)."""
    flen, shift, M = cfg.frame_length, cfg.frame_shift, cfg.num_mel_bins
    if shift < 8 or flen < 1 or M < 1:
        raise ValueError(
            f"fbank kernel: frame shift {shift} (< 8 samples), frame length "
            f"{flen} or {M} mel bins is beyond its plan")
    kp = -(-flen // STAGE_K) * STAGE_K
    stride = shift + (4 - shift) % 8  # the next >= shift that is 4 (mod 8)
    smem = fbank_smem_bytes(FRAMES, shift, kp, stride, M)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fbank kernel: {cfg} needs {smem} bytes of shared memory a block, "
            f"above the {SMEM_LIMIT} a block may take")
    rows = FRAMES + (kp - 1) // shift
    return FbankPlan(kp, stride, rows, smem)


def used_bins(cfg: FbankConfig):
    """(first, count): the FFT bins that some mel filter weighs (the DC
    and Nyquist bins never are); the kernel computes only these."""
    nz = np.flatnonzero(mel_banks(cfg).any(axis=0))
    if nz.size == 0:
        return 0, 1
    return int(nz[0]), int(nz[-1] - nz[0] + 1)


@functools.lru_cache(maxsize=8)
def kernel_tables(cfg: FbankConfig):
    """Host tables of the kernel, in numpy: ``parts`` (3, kp, ncols), the
    folded matrices with Re and Im of each used bin side by side (column
    2q Re, 2q + 1 Im of bin first + q), zero rows past the frame length
    and zero columns up to a whole chunk, split by ``split_tf32``; the
    mel weights of the used bins (M, count); each filter's range of
    nonzero weights [lo, hi) among them (M, 2) int32; and for each chunk
    the range [lo, hi) of filters that weigh one of its bins (chunks, 2)
    int32."""
    plan = fbank_plan(cfg)
    m_re, m_im = folded_frontend(cfg)
    first, count = used_bins(cfg)
    ncols = -(-2 * count // CHUNK) * CHUNK
    table = np.zeros((plan.kp, ncols), dtype=np.float32)
    table[: cfg.frame_length, 0 : 2 * count : 2] = m_re[:, first : first + count]
    table[: cfg.frame_length, 1 : 2 * count : 2] = m_im[:, first : first + count]
    mel = np.ascontiguousarray(mel_banks(cfg)[:, first : first + count])
    rng = np.zeros((mel.shape[0], 2), dtype=np.int32)
    for m, row in enumerate(mel):
        nz = np.flatnonzero(row)
        if nz.size:
            rng[m] = nz[0], nz[-1] + 1
    bins = CHUNK // 2
    chunks = np.zeros((ncols // CHUNK, 2), dtype=np.int32)
    for c in range(len(chunks)):
        nz = np.flatnonzero(mel[:, c * bins : (c + 1) * bins].any(axis=1))
        if nz.size:
            chunks[c] = nz[0], nz[-1] + 1
    return split_tf32(table), mel, rng, chunks


def fragment_order(parts: np.ndarray) -> np.ndarray:
    """(kp / 8, 3, ncols / 8, 2, 8, 4): the split table as ``wgmma``'s
    K-major B operand without swizzle, for each (k-step, part): per
    8-column group, its two 8-row x 4-value core matrices (rows are
    columns of the table, values its k), K-halves 128 bytes apart and
    column groups 256 bytes apart."""
    p, kp, ncols = parts.shape
    x = parts.reshape(p, kp // 8, 2, 4, ncols // 8, 8)  # (p, s, kg, k, j, n)
    return np.ascontiguousarray(x.transpose(1, 0, 4, 2, 5, 3))  # (s, p, j, kg, n, k)


@functools.lru_cache(maxsize=8)
def _kernel_tables_on(cfg: FbankConfig, device: str):
    parts, mel, rng, chunks = kernel_tables(cfg)
    return (torch.as_tensor(fragment_order(parts), device=device),
            *(torch.as_tensor(x, device=device) for x in (mel, rng, chunks)))


def fbank_cuda(padded: torch.Tensor, cfg: FbankConfig, T: int):
    """Launch ``csrc/fbank.cu`` on the padded wave (B, L) f32 on CUDA:
    returns (feats (B, T, M), log_energy (B, T)).  Raises ``ValueError``
    before any launch for a config beyond ``fbank_plan``."""
    from khg_tpu_torch import kernels

    plan = fbank_plan(cfg)
    if padded.device.type != "cuda":
        raise ValueError("fbank_cuda needs a CUDA tensor")
    if padded.dtype != torch.float32 or padded.dim() != 2:
        raise ValueError("padded wave must be (B, L) float32")
    padded = padded.contiguous()
    B, L = padded.shape
    flen, shift = cfg.frame_length, cfg.frame_shift
    if L < (T - 1) * shift + flen:
        raise ValueError("padded wave shorter than the frames it must cover")
    if B > 65535:
        raise ValueError("fbank_cuda takes at most 65,535 rows a call")
    table, mel, rng, chunks = _kernel_tables_on(cfg, str(padded.device))
    M, nbins = mel.shape
    feats = torch.empty((B, T, M), dtype=torch.float32, device=padded.device)
    energy = torch.empty((B, T), dtype=torch.float32, device=padded.device)
    floor = math.log(cfg.energy_floor) if cfg.energy_floor > 0.0 else -math.inf
    err = kernels.lib().launch_fbank(
        padded.data_ptr(), table.data_ptr(), mel.data_ptr(), rng.data_ptr(),
        chunks.data_ptr(), feats.data_ptr(), energy.data_ptr(), B, L, T, shift, flen, plan.kp,
        plan.stride, table.shape[2] * 8, nbins, M,
        int(cfg.remove_dc_offset), int(cfg.use_power), int(cfg.use_log_fbank),
        ctypes.c_float(floor), kernels.stream_handle(padded.device),
    )
    kernels.check("fbank", err)
    return feats, energy


def fbank_fused(waves: torch.Tensor, cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """(B, N) equal-length waves -> (B, T, M [+1]) log-mel features.

    CUDA tensors run the kernel; CPU tensors the plain version.  Dither
    is not supported: dither the wave first (as in khg_tpu)."""
    if cfg.dither != 0.0:
        raise ValueError(
            "fbank_fused: dither the waveform first (an in-kernel "
            "generator would break parity with the plain path)"
        )
    if not cfg.raw_energy:
        raise ValueError("fbank_fused supports raw_energy only")
    waves = torch.atleast_2d(waves.to(torch.float32))
    T = num_frames(cfg, waves.shape[-1])
    padded = _padded_wave(waves, cfg, T)
    if waves.device.type == "cuda":
        feats, energy = fbank_cuda(padded, cfg, T)
    else:
        feats, energy = fbank_plain(padded, cfg, T)
    if cfg.use_energy:
        feats = torch.cat([energy[..., None], feats], dim=-1)
    return feats
