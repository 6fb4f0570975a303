"""MFCC features on the device: DCT-II + liftering over the log-mel
frontend (PyTorch port of khg_tpu/features/mfcc.py).

MFCC semantics follow the published Kaldi formulas
(kaldi/src/feat/feature-mfcc.cc, matrix-functions.cc ComputeDctMatrix,
mel-computations.cc ComputeLifterCoeffs):

  c = lifter * (DCT_II @ log(mel @ |X|^2));  c[0] <- log-energy if use_energy

The log-mel (with the raw log-energy column first when ``use_energy``)
comes from ``fbank_fused``: the fbank kernel (csrc/fbank.cu) for CUDA
tensors, its plain version for CPU tensors.  Liftering folds into the
DCT matrix rows on the host, so the cepstral stage is one
(num_bins, num_ceps) fp32 ``torch.matmul`` outside the kernel (TF32 is
off, the counterpart of khg_tpu's ``precision=HIGHEST``), then the
energy overwrites c0.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from khg_tpu_torch.features.fbank import FbankConfig, dither_waves
from khg_tpu_torch.features.fbank_kernel import fbank_fused
from khg_tpu_torch.utils.platform import DeviceLike, resolve_device


@dataclass(frozen=True)
class MfccConfig:
    """Kaldi MfccOptions analogue.  ``fbank`` carries the shared frontend
    (window/mel) settings; num_mel_bins defaults to Kaldi's 23 for MFCC.
    """

    fbank: FbankConfig = field(
        default_factory=lambda: FbankConfig(num_mel_bins=23)
    )
    num_ceps: int = 13
    use_energy: bool = True
    cepstral_lifter: float = 22.0

    def frontend_cfg(self) -> FbankConfig:
        """Fbank settings for the mel-energy stage: log mel energies,
        energy handled here (the C0 slot), power spectrum."""
        return replace(
            self.fbank, use_log_fbank=True, use_energy=self.use_energy
        )


def dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """(num_rows, num_cols) orthonormal DCT-II matrix, Kaldi's
    ComputeDctMatrix convention: row 0 = sqrt(1/N), row k =
    sqrt(2/N) cos(pi/N (n+0.5) k)."""
    n = np.arange(num_cols)
    k = np.arange(num_rows)[:, None]
    m = np.sqrt(2.0 / num_cols) * np.cos(
        np.pi / num_cols * (n[None, :] + 0.5) * k
    )
    m[0, :] = np.sqrt(1.0 / num_cols)
    return m.astype(np.float64)


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    """Kaldi ComputeLifterCoeffs: l[i] = 1 + 0.5 Q sin(pi i / Q)."""
    i = np.arange(num_ceps, dtype=np.float64)
    return 1.0 + 0.5 * q * np.sin(math.pi * i / q)


def lifted_dct_matrix(cfg: MfccConfig) -> np.ndarray:
    """(num_mel_bins, num_ceps) host-folded transform: log-mel energies
    @ this = liftered cepstra.  Liftering is a per-row scale of the DCT
    matrix, so it costs nothing at run time."""
    m = dct_matrix(cfg.num_ceps, cfg.fbank.num_mel_bins)
    if cfg.cepstral_lifter != 0.0:
        m = m * lifter_coeffs(cfg.num_ceps, cfg.cepstral_lifter)[:, None]
    return m.T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _lifted_dct_on(cfg: MfccConfig, device: str) -> torch.Tensor:
    return torch.as_tensor(lifted_dct_matrix(cfg), device=device)


def _mfcc_from_logmel(logmel: torch.Tensor, cfg: MfccConfig) -> torch.Tensor:
    """(..., T, num_mel_bins [+1 energy col]) log-mel -> (..., T, num_ceps).

    When use_energy the frontend prepended a log-energy column; it is
    split off, the DCT+lifter product runs on the mel columns, and the
    energy replaces c0 (Kaldi feature-mfcc.cc:63-78 ordering: lifter
    first, then the energy overwrite — liftering does not scale the
    energy slot because lifter_coeffs[0] == 1).
    """
    energy = None
    if cfg.use_energy:
        energy = logmel[..., 0]
        logmel = logmel[..., 1:]
    feats = torch.matmul(logmel, _lifted_dct_on(cfg, str(logmel.device)))
    if energy is not None:
        feats = torch.cat([energy[..., None], feats[..., 1:]], dim=-1)
    return feats


def compute_mfcc_batch(
    waves, cfg: MfccConfig = MfccConfig(),
    dither_generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(B, num_samples) equal-length waves -> (B, T, num_ceps) f32 on the
    device.  A tensor is computed where it lies (CUDA: the fbank kernel;
    CPU: its plain version); a numpy array goes to ``device`` (None
    means CUDA and raises without a card).  ``cfg.fbank.dither`` with a
    ``dither_generator`` adds ``dither_waves``' noise to the waves
    before the frontend, as khg_tpu adds its key's noise before framing;
    without a generator nothing is added."""
    if not isinstance(waves, torch.Tensor):
        waves = torch.as_tensor(np.asarray(waves, np.float32),
                                device=resolve_device(device))
    fcfg = cfg.frontend_cfg()
    waves = dither_waves(waves, fcfg.dither, dither_generator)
    logmel = fbank_fused(waves, replace(fcfg, dither=0.0))
    return _mfcc_from_logmel(logmel, cfg)


def compute_mfcc(
    wave, cfg: MfccConfig = MfccConfig(),
    dither_generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """(num_samples,) waveform -> (T, num_ceps) MFCC features on the
    host, computed on ``device`` as ``compute_mfcc_batch`` does."""
    out = compute_mfcc_batch(np.asarray(wave, np.float32)[None, :], cfg,
                             dither_generator, device)
    return out[0].cpu().numpy()
