"""Delta / delta-delta features (Kaldi DeltaFeatures semantics; PyTorch
port of khg_tpu/features/delta.py).

Regression-window deltas per kaldi/src/feat/feature-functions.cc
(DeltaFeaturesOptions order=2 window=2; scales built recursively, each
order convolving the previous order's taps with the normalized ramp
[-w..w]/sum(j^2); frame indices clamped to [0, T-1] at the edges).

Each output order is a sum of statically shifted copies of an
edge-replicated pad of the input, weighted by the f64 host taps
rounded to f32, in the same tap order as khg_tpu, so f32 results match
it term for term.  Runs on whatever device the features are on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch


@dataclass(frozen=True)
class DeltaConfig:
    order: int = 2
    window: int = 2  # taps per side per order


def delta_scales(cfg: DeltaConfig) -> List[np.ndarray]:
    """Per-order tap vectors, scales[o] has length 2*o*window + 1
    (centered).  Mirrors DeltaFeatures::DeltaFeatures exactly."""
    scales = [np.array([1.0], dtype=np.float64)]
    for _ in range(cfg.order):
        prev = scales[-1]
        prev_offset = (len(prev) - 1) // 2
        cur_offset = prev_offset + cfg.window
        cur = np.zeros(len(prev) + 2 * cfg.window, dtype=np.float64)
        normalizer = 0.0
        for j in range(-cfg.window, cfg.window + 1):
            normalizer += j * j
            if j != 0:
                for k in range(-prev_offset, prev_offset + 1):
                    cur[j + k + cur_offset] += j * prev[k + prev_offset]
        cur /= normalizer
        scales.append(cur)
    return scales


def add_deltas(feats, cfg: DeltaConfig = DeltaConfig()) -> torch.Tensor:
    """(..., T, D) -> (..., T, D * (order + 1)) f32: base features with
    the delta orders appended along the feature axis.  A numpy input is
    taken as a CPU tensor."""
    feats = torch.as_tensor(feats)
    scales = delta_scales(cfg)
    max_offset = cfg.order * cfg.window
    t_axis = feats.dim() - 2
    T = feats.shape[t_axis]
    # edge padding: frame indices clamped to [0, T-1]
    idx = torch.arange(-max_offset, T + max_offset, device=feats.device)
    padded = feats.index_select(t_axis, idx.clamp(0, T - 1))

    outs = []
    for taps in scales:
        offset = (len(taps) - 1) // 2
        acc = None
        for j, w in enumerate(taps):
            if w == 0.0:
                continue
            start = max_offset - offset + j
            term = float(np.float32(w)) * padded.narrow(t_axis, start, T)
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.cat(outs, dim=-1)
