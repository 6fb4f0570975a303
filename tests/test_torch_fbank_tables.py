"""The fbank frontend's folded matrices against the frontend's steps.

``features/fbank_kernel.folded_frontend`` folds DC removal,
pre-emphasis, the window and the real DFT of a frame into two
(frame_length, F) f32 matrices, which both the CUDA kernel and its
plain version apply.  Here the same steps run one by one in f64 on
each unit frame (``numpy.fft.rfft`` for the DFT): every entry of the
folded matrices must be that exact map to within two f32 steps at the
matrices' largest magnitude (one for rounding the map to f32, one for
the f32 DFT tables that it is folded from), for each sample rate a
25 ms frame takes to an FFT size of 256 to 2,048 and with each step
switched off or changed.
"""

import numpy as np
import pytest

from khg_tpu_torch.features.fbank import FbankConfig, _window
from khg_tpu_torch.features.fbank_kernel import folded_frontend

_CFGS = {
    "8k": dict(sample_rate=8000, num_mel_bins=23),
    "16k": dict(),
    "22k": dict(sample_rate=22050),
    "44k": dict(sample_rate=44100),
    "48k": dict(sample_rate=48000),
    "no-dc": dict(remove_dc_offset=False),
    "no-preemph": dict(preemph_coeff=0.0),
    "hamming": dict(window_type="hamming"),
    "rectangular": dict(sample_rate=8000, window_type="rectangular"),
}


def _exact_map(cfg):
    """(re, im), each (frame_length, F) f64: the frontend's steps on each
    unit frame."""
    x = np.eye(cfg.frame_length)
    if cfg.remove_dc_offset:
        x = x - x.mean(-1, keepdims=True)
    prev = np.concatenate([x[:, :1], x[:, :-1]], -1)
    y = (x - cfg.preemph_coeff * prev) * _window(cfg).astype(np.float64)
    spec = np.fft.rfft(y, n=cfg.fft_size)
    return spec.real, spec.imag


@pytest.mark.parametrize("kw", list(_CFGS.values()), ids=list(_CFGS))
def test_folded_frontend_is_the_steps(kw):
    cfg = FbankConfig(**kw)
    m_re, m_im = folded_frontend(cfg)
    e_re, e_im = _exact_map(cfg)
    F = cfg.fft_size // 2 + 1
    assert m_re.dtype == m_im.dtype == np.float32
    assert m_re.shape == m_im.shape == (cfg.frame_length, F)
    scale = max(np.abs(e_re).max(), np.abs(e_im).max())
    steps = 2 * float(np.spacing(np.float32(scale)))
    assert np.abs(m_re - e_re).max() <= steps
    assert np.abs(m_im - e_im).max() <= steps
