"""Decodable adapters: anything that yields a (T, num_indices) score matrix.

The reference routes acoustic scores through a DecodableInterface class
hierarchy with per-(frame,pdf) caching (decodable-itf.h,
decodable-am-diag-gmm.cc, decodable-ctc.cc).  Here a decodable is simply
the dense log-likelihood matrix plus the ilabel->column map — strictly
more general than the trampoline (any array-producing code plugs in) and
cache-free because the fused GEMM precomputes everything.

These adapters exist for API familiarity; the decoders accept raw
matrices directly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from khg_tpu_torch.gmm.am_gmm import AmDiagGmm
from khg_tpu_torch.lang.ctc import ctc_id2pdf
from khg_tpu_torch.model.transition_model import TransitionModel


class DecodableAmDiagGmmScaled:
    """GMM acoustic scores: loglikes[t, pdf] * scale, tid -> pdf map."""

    def __init__(
        self,
        am: AmDiagGmm,
        tm: TransitionModel,
        feats: np.ndarray,
        scale: float = 1.0,
        device=None,
    ):
        self.am = am
        self.tm = tm
        self.feats = np.asarray(feats, dtype=np.float32)
        self.scale = scale
        self.device = device
        self._loglikes = None

    @property
    def num_frames(self) -> int:
        return self.feats.shape[0]

    def loglikes(self) -> np.ndarray:
        """(T, num_pdfs) unscaled log-likelihoods (computed once, on
        ``device``: None means CUDA)."""
        if self._loglikes is None:
            from khg_tpu_torch.gmm.likelihoods import loglikes_np

            self._loglikes = loglikes_np(
                self.am.pack(), self.feats, device=self.device
            )
        return self._loglikes

    def matrix_and_map(self) -> Tuple[np.ndarray, np.ndarray, float]:
        """(loglikes, id2pdf, acoustic_scale) — what the decoders consume."""
        return self.loglikes(), self.tm.id2pdf_array(), self.scale

    def log_likelihood(self, frame: int, tid: int) -> float:
        """Per-(frame, transition-id) scaled score (reference API parity)."""
        pdf = self.tm.transition_id_to_pdf(tid)
        return float(self.scale * self.loglikes()[frame, pdf])


class DecodableCtc:
    """CTC scores: a (T, vocab) log-softmax matrix; shifted ilabel i maps to
    column i-1."""

    def __init__(self, log_softmax: np.ndarray):
        self.log_softmax = np.asarray(log_softmax, dtype=np.float32)

    @property
    def num_frames(self) -> int:
        return self.log_softmax.shape[0]

    def matrix_and_map(self) -> Tuple[np.ndarray, np.ndarray, float]:
        vocab = self.log_softmax.shape[1]
        return self.log_softmax, ctc_id2pdf(vocab), 1.0

    def log_likelihood(self, frame: int, ilabel: int) -> float:
        return float(self.log_softmax[frame, ilabel - 1])
