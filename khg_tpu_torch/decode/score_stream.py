"""Streamed device->host acoustic-score transfer for decoding (port of
khg_tpu/decode/score_stream.py).

The decoders (decode/lattice.py, the native core) run on the HOST over
host-resident loglike matrices, while GMM scoring runs on the card.
Fetching every utterance's scores before decoding serialises transfer
and decode.

``stream_scores`` casts each utterance's slice on the device, issues
every copy at once as a non-blocking copy into pinned host memory, and
records one CUDA event per utterance; the generator it returns waits on
each utterance's own event before yielding it, so the caller decodes
utterance u while u+1.. are still in flight.  With
``fetch_dtype="float16"`` (or ``"bfloat16"``) the scores cross the link
at half width and are widened back to f32 on the host: acoustic scores
are O(-1e2) nats with ~1e-3 relative f16 error, far inside the
decoder's beam slack (word outputs are pinned unchanged by
tests/test_torch_score_stream.py), but exact-parity consumers should
keep the f32 default.

Mirrors the role of the reference's per-utterance decodable loop
(kaldi-hmm-gmm csrc/decoder-wrappers.cc DecodeUtteranceLatticeFaster):
the reference scores lazily per frame on the CPU; here scoring is one
kernel launch per length bucket and the transfer is the cost to hide.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

_FETCH_DTYPES = {None: None, "float16": torch.float16, "bfloat16": torch.bfloat16}


def stream_scores(
    loglikes,
    fetch_dtype: Optional[str] = None,
) -> Iterator[np.ndarray]:
    """Per-utterance (T, P) f32 host arrays of ``loglikes``: a (U, T, P)
    tensor or a sequence of (T_u, P) tensors, on the card or the CPU.

    Every copy is issued when this is called; the returned generator
    yields the utterances in order, each once its own copy has landed.
    ``fetch_dtype``: optional narrow dtype ("float16"/"bfloat16") for
    the device->host copy; the yielded arrays are always f32.
    """
    if fetch_dtype not in _FETCH_DTYPES:
        raise ValueError(f"unsupported fetch_dtype {fetch_dtype!r}")
    dtype = _FETCH_DTYPES[fetch_dtype]
    copies = []
    for part in loglikes:
        if dtype is not None:
            part = part.to(dtype)
        if part.device.type == "cuda":
            host = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
            host.copy_(part, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(part.device))
        else:
            host, event = part.clone(), None
        copies.append((host, event))
    return _landed(copies)


def _landed(copies) -> Iterator[np.ndarray]:
    for host, event in copies:
        if event is not None:
            event.synchronize()
        # numpy has no bf16: widen in torch
        yield host.to(torch.float32).numpy()


def decode_scores_streamed(
    decoder,
    loglikes,
    id2pdf: np.ndarray,
    acoustic_scale: float = 1.0,
    allow_partial: bool = True,
    fetch_dtype: Optional[str] = None,
    max_workers: Optional[int] = None,
):
    """decode_utterances_parallel over device scores (a (U, T, P) tensor
    or a sequence of (T_u, P) tensors), with the per-utterance transfers
    streamed behind the decoding threads."""
    from khg_tpu_torch.decode.lattice import decode_utterances_parallel

    return decode_utterances_parallel(
        decoder,
        stream_scores(loglikes, fetch_dtype=fetch_dtype),
        id2pdf,
        acoustic_scale=acoustic_scale,
        allow_partial=allow_partial,
        max_workers=max_workers,
    )
