"""Streamed score fetch in the port (khg_tpu_torch/decode/score_stream.py)
against khg_tpu's on the same arrays: the yielded f32 host matrices,
bitwise, with and without a narrow fetch dtype; streamed decoding equal
to list decoding; and a float16 fetch that leaves every decoded word
unchanged on the trained yesno system."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khg_tpu.decode.score_stream import stream_scores as j_stream_scores
from khg_tpu.gmm.likelihoods import loglikes_np as j_loglikes_np
from khg_tpu_torch.decode.lattice import (
    LatticeFasterDecoder,
    LatticeFasterDecoderConfig,
    decode_utterance_lattice_faster,
    decode_utterances_parallel,
)
from khg_tpu_torch.decode.score_stream import decode_scores_streamed, stream_scores
from tests.test_decode import trained_and_graph  # noqa: F401
from tests.torch_parity import port_copy


@pytest.mark.parametrize("fetch_dtype", [None, "float16", "bfloat16"])
def test_stream_scores_matches_jax(fetch_dtype):
    """Bitwise equal to khg_tpu's stream, including values that round
    differently in f16/bf16, overflow f16, and the -1e9 padding."""
    rng = np.random.default_rng(0)
    ll = (rng.standard_normal((5, 17, 23)) * 300).astype(np.float32)
    ll[1, 3:] = -1e9
    ll[2, 0, :4] = [70000.0, -0.0, 1e-30, 1.00048828125]
    got = list(stream_scores(torch.from_numpy(ll), fetch_dtype=fetch_dtype))
    ref = list(j_stream_scores(jnp.asarray(ll), fetch_dtype=fetch_dtype))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == r.shape
        assert np.array_equal(g.view(np.uint32), r.view(np.uint32))


def test_stream_scores_takes_a_list_and_copies():
    """A sequence of (T_u, P) tensors streams like a padded tensor; the
    yielded arrays are copies, not views of the scores."""
    rng = np.random.default_rng(1)
    parts = [torch.from_numpy(rng.standard_normal((t, 7)).astype(np.float32))
             for t in (3, 9, 1)]
    got = list(stream_scores(parts))
    for g, p in zip(got, parts):
        assert np.array_equal(g, p.numpy())
    parts[0].zero_()
    assert got[0].any()


def test_stream_scores_rejects_other_dtypes():
    with pytest.raises(ValueError, match="fetch_dtype"):
        stream_scores(torch.zeros((1, 2, 3)), fetch_dtype="float64")


def _setup(trained_and_graph):
    _lp, corpus, result, hclg = trained_and_graph
    id2pdf = result.transition_model.id2pdf_array()
    packed = result.am.pack()
    lls = [np.array(j_loglikes_np(packed, f)) for f in corpus.feats]
    decoder = LatticeFasterDecoder(
        port_copy(hclg), LatticeFasterDecoderConfig(beam=40.0, lattice_beam=6.0),
        backend="native",
    )
    return decoder, id2pdf, lls


def _padded(lls):
    T = max(x.shape[0] for x in lls)
    out = np.full((len(lls), T, lls[0].shape[1]), -1e9, np.float32)
    for u, x in enumerate(lls):
        out[u, : x.shape[0]] = x
    return torch.from_numpy(out)


def test_streamed_decode_matches_list_decode(trained_and_graph):
    """decode_scores_streamed over per-utterance tensors equals
    decode_utterances_parallel over the host arrays, exactly; and the
    stream over a padded tensor, trimmed, decodes to the same."""
    decoder, id2pdf, lls = _setup(trained_and_graph)
    ref = decode_utterances_parallel(decoder, lls, id2pdf, acoustic_scale=2.0)
    got = decode_scores_streamed(
        decoder, [torch.from_numpy(x) for x in lls], id2pdf, acoustic_scale=2.0,
        max_workers=3,
    )
    assert got == ref
    lens = [x.shape[0] for x in lls]
    padded = [
        decode_utterance_lattice_faster(decoder, ll[: lens[u]], id2pdf,
                                        acoustic_scale=2.0)
        for u, ll in enumerate(stream_scores(_padded(lls)))
    ]
    assert padded == ref


@pytest.mark.parametrize("fetch_dtype", ["float16", "bfloat16"])
def test_narrow_fetch_decodes_identical_words(trained_and_graph, fetch_dtype):
    """As khg_tpu's test_f16_fetch_decodes_identical_words: every word
    sequence unchanged under a float16 fetch (and a bfloat16 one)."""
    decoder, id2pdf, lls = _setup(trained_and_graph)
    scores = [torch.from_numpy(x) for x in lls]
    words32 = [r[2] for r in decode_scores_streamed(decoder, scores, id2pdf,
                                                    acoustic_scale=2.0)]
    words = [r[2] for r in decode_scores_streamed(decoder, scores, id2pdf,
                                                  acoustic_scale=2.0,
                                                  fetch_dtype=fetch_dtype)]
    assert words == words32
