"""The CTC graph builders (khg_tpu_torch/lang/ctc.py) and the CTC
decodable (decode/decodable.DecodableCtc) against khg_tpu's on the same
inputs: topologies, label shifts, training graphs and HL / HLG graphs
arc for arc with weights compared exactly, the label map, and the words
the FasterDecoder reads off an HL graph."""

import numpy as np
import pytest

from khg_tpu.decode.decodable import DecodableCtc as JDecodableCtc
from khg_tpu.decode.decoder import FasterDecoder as JFasterDecoder
from khg_tpu.decode.decoder import FasterDecoderOptions as JFasterDecoderOptions
from khg_tpu.lang import ctc as jctc
from khg_tpu_torch.decode.decodable import DecodableCtc
from khg_tpu_torch.decode.decoder import FasterDecoder, FasterDecoderOptions
from khg_tpu_torch.lang import ctc
from tests.test_ctc import make_logits
from tests.test_torch_decode import fst_signature
from tests.torch_parity import port_copy


@pytest.mark.parametrize("max_token", [1, 3, 6])
@pytest.mark.parametrize("zero_special", [False, True])
def test_ctc_topo_matches_jax(max_token, zero_special):
    """The full topology, shifted by add_one, with disambiguation
    self-loops."""
    got = ctc.build_standard_ctc_topo(max_token)
    ref = jctc.build_standard_ctc_topo(max_token)
    assert fst_signature(got) == fst_signature(ref)
    ctc.add_one(got, treat_ilabel_zero_specially=zero_special)
    jctc.add_one(ref, treat_ilabel_zero_specially=zero_special)
    ctc.add_disambig_self_loops(got, start=max_token + 5, end=max_token + 7)
    jctc.add_disambig_self_loops(ref, start=max_token + 5, end=max_token + 7)
    assert fst_signature(got) == fst_signature(ref)


@pytest.mark.parametrize("vocab", [1, 4, 30])
def test_ctc_id2pdf_matches_jax(vocab):
    got, ref = ctc.ctc_id2pdf(vocab), jctc.ctc_id2pdf(vocab)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("tokens", [[], [2], [2, 3, 2, 2], [1, 1, 1], [4, 1, 3, 3, 2]])
def test_ctc_training_graph_matches_jax(tokens):
    got = ctc.build_ctc_training_graph(tokens, 5)
    ref = jctc.build_ctc_training_graph(tokens, 5)
    assert fst_signature(got) == fst_signature(ref)


def _ab_c_lexicon():
    """tests/test_ctc.py's lexicon (tokens a, b, c; words AB = "a b",
    C = "c") with BA = "b a" and ABC = "a b c" added, so that L needs
    disambiguation symbols; its L without silence."""
    from khg_tpu.lang.lexicon import Lexicon, Lexiconp
    from khg_tpu.lang.lfst import make_lexicon_fst_no_silence

    lexicon = Lexicon(word2phones={"AB": ["a b"], "C": ["c"], "BA": ["b a"],
                                   "ABC": ["a b c"]})
    lp = Lexiconp.from_lexicon(lexicon).add_lex_disambig()
    return lp, make_lexicon_fst_no_silence(lp)


def _disambig_range(lp):
    ids = [i for p, i in lp.phone2id.items() if p.startswith("#")]
    return min(ids), max(ids)


@pytest.mark.parametrize("disambig", [False, True])
def test_build_hl_graph_matches_jax(disambig):
    lp, L = _ab_c_lexicon()
    kw = dict(zip(("disambig_start", "disambig_end"), _disambig_range(lp))) if disambig else {}
    got = ctc.build_hl_graph(3, port_copy(L), **kw)
    ref = jctc.build_hl_graph(3, L, **kw)
    assert fst_signature(got) == fst_signature(ref)


def test_build_hlg_graph_matches_jax():
    """HLG with a weighted unigram word G over the same lexicon (L has
    no #0 self-loops, so G has no backoff arcs)."""
    from khg_tpu.decode.arpa import arpa_to_fst as j_arpa_to_fst
    from khg_tpu_torch.decode.arpa import arpa_to_fst

    lp, L = _ab_c_lexicon()
    arpa = ("\\data\\\nngram 1=6\n\n\\1-grams:\n-0.5\tAB\n-0.7\tC\n-0.9\tBA\n"
            "-1.2\tABC\n-99 <s>\n-0.6 </s>\n\n\\end\\\n")
    lo, hi = _disambig_range(lp)
    got = ctc.build_hlg_graph(3, port_copy(L), arpa_to_fst(arpa, lp.word2id), lo, hi)
    ref = jctc.build_hlg_graph(3, L, j_arpa_to_fst(arpa, lp.word2id), lo, hi)
    assert got.num_arcs > 0 and fst_signature(got) == fst_signature(ref)


@pytest.mark.parametrize("tokens", [[1, 2, 3], [3, 1, 2], [1, 2, 3, 3], [2, 1, 1, 2]])
def test_ctc_hl_decode_matches_jax(tokens):
    """CTC logits decoded to words through the port's HL graph by the
    port's FasterDecoder: the same output as khg_tpu's, bit for bit."""
    lp, L = _ab_c_lexicon()
    hl = ctc.build_hl_graph(3, port_copy(L))
    ll = make_logits(tokens, 4)
    got = FasterDecoder(hl, FasterDecoderOptions(beam=20.0)).decode(
        ll, ctc.ctc_id2pdf(4), acoustic_scale=1.0)
    ref = JFasterDecoder(jctc.build_hl_graph(3, L), JFasterDecoderOptions(beam=20.0)).decode(
        ll, jctc.ctc_id2pdf(4), acoustic_scale=1.0)
    assert got is not None and got == ref


def test_decodable_ctc_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((9, 6))  # f64: both cast to f32
    got, ref = DecodableCtc(logits), JDecodableCtc(logits)
    assert got.num_frames == ref.num_frames == 9
    (m, cmap, s), (jm, jcmap, js) = got.matrix_and_map(), ref.matrix_and_map()
    assert m.dtype == jm.dtype == np.float32 and np.array_equal(m, jm)
    assert np.array_equal(cmap, jcmap) and s == js == 1.0
    for t, i in [(0, 1), (4, 3), (8, 6)]:
        assert got.log_likelihood(t, i) == ref.log_likelihood(t, i)
