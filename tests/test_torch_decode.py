"""Decoding in the port (khg_tpu_torch/decode) against khg_tpu on the
same inputs: the WER report, the ARPA -> G and HCLG constructions (arc
for arc, weights bitwise), the FasterDecoder, decode_dense (the
non-banded Viterbi's plain version on the CPU) and the host scoring
wrapper loglikes_np.  Models and graphs are the reference's, carried
to the port's classes by ``port_copy``; the yesno fixture is the one
khg_tpu's decode tests train."""

import io
import math

import numpy as np
import pytest

from khg_tpu.decode.arpa import arpa_to_fst as j_arpa_to_fst
from khg_tpu.decode.decoder import FasterDecoder as JFasterDecoder
from khg_tpu.decode.decoder import FasterDecoderOptions as JFasterDecoderOptions
from khg_tpu.decode.decoder import decode_dense as j_decode_dense
from khg_tpu.decode.graph import build_hclg as j_build_hclg
from khg_tpu.decode.wer import levenshtein_align as j_levenshtein_align
from khg_tpu.decode.wer import write_error_stats as j_write_error_stats
from khg_tpu.gmm.likelihoods import loglikes_np as j_loglikes_np
from khg_tpu_torch.decode.arpa import arpa_to_fst
from khg_tpu_torch.decode.decoder import (
    FasterDecoder,
    FasterDecoderOptions,
    decode_dense,
    recover_words,
)
from khg_tpu_torch.decode.graph import build_hclg
from khg_tpu_torch.decode.wer import levenshtein_align, write_error_stats
from khg_tpu_torch.gmm.likelihoods import loglikes_np
from tests.test_decode import YESNO_ARPA, trained_and_graph  # noqa: F401
from tests.torch_parity import port_copy

BIGRAM_ARPA = """
\\data\\
ngram 1=5
ngram 2=4

\\1-grams:
-0.8\tNO\t-0.3
-0.6\tYES\t-0.25
-99 <s>\t-0.5
-1.1 </s>
-2.0\t<SIL>

\\2-grams:
-0.2\t<s> YES
-0.4\tYES NO
-0.3\tNO </s>
-0.7\tNO YES

\\end\\
"""


def fst_signature(fst):
    """Everything an FST is: start, finals and every arc in order, with
    weights as Python floats (compared exactly)."""
    return (
        fst.num_states, fst.start, list(fst.final),
        [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
         for arcs in fst.arcs],
    )


def _digit_system():
    """khg_tpu's digit lexicon, topology, flat-start transition model and
    tree (host code only), as in egs/audiomnist_10k/run.py stage 3."""
    from khg_tpu.lang.lexicon import Lexicon, Lexiconp
    from khg_tpu.lang.topo import generate_hmm_topo
    from khg_tpu.model.context_dep import monophone_context_dependency
    from khg_tpu.model.transition_model import TransitionModel
    from khg_tpu.recipes.audiomnist import digits_lexicon

    lp = Lexiconp.from_lexicon(Lexicon(word2phones=digits_lexicon())).add_lex_disambig()
    topo = generate_hmm_topo(non_sil_phones=lp.get_non_sil_phone_ids(),
                             sil_phone=lp.get_sil_phone_id())
    tree = monophone_context_dependency(topo.phones,
                                        topo.get_phone_to_num_pdf_classes())
    return lp, TransitionModel(tree, topo), tree


@pytest.mark.parametrize("ref,hyp", [
    (["a", "b", "c"], ["a", "x", "c", "d"]),
    ([], ["a"]),
    (["a", "b"], []),
    (["ONE", "TWO", "TWO", "SIX"], ["ONE", "TWO", "SIX", "SIX", "NINE"]),
])
def test_levenshtein_align_matches_jax(ref, hyp):
    assert levenshtein_align(ref, hyp) == j_levenshtein_align(ref, hyp)


def test_write_error_stats_matches_jax():
    """Identical report text and WER on random digit transcripts with
    substitutions, insertions, deletions and empty hypotheses."""
    rng = np.random.default_rng(0)
    words = "ZERO ONE TWO THREE FOUR".split()
    results = []
    for u in range(30):
        ref = [words[i] for i in rng.integers(0, 5, rng.integers(1, 7))]
        hyp = [w for w in ref if rng.uniform() > 0.15]
        if rng.uniform() < 0.3:
            hyp.insert(int(rng.integers(0, len(hyp) + 1)), words[int(rng.integers(5))])
        if rng.uniform() < 0.1:
            hyp = []
        results.append((f"u{u:02d}", ref, hyp))
    got, ref = io.StringIO(), io.StringIO()
    wer = write_error_stats(got, "t", results, enable_log=False)
    j_wer = j_write_error_stats(ref, "t", results, enable_log=False)
    assert wer == j_wer
    assert got.getvalue() == ref.getvalue()


@pytest.mark.parametrize("arpa", ["yesno", "bigram", "digits"])
def test_arpa_to_fst_matches_jax(arpa):
    lp, _tm, _tree = _digit_system()
    word2id = {"<eps>": 0, "<SIL>": 1, "NO": 2, "YES": 3, "#0": 4,
               "<s>": 5, "</s>": 6}
    if arpa == "digits":
        from khg_tpu_torch.egs.audiomnist_10k import digit_unigram_arpa

        text, word2id = digit_unigram_arpa(), lp.word2id
    else:
        text = YESNO_ARPA if arpa == "yesno" else BIGRAM_ARPA
    got = arpa_to_fst(text, word2id)
    ref = j_arpa_to_fst(text, word2id)
    assert fst_signature(got) == fst_signature(ref)


def test_build_hclg_yesno_matches_jax(trained_and_graph):
    """The port's HCLG from the port's copies of the trained yesno
    system equals khg_tpu's (the fixture's), arc for arc."""
    lp, _corpus, result, hclg = trained_and_graph
    G = arpa_to_fst(YESNO_ARPA, lp.word2id)
    got = build_hclg(port_copy(lp), G, port_copy(result.transition_model),
                     port_copy(result.tree))
    assert fst_signature(got) == fst_signature(hclg)


def test_build_hclg_digits_matches_jax():
    """The recipe's unigram digit HCLG (161 states, 361 arcs)."""
    from khg_tpu_torch.egs.audiomnist_10k import digit_unigram_arpa

    lp, tm, tree = _digit_system()
    ref = j_build_hclg(lp, j_arpa_to_fst(digit_unigram_arpa(), lp.word2id), tm, tree)
    plp = port_copy(lp)
    got = build_hclg(plp, arpa_to_fst(digit_unigram_arpa(), plp.word2id),
                     port_copy(tm), port_copy(tree))
    assert (got.num_states, got.num_arcs) == (161, 361)
    assert fst_signature(got) == fst_signature(ref)


def _yesno_lls(trained_and_graph, n):
    _lp, corpus, result, _hclg = trained_and_graph
    packed = result.am.pack()
    return [j_loglikes_np(packed, f) for f in corpus.feats[:n]]


@pytest.mark.parametrize("opts", [
    dict(beam=40.0),
    dict(beam=8.0, max_active=30, min_active=5),
    dict(beam=0.01, min_active=10**6),
], ids=["beam40", "max_active", "min_active"])
def test_faster_decoder_matches_jax(trained_and_graph, opts):
    """Identical alignments, words and costs on the same f32 loglikes."""
    _lp, _corpus, result, hclg = trained_and_graph
    id2pdf = result.transition_model.id2pdf_array()
    port = FasterDecoder(port_copy(hclg), FasterDecoderOptions(**opts))
    ref = JFasterDecoder(hclg, JFasterDecoderOptions(**opts))
    for ll in _yesno_lls(trained_and_graph, 4):
        assert port.decode(ll, id2pdf, acoustic_scale=2.0) == ref.decode(
            ll, id2pdf, acoustic_scale=2.0)


def test_decode_dense_matches_jax(trained_and_graph):
    """decode_dense on the CPU (the plain Viterbi) against khg_tpu's
    (XLA): tids and words equal, cost within 1e-6 relative (both are
    exact DPs over the same f32 costs); words recovered from the tids."""
    _lp, _corpus, result, hclg = trained_and_graph
    id2pdf = result.transition_model.id2pdf_array()
    phclg = port_copy(hclg)
    for ll in _yesno_lls(trained_and_graph, 3):
        got = decode_dense(phclg, ll, id2pdf, acoustic_scale=2.0, device="cpu")
        ref = j_decode_dense(hclg, ll, id2pdf, acoustic_scale=2.0)
        assert got is not None and ref is not None
        assert got[0] == ref[0]
        assert got[1] == ref[1]
        assert math.isclose(got[2], ref[2], rel_tol=1e-6), (got[2], ref[2])
        assert recover_words(phclg, got[0]) == got[1]


def test_decode_dense_matches_faster(trained_and_graph):
    """As khg_tpu's test_decode_dense_matches_faster: the exact DP and a
    wide-beam search agree on words and on cost within 1e-3."""
    _lp, _corpus, result, hclg = trained_and_graph
    id2pdf = result.transition_model.id2pdf_array()
    phclg = port_copy(hclg)
    decoder = FasterDecoder(phclg, FasterDecoderOptions(beam=30.0))
    for ll in _yesno_lls(trained_and_graph, 3):
        fast = decoder.decode(ll, id2pdf, acoustic_scale=2.0)
        dense = decode_dense(phclg, ll, id2pdf, acoustic_scale=2.0, device="cpu")
        assert fast is not None and dense is not None
        assert math.isclose(fast[2], dense[2], rel_tol=1e-3), (fast[2], dense[2])
        assert fast[1] == dense[1]


def test_decode_dense_max_states(trained_and_graph):
    _lp, _corpus, result, hclg = trained_and_graph
    id2pdf = result.transition_model.id2pdf_array()
    ll = _yesno_lls(trained_and_graph, 1)[0]
    with pytest.raises(ValueError, match="max_states"):
        decode_dense(port_copy(hclg), ll, id2pdf, max_states=hclg.num_states - 1,
                     device="cpu")


def test_decode_dense_needs_a_device_or_a_card(trained_and_graph, monkeypatch):
    """Without device= it asks for CUDA, and raises where there is none."""
    import torch

    _lp, _corpus, result, hclg = trained_and_graph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_dense(port_copy(hclg), _yesno_lls(trained_and_graph, 1)[0],
                     result.transition_model.id2pdf_array())


@pytest.mark.parametrize("mix_pad", [1, 8])
def test_loglikes_np_matches_jax(trained_and_graph, mix_pad):
    """The host scoring wrapper on the CPU (kernel B's plain version)
    against khg_tpu's within 1e-5 relative to the scores' magnitude:
    both sum f32 component terms of up to ~1e2 in another order, so a
    score near 0 may differ by a few of their ulps (~1e-5)."""
    _lp, corpus, result, _hclg = trained_and_graph
    packed = result.am.pack(mix_pad_to=mix_pad)
    for feats in corpus.feats[:3]:
        got = loglikes_np(port_copy(packed), feats, device="cpu")
        ref = j_loglikes_np(packed, feats)
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_decodable_am_diag_gmm_matches_jax():
    """DecodableAmDiagGmmScaled on the CPU (loglikes_np, kernel B's
    plain version) against khg_tpu's: scores within 1e-5 of their
    largest magnitude (as test_loglikes_np_matches_jax), the same map
    and scale, and per-(frame, tid) scores from the port's own matrix."""
    from khg_tpu.decode.decodable import DecodableAmDiagGmmScaled as JDecodable
    from khg_tpu_torch.decode.decodable import DecodableAmDiagGmmScaled
    from tests.test_align import random_am
    from tests.test_graph_compiler import build_yesno_like

    _lp, _topo, tree, tm, _gc = build_yesno_like()
    rng = np.random.default_rng(1)
    am = random_am(tree.num_pdfs, 5, rng)
    feats = rng.standard_normal((23, 5)).astype(np.float32)
    got = DecodableAmDiagGmmScaled(port_copy(am), port_copy(tm), feats, scale=0.5,
                                   device="cpu")
    ref = JDecodable(am, tm, feats, scale=0.5)
    assert got.num_frames == ref.num_frames == 23
    (ll, id2pdf, scale), (jll, jid2pdf, jscale) = got.matrix_and_map(), ref.matrix_and_map()
    assert ll.dtype == np.float32 and ll.shape == jll.shape == (23, tree.num_pdfs)
    assert np.abs(ll - jll).max() <= 1e-5 * np.abs(jll).max()
    assert np.array_equal(id2pdf, jid2pdf) and scale == jscale == 0.5
    for t, tid in [(0, 1), (7, 3), (22, len(id2pdf) - 1)]:
        assert got.log_likelihood(t, tid) == np.float32(0.5) * ll[t, id2pdf[tid]]


def test_decodable_am_diag_gmm_needs_a_device_or_a_card(monkeypatch):
    """Without device= it scores on CUDA, and raises where there is none."""
    import torch

    from khg_tpu_torch.decode.decodable import DecodableAmDiagGmmScaled
    from tests.test_align import random_am
    from tests.test_graph_compiler import build_yesno_like

    _lp, _topo, tree, tm, _gc = build_yesno_like()
    rng = np.random.default_rng(2)
    am = port_copy(random_am(tree.num_pdfs, 5, rng))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dec = DecodableAmDiagGmmScaled(am, port_copy(tm), rng.standard_normal((4, 5)))
    with pytest.raises(RuntimeError, match="CUDA"):
        dec.loglikes()
