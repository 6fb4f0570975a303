"""The port's CTC GMM-EM training (khg_tpu_torch/recipes/ctc_train.py,
device="cpu") against khg_tpu's on tests/test_ctc_train.py's corpora,
and the four properties that file pins on khg_tpu, on the port.

Both run one generator in the same order (flat-start perturbation,
pass 0's equal alignment, mix-up), so the trajectories agree from pass
0.  The port aligns with the Viterbi kernel's plain version (the eager
DP) where khg_tpu runs an XLA scan; the two may break an equal-cost tie
differently, so hypotheses are compared only where the final pass has
no tie.  These corpora have none: the final alignments are checked
bit-equal.

Tolerances: the average log-likelihood history within 1e-4 per frame,
model parameters within 1e-4 relative (f32 products in another order),
and test_ctc_train.py's own for the properties."""

import numpy as np
import pytest
import torch

from khg_tpu.recipes import ctc_train as j_ctc
from khg_tpu_torch.decode.decoder import FasterDecoder, FasterDecoderOptions
from khg_tpu_torch.gmm.likelihoods import loglikes
from khg_tpu_torch.lang.ctc import build_hl_graph, ctc_id2pdf
from khg_tpu_torch.recipes.ctc_train import collapse_ctc_labels, train_ctc_gmm
from khg_tpu_torch.utils.convert import model_to_torch
from tests.test_ctc_train import DIM, VOCAB, _make_corpus, _token_means

CORPORA = {
    "monotone": dict(corpus=(24, 3), passes=8, mixup=0),
    "mixup": dict(corpus=(16, 11), passes=6, mixup=2 * VOCAB),
    "decode": dict(corpus=(24, 5), passes=8, mixup=0),
}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, c in CORPORA.items():
        feats, seqs = _make_corpus(*c["corpus"])
        kw = dict(num_passes=c["passes"], mixup=c["mixup"], seed=0)
        out[name] = (feats, seqs, j_ctc.train_ctc_gmm(feats, seqs, VOCAB, **kw),
                     train_ctc_gmm(feats, seqs, VOCAB, device="cpu", **kw))
    return out


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_train_ctc_gmm_matches_khg_tpu(runs, name):
    feats, seqs, (j_am, j_hist, j_hyps), (am, hist, hyps) = runs[name]
    assert len(hist) == len(j_hist) == CORPORA[name]["passes"]
    np.testing.assert_allclose(hist, j_hist, rtol=0, atol=1e-4)
    assert hyps == j_hyps
    assert am.num_pdfs == j_am.num_pdfs
    for p in range(am.num_pdfs):
        g, jg = am.get_pdf(p), j_am.get_pdf(p)
        assert g.num_gauss == jg.num_gauss, p
        for a, b in ((g.weights, jg.weights), (g.get_means(), jg.get_means()),
                     (g.get_vars(), jg.get_vars())):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=str(p))


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_final_alignment_has_no_tie(runs, name):
    """The port's final Viterbi pass, run again on the port's trained
    model, is tie-free: every frame's best predecessor wins by more
    than f32 rounding, so the tids (and hyps) above may be compared."""
    from khg_tpu_torch.align.packed import pack_graph, pack_graph_batch
    from khg_tpu_torch.align.viterbi_kernel import viterbi_plain
    from khg_tpu_torch.lang.ctc import build_ctc_training_graph
    from khg_tpu_torch.recipes.ctc_train import _batch_feats
    from khg_tpu_torch.utils.convert import batched_graphs_to_torch

    feats, seqs, _j, (am, _h, hyps) = runs[name]
    id2pdf = ctc_id2pdf(VOCAB)
    graphs = batched_graphs_to_torch(pack_graph_batch(
        [pack_graph(build_ctc_training_graph(list(s), VOCAB), id2pdf) for s in seqs],
        states_pad_to=8, indeg_pad_to=1), "cpu")
    x, lens = _batch_feats(feats)
    pm = am.pack(mix_pad_to=1)
    ll = loglikes(*model_to_torch(pm.gconsts, pm.means_invvars, pm.inv_vars,
                                  device="cpu"), torch.as_tensor(x))
    tids, cost = viterbi_plain(graphs, ll, torch.as_tensor(lens), 1.0)
    # an equal-cost second path would show as a one-frame swap between
    # tokens: perturbing each frame's scores by 1e-4 keeps the path
    tids2, _ = viterbi_plain(graphs, ll + 1e-4 * torch.rand(ll.shape, generator=
                             torch.Generator().manual_seed(0)), torch.as_tensor(lens), 1.0)
    assert torch.equal(tids, tids2)
    assert [collapse_ctc_labels(tids[i, : lens[i]].tolist()) for i in range(len(seqs))] \
        == hyps


def test_ctc_em_monotone_and_recovers_tokens(runs):
    feats, seqs, _j, (am, history, hyps) = runs["monotone"]
    assert len(history) == 8
    for a, b in zip(history, history[1:]):
        assert b >= a - 1e-3, history
    assert history[-1] > history[0] + 1.0
    assert sum(h == list(s) for h, s in zip(hyps, seqs)) == len(seqs)


def test_ctc_em_mixup_grows_and_improves(runs):
    feats, seqs, _j, (am2, hist2, _) = runs["mixup"]
    am1, hist1, _ = train_ctc_gmm(feats, seqs, VOCAB, num_passes=6, seed=0,
                                  device="cpu")
    assert am1.num_gauss == VOCAB
    assert am2.num_gauss > VOCAB
    assert hist2[-1] >= hist1[-1] - 1e-3


def test_ctc_trained_gmm_decodes_words_through_hl(runs):
    """Held-out audio decoded to WORDS through HL with the port's
    FasterDecoder and the port-trained GMMs."""
    from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
    from khg_tpu_torch.lang.lfst import make_lexicon_fst_no_silence

    _f, _s, _j, (am, _h, _hy) = runs["decode"]
    lp = Lexiconp.from_lexicon(Lexicon(word2phones={
        "W12": ["p1 p2"], "W3": ["p3"], "W4": ["p4"], "W21": ["p2 p1"],
    })).add_lex_disambig()
    assert [lp.phone2id[f"p{i}"] for i in range(1, 5)] == [1, 2, 3, 4]
    hl = build_hl_graph(
        VOCAB - 1, make_lexicon_fst_no_silence(lp),
        disambig_start=lp.phone2id.get("#0", 0),
        disambig_end=max(lp.phone2id.values()),
    )
    rng = np.random.default_rng(42)
    means = _token_means()
    id2pdf = ctc_id2pdf(VOCAB)
    pm = am.pack()
    model = model_to_torch(pm.gconsts, pm.means_invvars, pm.inv_vars, device="cpu")
    dec = FasterDecoder(hl, FasterDecoderOptions(beam=24.0))
    for words_ref, toks in [(["W12", "W3"], [1, 2, 3]), (["W4", "W21"], [4, 2, 1])]:
        rows = []
        for t in toks:
            rows += [means[0] + rng.normal(0, 1, DIM)] * 2
            rows += [means[t] + rng.normal(0, 1, DIM)] * 6
        rows += [means[0] + rng.normal(0, 1, DIM)] * 2
        f = torch.as_tensor(np.asarray(rows, dtype=np.float32)[None])
        ll = loglikes(*model, f)[0].numpy()
        out = dec.decode(ll, id2pdf, acoustic_scale=1.0)
        assert out is not None
        assert [lp.id2word[w] for w in out[1]] == words_ref


def test_train_ctc_gmm_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats, seqs = _make_corpus(2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_ctc_gmm(feats, seqs, VOCAB, num_passes=1)


def test_segment_sum_drops_out_of_range_rows():
    """CTC pdf ids put padding frames at pdf -1: the stats fold drops
    those rows, as jax.ops.segment_sum does."""
    import jax
    import jax.numpy as jnp

    from khg_tpu_torch.stats.accum import segment_sum

    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    idx = rng.integers(-2, 7, 40).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(idx), 5))
    got = segment_sum(torch.as_tensor(x), torch.as_tensor(idx).long(), 5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
