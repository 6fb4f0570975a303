"""Synthetic CTC end-to-end example on the port: train -> HLG decode ->
WER.

The port's counterpart of egs/ctc_synth/run.py (BASELINE config #4: CTC
topology training graphs instead of 3-state HMM), with its stages,
flags, defaults and artifacts under --exp-dir (``corpus.pkl``,
``final.pkl``, ``wer.txt``), plus ``--device``.  Each stage reloads what
the earlier ones wrote:

  0  synthesize the corpus: per-token Gaussian features for word
     sequences drawn from a token-pair lexicon (train + held-out test)
  1  flat start + equal-align init + Viterbi EM over CTC lattices
     (recipes/ctc_train.train_ctc_gmm; kernel G on the card), with
     mixture split-up
  2  build HLG (CTC topo ∘ det(L ∘ G), unigram G), score the held-out
     test set (gmm/likelihoods.loglikes_np: kernel B on the card),
     decode it with the lattice decoder, score WER

The corpus draws from the same seeds as run.py, so for the same flags
``wer.txt`` is run.py's, byte for byte.

Run:  python -m khg_tpu_torch.egs.ctc_synth --exp-dir exp/ctc_synth
      (add --device cpu to run the plain PyTorch versions on the CPU)

Reference semantics for the topology/graphs: the reference's
scripts/ctc_topo.py:6-105 and test_ctc_topo.py:64-176.
"""

from __future__ import annotations

import argparse
import pickle
import time
from pathlib import Path

import numpy as np

WORD2PHONES = {
    "GO": ["p1 p2"],
    "STOP": ["p3"],
    "LEFT": ["p4 p1"],
    "RIGHT": ["p2 p4"],
    "UP": ["p5"],
    "DOWN": ["p3 p5"],
}
VOCAB = 6  # blank + tokens p1..p5
DIM = 10


def synth_corpus(lp, num_utts, rng, min_words=1, max_words=3):
    """Word sequences -> token sequences (via the lexicon) -> features
    sampled from unit-variance Gaussians at per-token means."""
    means = token_means()
    words_list, tok_seqs, feats = [], [], []
    vocab_words = [w for w in lp.word2id if w not in ("<eps>",)
                   and not w.startswith(("#", "<"))]
    for _ in range(num_utts):
        n = int(rng.integers(min_words, max_words + 1))
        words = [str(rng.choice(vocab_words)) for _ in range(n)]
        toks = []
        for w in words:
            toks.extend(lp.phone2id[p] for p in WORD2PHONES[w][0].split())
        rows = []
        for j, t in enumerate(toks):
            if j == 0 or rng.random() < 0.8:
                rows += [means[0] + rng.normal(0, 1, DIM)
                         for _ in range(int(rng.integers(1, 4)))]
            rows += [means[t] + rng.normal(0, 1, DIM)
                     for _ in range(int(rng.integers(4, 8)))]
        rows += [means[0] + rng.normal(0, 1, DIM)
                 for _ in range(int(rng.integers(1, 4)))]
        words_list.append(words)
        tok_seqs.append(toks)
        feats.append(np.asarray(rows, dtype=np.float32))
    return words_list, tok_seqs, feats


def token_means():
    rng = np.random.default_rng(17)
    means = rng.normal(0.0, 4.0, size=(VOCAB, DIM)).astype(np.float32)
    means[0] = 0.0  # blank at the origin
    return means


def unigram_arpa(words):
    arpa = "\\data\\\nngram 1=%d\n\n\\1-grams:\n" % (len(words) + 2)
    for w in sorted(words):
        arpa += f"-1\t{w}\n"
    arpa += "-99 <s>\n-1 </s>\n\n\\end\\\n"
    return arpa


def main(argv=None) -> dict:
    """Run the stages; returns {"timings", "history" (stage 1), "wer"
    (stage 2)}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--stage", type=int, default=0)
    parser.add_argument("--exp-dir", type=Path, default=Path("exp/ctc_synth"))
    parser.add_argument("--num-train", type=int, default=40)
    parser.add_argument("--num-test", type=int, default=10)
    parser.add_argument("--num-passes", type=int, default=10)
    parser.add_argument("--mixup", type=int, default=2 * VOCAB)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    args = parser.parse_args(argv)
    from khg_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    exp = args.exp_dir
    exp.mkdir(parents=True, exist_ok=True)

    from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp

    lp = Lexiconp.from_lexicon(
        Lexicon(word2phones=WORD2PHONES)
    ).add_lex_disambig()
    assert max(lp.phone2id[f"p{i}"] for i in range(1, 6)) == VOCAB - 1

    timings = {}
    out = {"timings": timings}
    if args.stage <= 0:
        print("=== stage 0: synthesize corpus")
        rng = np.random.default_rng(5)
        train = synth_corpus(lp, args.num_train, rng)
        test = synth_corpus(lp, args.num_test, rng)
        with open(exp / "corpus.pkl", "wb") as f:
            pickle.dump({"train": train, "test": test}, f)

    with open(exp / "corpus.pkl", "rb") as f:
        blob = pickle.load(f)
    _, train_toks, train_feats = blob["train"]
    test_words, _, test_feats = blob["test"]

    if args.stage <= 1:
        print("=== stage 1: CTC EM training")
        from khg_tpu_torch.recipes.ctc_train import train_ctc_gmm

        t0 = time.perf_counter()
        am, history, _ = train_ctc_gmm(
            train_feats, train_toks, VOCAB,
            num_passes=args.num_passes, mixup=args.mixup, seed=0,
            device=device,
        )
        timings["train_s"] = time.perf_counter() - t0
        print("avg log-likes:", [round(x, 3) for x in history])
        assert history[-1] > history[0], "EM did not improve"
        with open(exp / "final.pkl", "wb") as f:
            pickle.dump({"am": am, "history": history}, f)
        out["history"] = history

    if args.stage <= 2:
        print("=== stage 2: HLG decode + WER")
        from khg_tpu_torch.decode.arpa import arpa_to_fst
        from khg_tpu_torch.decode.lattice import (
            LatticeFasterDecoder,
            LatticeFasterDecoderConfig,
            decode_utterances_parallel,
        )
        from khg_tpu_torch.decode.wer import write_error_stats
        from khg_tpu_torch.gmm.likelihoods import loglikes_np
        from khg_tpu_torch.lang.ctc import build_hlg_graph, ctc_id2pdf
        from khg_tpu_torch.lang.lfst import make_lexicon_fst_no_silence

        t0 = time.perf_counter()
        with open(exp / "final.pkl", "rb") as f:
            am = pickle.load(f)["am"]
        L = make_lexicon_fst_no_silence(lp)
        G = arpa_to_fst(unigram_arpa(WORD2PHONES), lp.word2id)
        hlg = build_hlg_graph(
            VOCAB - 1, L, G,
            disambig_start=lp.phone2id.get("#0", 0),
            disambig_end=max(lp.phone2id.values()),
        )
        decoder = LatticeFasterDecoder(
            hlg, LatticeFasterDecoderConfig(beam=32.0, lattice_beam=8.0)
        )
        id2pdf = ctc_id2pdf(VOCAB)
        packed = am.pack()
        lls = [loglikes_np(packed, f, device=device) for f in test_feats]
        decoded = decode_utterances_parallel(
            decoder, lls, id2pdf, acoustic_scale=1.0
        )
        results = []
        for i, (ok, _tids, words, _like) in enumerate(decoded):
            hyp = [lp.id2word[w] for w in words] if ok else []
            results.append((f"utt{i}", test_words[i], hyp))
        with open(exp / "wer.txt", "w") as f:
            wer = write_error_stats(f, "ctc_synth", results)
        timings["decode_s"] = time.perf_counter() - t0
        print(f"WER {wer:.2f}% -> {exp}/wer.txt")
        out["wer"] = wer
    return out


if __name__ == "__main__":
    main()
