"""Synthetic-yesno end-to-end example on the port: lang prep -> train ->
decode -> WER.

The port's counterpart of egs/yesno_synth/run.py, with its stages,
flags, defaults and artifacts under --exp-dir (``lang/``,
``corpus.pkl``, ``checkpoints/``, ``final.ckpt``, ``final.txt``,
``wer.txt``), plus ``--device``.  Each stage reloads what the earlier
ones wrote:

  0  prepare the lang directory (phones/words tables, topo, L FSTs)
  1  generate the synthetic corpus (features + transcripts)
  2  flat-start monophone EM training (checkpointed per pass; Viterbi
     realignment on kernel G on the card)
  3  score the corpus on the device (kernel B), decode it over the
     unigram yes/no HCLG with the native lattice decoder, write the WER
     report

Run:  python -m khg_tpu_torch.egs.yesno_synth --exp-dir exp/yesno_synth
      (add --device cpu to run the plain PyTorch versions on the CPU)
"""

from __future__ import annotations

import argparse
import logging
import pickle
import time
from pathlib import Path
from typing import Dict

import numpy as np


def main(argv=None) -> dict:
    """Run the stages; returns {"timings", "train", "decode"} (the
    last two where their stage ran)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--stage", type=int, default=0)
    parser.add_argument("--exp-dir", type=Path, default=Path("exp/yesno_synth"))
    parser.add_argument("--num-utts", type=int, default=10)
    parser.add_argument("--num-iters", type=int, default=20)
    parser.add_argument("--total-gauss", type=int, default=100)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    args = parser.parse_args(argv)

    from khg_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] "
        "%(message)s",
    )
    exp = args.exp_dir
    exp.mkdir(parents=True, exist_ok=True)

    from khg_tpu_torch.egs.yesno_wav import YESNO_WORDS, decode_stage, train_stage
    from khg_tpu_torch.lang.prepare import prepare_lang
    from khg_tpu_torch.recipes.yesno import make_synthetic_corpus

    timings: Dict[str, float] = {}
    out = {"timings": timings}
    if args.stage <= 0:
        print("=== stage 0: prepare lang")
        prepare_lang(exp / "lang", word2phones=YESNO_WORDS)

    if args.stage <= 1:
        print("=== stage 1: synthesize corpus")
        rng = np.random.default_rng(0)
        lp, corpus = make_synthetic_corpus(num_utts=args.num_utts, rng=rng)
        with open(exp / "corpus.pkl", "wb") as f:
            pickle.dump({"lexiconp": lp, "corpus": corpus}, f)

    with open(exp / "corpus.pkl", "rb") as f:
        blob = pickle.load(f)
    lp, corpus = blob["lexiconp"], blob["corpus"]

    if args.stage <= 2:
        print("=== stage 2: train")
        t0 = time.perf_counter()
        out["train"] = train_stage(exp, lp, corpus, args.num_iters,
                                   args.total_gauss, device)
        timings["train_s"] = time.perf_counter() - t0

    if args.stage <= 3:
        print("=== stage 3: decode + WER")
        t0 = time.perf_counter()
        out["decode"] = decode_stage(
            exp, lp, corpus.feats, [f"utt{i}" for i in range(len(corpus.feats))],
            corpus.word_seqs, "yesno_synth", device, timings,
        )
        timings["decode_s"] = time.perf_counter() - t0
        print(f"results in {exp}/wer.txt")
    print("stage timings:", {k: round(v, 3) for k, v in timings.items()})
    return out


if __name__ == "__main__":
    main()
