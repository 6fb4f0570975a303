"""Waveform yesno on the port: WAV files -> fbank -> train -> decode -> WER.

The port's counterpart of egs/yesno_wav/run.py, with its stages, flags,
defaults and artifacts under --exp-dir (``waves/``, ``lang/``,
``feats.pkl``, ``checkpoints/``, ``final.ckpt``, ``final.txt``,
``wer.txt``), plus ``--device``.  Each stage reloads what the earlier
ones wrote, so any stage re-runs independently:

  0  data: put WAV files in <exp>/waves (synthesized formant-speech
     yes/no recordings in the real corpus's layout, 60 files x 8 words;
     a real waves_yesno download drops in unchanged via --waves-dir)
  1  prepare the lang directory (phones/words tables, topo, L FSTs)
  2  fbank feature extraction (kernel C on the card)
  3  flat-start monophone EM training on the train split
     (recipes/yesno.train_yesno: realignment on kernel G); with
     --speed-perturb the TRAINING half is tripled by 0.9/1.1 speed
     perturbation before fbank, after the split, so no perturbed copy
     of a test utterance reaches training
  4  score the TEST split on the device (kernel B), decode it over the
     unigram yes/no HCLG with the native lattice decoder (beam 40,
     lattice beam 6, acoustic scale 2), write the WER report

Run:  python -m khg_tpu_torch.egs.yesno_wav --exp-dir exp/yesno_wav
      (add --device cpu to run the plain PyTorch versions on the CPU)
"""

from __future__ import annotations

import argparse
import logging
import pickle
import time
from pathlib import Path
from typing import Dict, List, Sequence

ARPA = """\\data\\
ngram 1=4

\\1-grams:
-1\tNO
-1\tYES
-99 <s>
-1 </s>

\\end\\
"""

YESNO_WORDS = {"<SIL>": ["SIL"], "YES": ["Y"], "NO": ["N"]}


def train_stage(exp: Path, lp, train_corpus, num_iters: int,
                total_gauss: int, device):
    """train_yesno with per-pass checkpoints, then final.ckpt and
    final.txt; returns the TrainResult."""
    from khg_tpu_torch.recipes.yesno import train_yesno
    from khg_tpu_torch.utils.checkpoint import export_kaldi_text, save_checkpoint

    result = train_yesno(
        lp, train_corpus,
        num_iters=num_iters,
        total_gauss=total_gauss,
        checkpoint_dir=str(exp / "checkpoints"),
        device=device,
    )
    save_checkpoint(
        exp / "final.ckpt",
        {
            "acoustic_model": result.am,
            "transition_model": result.transition_model,
            "tree": result.tree,
        },
    )
    export_kaldi_text(exp / "final.txt", result.transition_model, result.am)
    print("avg log-likes:", [round(x, 3) for x in result.avg_loglikes[::4]])
    return result


def decode_stage(exp: Path, lp, feats_list: Sequence, utt_ids: Sequence[str],
                 refs: Sequence[Sequence[str]], label: str, device,
                 timings: Dict[str, float]):
    """Score ``feats_list`` with final.ckpt's model on the device
    (kernel B, egs/audiomnist_10k's buckets), decode over the yes/no
    HCLG and write wer.txt; returns the HeldOutDecode."""
    import torch

    from khg_tpu_torch.egs.audiomnist_10k import (
        build_decoder,
        decode_held_out,
        score_held_out,
    )
    from khg_tpu_torch.utils.checkpoint import load_checkpoint

    state = load_checkpoint(exp / "final.ckpt")
    am, tm, tree = (state["acoustic_model"], state["transition_model"],
                    state["tree"])
    t0 = time.perf_counter()
    decoder = build_decoder(lp, tm, tree, ARPA)
    timings["hclg_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = score_held_out(am, list(feats_list), device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    timings["score_s"] = time.perf_counter() - t0
    out = decode_held_out(lp, tm, tree, scores, utt_ids, refs,
                          decoder=decoder, arpa=ARPA, label=label)
    timings["lattice_decode_s"] = out.decode_s
    (exp / "wer.txt").write_text(out.report)
    return out


def main(argv=None) -> dict:
    """Run the stages; returns {"timings", "train", "decode",
    "num_train", "test_ids"} (the last stage's objects, where run)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--stage", type=int, default=0)
    parser.add_argument("--exp-dir", type=Path, default=Path("exp/yesno_wav"))
    parser.add_argument(
        "--waves-dir", type=Path, default=None,
        help="existing waves directory (e.g. a real waves_yesno download); "
        "validated against recipes/yesno_wav.YESNO_WAVES_CONTRACT instead "
        "of synthesizing stand-in audio",
    )
    parser.add_argument("--num-utts", type=int, default=60)
    parser.add_argument("--words-per-utt", type=int, default=8)
    parser.add_argument(
        "--num-train", type=int, default=None,
        help="train-split size over the sorted file list; default: first "
        "half (the canonical waves_yesno 30/30 split)",
    )
    parser.add_argument("--num-iters", type=int, default=30)
    parser.add_argument("--total-gauss", type=int, default=300)
    parser.add_argument("--num-mel-bins", type=int, default=23)
    parser.add_argument(
        "--speed-perturb", action="store_true",
        help="triple the TRAINING set with 0.9/1.1 speed-perturbed "
        "copies before fbank; the test half stays unperturbed",
    )
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

    from khg_tpu_torch.features.fbank import FbankConfig
    from khg_tpu_torch.lang.prepare import prepare_lang
    from khg_tpu_torch.recipes.yesno import SyntheticCorpus
    from khg_tpu_torch.recipes.yesno_wav import (
        SAMPLE_RATE,
        WavCorpus,
        extract_features,
        load_yesno_corpus,
        make_yesno_lexiconp,
        validate_yesno_waves,
        write_yesno_corpus,
    )

    timings: Dict[str, float] = {}
    out = {"timings": timings}
    wav_dir = args.waves_dir if args.waves_dir is not None else exp / "waves"
    if args.stage <= 0:
        t0 = time.perf_counter()
        if args.waves_dir is not None:
            report = validate_yesno_waves(wav_dir, strict=True)
            kind = ("real waves_yesno corpus"
                    if report["is_real_corpus_shape"] else "stand-in corpus")
            print(f"=== stage 0: {kind} in {wav_dir} "
                  f"({report['num_files']} files, contract OK)")
        elif any(wav_dir.glob("*.wav")):
            print(f"=== stage 0: using existing WAVs in {wav_dir}")
        else:
            print(f"=== stage 0: synthesizing {args.num_utts} recordings")
            write_yesno_corpus(wav_dir, num_utts=args.num_utts,
                               words_per_utt=args.words_per_utt)
        timings["synth_s"] = time.perf_counter() - t0

    if args.stage <= 1:
        print("=== stage 1: prepare lang")
        prepare_lang(exp / "lang", word2phones=YESNO_WORDS)

    if args.stage <= 2:
        print("=== stage 2: fbank extraction")
        t0 = time.perf_counter()
        corpus = load_yesno_corpus(wav_dir)
        cfg = FbankConfig(sample_rate=SAMPLE_RATE, num_mel_bins=args.num_mel_bins)
        corpus = extract_features(corpus, cfg, device=device)
        timings["fbank_s"] = time.perf_counter() - t0
        with open(exp / "feats.pkl", "wb") as f:
            pickle.dump({"corpus": corpus, "cfg": cfg}, f)
        tot = sum(len(x) for x in corpus.feats)
        print(f"{len(corpus.feats)} utts, {tot} frames")

    with open(exp / "feats.pkl", "rb") as f:
        saved = pickle.load(f)
    corpus, feat_cfg = saved["corpus"], saved["cfg"]
    lp = make_yesno_lexiconp()
    # deterministic split over the sorted file list; default = first
    # half, the canonical waves_yesno 30/30 train/test convention
    num_train = (
        args.num_train if args.num_train is not None
        else (len(corpus.utt_ids) + 1) // 2
    )
    train_ids = list(range(min(num_train, len(corpus.utt_ids))))
    test_ids = [i for i in range(len(corpus.utt_ids)) if i not in train_ids]
    if not test_ids:  # tiny runs: score on train
        test_ids = train_ids
    out["test_ids"] = test_ids

    if args.stage <= 3:
        t0 = time.perf_counter()
        if args.speed_perturb:
            # split FIRST, then perturb only the train half
            base = load_yesno_corpus(wav_dir)
            # a resumed --stage 3 must see the corpus stage 2 pickled
            if base.utt_ids != corpus.utt_ids:
                raise ValueError(
                    "waves dir changed since stage 2 — re-run from --stage 2")
            sub = WavCorpus(
                utt_ids=[base.utt_ids[i] for i in train_ids],
                wav_paths=[base.wav_paths[i] for i in train_ids],
                word_seqs=[base.word_seqs[i] for i in train_ids],
                feats=[],
            )
            sub = extract_features(sub, feat_cfg,
                                   speed_perturb_factors=(0.9, 1.0, 1.1),
                                   device=device)
            timings["perturb_fbank_s"] = time.perf_counter() - t0
            train_corpus = SyntheticCorpus(
                word_seqs=sub.word_seqs, feats=sub.feats, phone_alignments=[],
            )
        else:
            train_corpus = SyntheticCorpus(
                word_seqs=[corpus.word_seqs[i] for i in train_ids],
                feats=[corpus.feats[i] for i in train_ids],
                phone_alignments=[],
            )
        out["num_train"] = len(train_corpus.feats)
        print(f"=== stage 3: train on {len(train_corpus.feats)} utts")
        t0 = time.perf_counter()
        out["train"] = train_stage(exp, lp, train_corpus, args.num_iters,
                                   args.total_gauss, device)
        timings["train_s"] = time.perf_counter() - t0

    if args.stage <= 4:
        print(f"=== stage 4: decode {len(test_ids)} test utts + WER")
        t0 = time.perf_counter()
        dec = decode_stage(
            exp, lp, [corpus.feats[i] for i in test_ids],
            [corpus.utt_ids[i] for i in test_ids],
            [corpus.word_seqs[i] for i in test_ids],
            "yesno_wav_test", device, timings,
        )
        timings["decode_s"] = time.perf_counter() - t0
        out["decode"] = dec
        print(dec.report.splitlines()[0])
        print(f"full report: {exp}/wer.txt")
    print("stage timings:", {k: round(v, 3) for k, v in timings.items()})
    return out


if __name__ == "__main__":
    main()
