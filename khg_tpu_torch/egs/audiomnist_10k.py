"""Corpus-scale AudioMNIST-style recipe on the port: spoken-digit WAV
files on disk -> fbank -> flat start -> mix-up growth -> resident EM ->
held-out HCLG decode + WER.

The port's counterpart of egs/audiomnist_10k/run.py, with its flags,
defaults and artifacts under --exp-dir (``waves/``, ``feats.pkl``,
``final.ckpt``, ``final.txt``, ``wer.txt``), plus ``--device``.  Stages
(each resumable):

  0  synthesize the WAV corpus (a spawn-context process pool)
  1  fbank feature extraction (kernel C on the card)
  2  train: recipes/corpus_train.py (growth phase -> resident stretches)
  3  score the held-out split on the device (kernel B, one launch per
     bucket of 128 frames), decode it over a unigram HCLG with the
     native lattice decoder, write the WER report

Run:  python -m khg_tpu_torch.egs.audiomnist_10k --exp-dir exp/am10k
      (add --device cpu to run the plain PyTorch versions on the CPU)
Smoke scale: --num-utts 200 --total-gauss 200 --num-iters 12
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import pickle
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

# frames per scoring bucket (the length axis of one kernel B launch)
BUCKET_FRAMES = 128
BEAM = 40.0
LATTICE_BEAM = 6.0
ACOUSTIC_SCALE = 2.0


def digit_unigram_arpa() -> str:
    from khg_tpu_torch.recipes.audiomnist import DIGITS

    lines = ["\\data\\", "ngram 1=12", "", "\\1-grams:"]
    for w in DIGITS:
        lines.append(f"-1\t{w}")
    lines += ["-99 <s>", "-1 </s>", "", "\\end\\", ""]
    return "\n".join(lines)


def synth_stage(waves_dir: Path, num_utts: int, seed: int, jobs: int):
    """Write the WAV corpus with a pool of ``jobs`` worker processes
    (synthesis is pure numpy)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    waves_dir.mkdir(parents=True, exist_ok=True)
    existing = len(list(waves_dir.glob("*.wav")))
    if existing >= num_utts:
        print(f"synth: {existing} WAVs already present, skipping")
        return
    rng = np.random.default_rng(seed)
    seqs, seen = [], set()
    while len(seqs) < num_utts:
        n = int(rng.integers(3, 8))
        digits = tuple(int(rng.integers(10)) for _ in range(n))
        if digits in seen:
            continue
        seen.add(digits)
        seqs.append(digits)
    chunks = [seqs[i::jobs] for i in range(jobs)]
    t0 = time.perf_counter()
    # spawn, not fork: torch has started threads by now, and forking a
    # multithreaded process can deadlock the workers
    with ProcessPoolExecutor(
        max_workers=jobs, mp_context=mp.get_context("spawn")
    ) as ex:
        list(ex.map(
            synth_chunk,
            [(str(waves_dir), chunk, seed + 1 + i)
             for i, chunk in enumerate(chunks)],
        ))
    print(f"synth: {num_utts} WAVs in {time.perf_counter() - t0:.0f}s")


def synth_chunk(args) -> int:
    """One worker's share: write a WAV per digit sequence, named by it."""
    wav_dir, seqs, seed = args
    from khg_tpu_torch.data.wav import write_wav
    from khg_tpu_torch.recipes.audiomnist import DIGITS
    from khg_tpu_torch.recipes.synth import SAMPLE_RATE, synthesize_word_sequence

    rng = np.random.default_rng(seed)
    for digits in seqs:
        words = [DIGITS[d] for d in digits]
        wave = synthesize_word_sequence(words, rng, SAMPLE_RATE)
        p = Path(wav_dir) / ("_".join(str(d) for d in digits) + ".wav")
        write_wav(p, wave, SAMPLE_RATE)
    return len(seqs)


def digit_lexiconp():
    from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
    from khg_tpu_torch.recipes.audiomnist import digits_lexicon

    return Lexiconp.from_lexicon(
        Lexicon(word2phones=digits_lexicon())
    ).add_lex_disambig()


# ------------------------------------------------------------------ stage 3

def score_held_out(am, feats_list: Sequence[np.ndarray], device=None):
    """Per-utterance (T_u, P) f32 log-likelihoods, kept on ``device``
    (None means CUDA).

    As egs/audiomnist_10k/run.py scores on the chip: the model packed
    with components padded to a multiple of 8; utterances bucketed by
    length rounded up to 128 frames; each bucket's rows padded with
    zero frames up to a power of two and scored by ONE
    ``loglikes_fused`` call (kernel B on the card, its plain version on
    the CPU)."""
    import torch

    from khg_tpu_torch.gmm import fused_loglikes
    from khg_tpu_torch.utils.convert import model_to_torch
    from khg_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    pm = am.pack(mix_pad_to=8)
    g, m, v = model_to_torch(pm.gconsts, pm.means_invvars, pm.inv_vars,
                             device=dev)
    buckets = {}
    for i, f in enumerate(feats_list):
        tb = -(-f.shape[0] // BUCKET_FRAMES) * BUCKET_FRAMES
        buckets.setdefault(tb, []).append(i)
    out = [None] * len(feats_list)
    for tb, ids in sorted(buckets.items()):
        rows = 1 << (len(ids) - 1).bit_length()
        fb = np.zeros((rows, tb, feats_list[ids[0]].shape[1]), np.float32)
        for r, i in enumerate(ids):
            fb[r, : feats_list[i].shape[0]] = feats_list[i]
        ll = fused_loglikes.loglikes_fused(
            g, m, v, torch.from_numpy(fb).to(dev)
        )
        for r, i in enumerate(ids):
            out[i] = ll[r, : feats_list[i].shape[0]]
    return out


def build_decoder(lp, tm, tree, arpa: Optional[str] = None):
    """The HCLG of ``arpa`` (default: the unigram digit LM) and a native
    lattice decoder over it."""
    from khg_tpu_torch.decode.arpa import arpa_to_fst
    from khg_tpu_torch.decode.graph import build_hclg
    from khg_tpu_torch.decode.lattice import (
        LatticeFasterDecoder,
        LatticeFasterDecoderConfig,
    )

    G = arpa_to_fst(digit_unigram_arpa() if arpa is None else arpa, lp.word2id)
    hclg = build_hclg(lp, G, tm, tree)
    return LatticeFasterDecoder(
        hclg, LatticeFasterDecoderConfig(beam=BEAM, lattice_beam=LATTICE_BEAM),
        backend="native",
    )


@dataclass
class HeldOutDecode:
    decoded: list      # (ok, tids, words, loglike) per utterance
    hyps: List[List[str]]
    wer: float         # percent
    report: str        # write_error_stats' text (wer.txt)
    decode_s: float    # transfer + host decode + report


def decode_held_out(
    lp, tm, tree, scores, utt_ids: Sequence[str],
    refs: Sequence[Sequence[str]], decoder=None,
    fetch_dtype: Optional[str] = None,
    arpa: Optional[str] = None,
    label: str = "audiomnist_10k_test",
) -> HeldOutDecode:
    """Decode per-utterance device scores (``score_held_out``) over the
    HCLG of ``arpa`` (default: the unigram digit LM): the native
    LatticeFasterDecoder (beam 40, lattice beam 6) at acoustic scale 2,
    fed by streamed device->host copies (``fetch_dtype`` None: f32),
    then the WER report under ``label``.  Builds the decoder unless one
    is given (``build_decoder``)."""
    from khg_tpu_torch.decode.score_stream import decode_scores_streamed
    from khg_tpu_torch.decode.wer import write_error_stats

    if decoder is None:
        decoder = build_decoder(lp, tm, tree, arpa)
    t0 = time.perf_counter()
    decoded = decode_scores_streamed(
        decoder, scores, tm.id2pdf_array(), acoustic_scale=ACOUSTIC_SCALE,
        fetch_dtype=fetch_dtype,
    )
    hyps = [[lp.id2word[w] for w in words] if ok else []
            for ok, _tids, words, _like in decoded]
    buf = io.StringIO()
    wer = write_error_stats(
        buf, label, list(zip(utt_ids, refs, hyps)),
        enable_log=False,
    )
    return HeldOutDecode(decoded, hyps, wer, buf.getvalue(),
                         time.perf_counter() - t0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--stage", type=int, default=0)
    parser.add_argument("--exp-dir", type=Path,
                        default=Path("exp/audiomnist_10k"))
    parser.add_argument("--num-utts", type=int, default=10000)
    parser.add_argument("--num-test", type=int, default=500)
    parser.add_argument("--num-iters", type=int, default=30)
    parser.add_argument("--total-gauss", type=int, default=1000)
    parser.add_argument("--max-iter-inc", type=int, default=15)
    parser.add_argument("--stretch", type=int, default=6)
    parser.add_argument("--num-mel-bins", type=int, default=23)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--synth-jobs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    parser.add_argument(
        "--json", action="store_true",
        help="print one corpus_train_* JSON line at the end",
    )
    args = parser.parse_args(argv)

    import torch

    from khg_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] "
        "%(message)s",
    )

    exp = args.exp_dir
    exp.mkdir(parents=True, exist_ok=True)
    waves = exp / "waves"
    timings = {}

    if args.stage <= 0:
        print(f"=== stage 0: synthesize {args.num_utts} WAVs")
        t0 = time.perf_counter()
        synth_stage(waves, args.num_utts, args.seed, args.synth_jobs)
        timings["synth_s"] = time.perf_counter() - t0

    from khg_tpu_torch.recipes.audiomnist import load_audiomnist_corpus

    corpus = load_audiomnist_corpus(waves)
    n = len(corpus.utt_ids)
    test_ids = list(range(n - args.num_test, n))
    train_ids = list(range(n - args.num_test))

    feats_path = exp / "feats.pkl"
    if args.stage <= 1:
        print(f"=== stage 1: fbank for {n} utts")
        from khg_tpu_torch.features.fbank import FbankConfig
        from khg_tpu_torch.recipes.synth import SAMPLE_RATE
        from khg_tpu_torch.recipes.yesno_wav import extract_features

        t0 = time.perf_counter()
        cfg = FbankConfig(
            sample_rate=SAMPLE_RATE, num_mel_bins=args.num_mel_bins
        )
        corpus = extract_features(corpus, cfg, device=device)
        timings["fbank_s"] = time.perf_counter() - t0
        with open(feats_path, "wb") as f:
            pickle.dump(corpus.feats, f)
        print(f"fbank: {timings['fbank_s']:.0f}s")
    else:
        with open(feats_path, "rb") as f:
            corpus.feats = pickle.load(f)

    lp = digit_lexiconp()

    if args.stage <= 2:
        print(f"=== stage 2: train on {len(train_ids)} utts")
        from khg_tpu_torch.recipes.corpus_train import train_corpus
        from khg_tpu_torch.utils.checkpoint import (
            export_kaldi_text,
            save_checkpoint,
        )

        result = train_corpus(
            lp,
            [corpus.word_seqs[i] for i in train_ids],
            [corpus.feats[i] for i in train_ids],
            num_iters=args.num_iters,
            total_gauss=args.total_gauss,
            max_iter_inc=args.max_iter_inc,
            stretch=args.stretch,
            batch_size=args.batch_size,
            seed=args.seed,
            checkpoint_dir=str(exp / "checkpoints"),
            device=device,
        )
        save_checkpoint(
            exp / "final.ckpt",
            {
                "acoustic_model": result.am,
                "transition_model": result.transition_model,
                "tree": result.tree,
                "avg_loglikes": result.avg_loglikes,
                "num_gauss_after_est": result.num_gauss_after_est,
                "timings": result.timings,
            },
        )
        export_kaldi_text(
            exp / "final.txt", result.transition_model, result.am
        )
        timings.update(
            {f"train_{k}": v for k, v in result.timings.items()}
        )
        print("avg log-likes:",
              [round(x, 3) for x in result.avg_loglikes[::4]])
        print("final:", result.info)

    if args.stage <= 3:
        print(f"=== stage 3: decode {len(test_ids)} held-out utts + WER")
        from khg_tpu_torch.utils.checkpoint import load_checkpoint

        t_stage = time.perf_counter()
        state = load_checkpoint(exp / "final.ckpt")
        am, tm, tree = (state["acoustic_model"], state["transition_model"],
                        state["tree"])
        t0 = time.perf_counter()
        decoder = build_decoder(lp, tm, tree)
        timings["hclg_s"] = time.perf_counter() - t0
        test_feats = [corpus.feats[i] for i in test_ids]
        t0 = time.perf_counter()
        scores = score_held_out(am, test_feats, device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        timings["score_s"] = time.perf_counter() - t0
        out = decode_held_out(
            lp, tm, tree, scores, [corpus.utt_ids[i] for i in test_ids],
            [corpus.word_seqs[i] for i in test_ids], decoder=decoder,
        )
        timings["lattice_decode_s"] = out.decode_s
        timings["decode_s"] = time.perf_counter() - t_stage
        audio_sec = sum(f.shape[0] for f in test_feats) / 100.0
        timings["decode_audio_sec_per_s"] = audio_sec / timings["decode_s"]
        (exp / "wer.txt").write_text(out.report)
        print(out.report.splitlines()[0])
        print(f"full report: {exp}/wer.txt")
        print("stage timings:",
              {k: round(v, 1) for k, v in timings.items()})

    if args.json:
        print(json.dumps(json_record(exp, len(train_ids), timings)))


def json_record(exp: Path, num_train: int, timings) -> dict:
    """egs/audiomnist_10k/run.py's --json record."""
    from khg_tpu_torch.utils.checkpoint import load_checkpoint

    rec = {"corpus_train_utts": num_train}
    ckpt = exp / "final.ckpt"
    if ckpt.exists():
        state = load_checkpoint(ckpt)
        tt = state.get("timings", {})
        passes = len(state.get("avg_loglikes", []))
        wall = tt.get("total_s", 0.0)
        rec.update(
            corpus_train_wall_s=round(wall, 1),
            corpus_train_passes=passes,
            corpus_train_audio_sec=round(tt.get("audio_sec", 0), 1),
            corpus_train_audio_sec_per_s=round(
                tt.get("audio_sec", 0) * passes / max(wall, 1e-9), 1
            ),
            corpus_train_num_gauss=int(state["acoustic_model"].num_gauss),
            corpus_train_final_ll=round(state["avg_loglikes"][-1], 4),
            **{
                f"corpus_train_{k}": round(v, 1)
                for k, v in tt.items()
                if k.endswith("_s")
            },
        )
    wer_path = exp / "wer.txt"
    if wer_path.exists():
        wer_line = wer_path.read_text().splitlines()[0]
        rec["corpus_train_wer_pct"] = float(
            wer_line.split("%WER")[1].split("%")[0]
        )
    for k, v in timings.items():
        rec.setdefault(f"corpus_stage_{k}", round(v, 1))
    return rec


if __name__ == "__main__":
    main()
