"""AudioMNIST-style monophone recipe: spoken digits, char-level lexicon
(PyTorch port of khg_tpu/recipes/audiomnist.py; training runs through
recipes/yesno.py's train_yesno on the device).

A larger-scale exercise of the same pipeline as the yesno recipe: 10 digit
words with character-level pronunciations (as the reference's
generate_lexicon.py builds, reference scripts/generate_lexicon.py),
~16 phones, mixture growth toward 1000 Gaussians, Viterbi realignment
with the batched device E-step.

Run:  python -m khg_tpu_torch.recipes.audiomnist [--device cpu]
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
from khg_tpu_torch.recipes.yesno import SyntheticCorpus, TrainResult, train_yesno
from khg_tpu_torch.recipes.yesno_wav import WavCorpus
from khg_tpu_torch.utils.platform import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

DIGITS = "ZERO ONE TWO THREE FOUR FIVE SIX SEVEN EIGHT NINE".split()


def digits_lexicon() -> Dict[str, List[str]]:
    word2phones = {"<SIL>": ["SIL"]}
    for w in DIGITS:
        word2phones[w] = [" ".join(w)]  # char-level pronunciation
    return word2phones


def make_synthetic_digits_corpus(
    num_utts: int = 40,
    dim: int = 20,
    rng: Optional[np.random.Generator] = None,
    min_words: int = 3,
    max_words: int = 7,
    frames_per_state: Tuple[int, int] = (2, 5),
    emission_std: float = 0.4,
) -> Tuple[Lexiconp, SyntheticCorpus]:
    """Digit sequences from hidden per-(phone, state) Gaussian emitters."""
    if rng is None:
        rng = np.random.default_rng(0)
    lexicon = Lexicon(word2phones=digits_lexicon())
    lp = Lexiconp.from_lexicon(lexicon).add_lex_disambig()

    phones = sorted({p for w in DIGITS for p in w} | {"SIL"})
    num_states = {p: (5 if p == "SIL" else 3) for p in phones}
    emitters = {}
    for p in phones:
        scale = 0.3 if p == "SIL" else 2.0
        for s in range(num_states[p]):
            emitters[(p, s)] = rng.standard_normal(dim) * scale

    word_seqs, feats, phone_alis = [], [], []
    for _ in range(num_utts):
        n_words = int(rng.integers(min_words, max_words + 1))
        words = [DIGITS[int(rng.integers(10))] for _ in range(n_words)]
        phone_seq: List[str] = ["SIL"]
        for w in words:
            phone_seq.extend(list(w))
            phone_seq.append("SIL")
        frames, ali = [], []
        for ph in phone_seq:
            for s in range(num_states[ph]):
                n = int(rng.integers(*frames_per_state))
                if ph == "SIL":
                    n = 2 * n + 1
                n = max(n, 1)
                for _ in range(n):
                    frames.append(
                        emitters[(ph, s)] + rng.standard_normal(dim) * emission_std
                    )
                    ali.append(lp.phone2id[ph])
        word_seqs.append(words)
        feats.append(np.asarray(frames, dtype=np.float32))
        phone_alis.append(ali)
    return lp, SyntheticCorpus(word_seqs, feats, phone_alis)


def write_audiomnist_corpus(
    wav_dir,
    num_utts: int = 40,
    min_words: int = 3,
    max_words: int = 7,
    seed: int = 7,
):
    """Synthesize a spoken-digit WAV corpus (see recipes/synth.py).

    File names encode the digit sequence (3_1_4.wav -> THREE ONE FOUR),
    so transcripts come from the directory listing alone — the same
    convention as the waveform yesno corpus.
    """
    from khg_tpu_torch.data.wav import write_wav
    from khg_tpu_torch.recipes.synth import SAMPLE_RATE, synthesize_word_sequence

    wav_dir = Path(wav_dir)
    wav_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    seen = set()
    while len(paths) < num_utts:
        n = int(rng.integers(min_words, max_words + 1))
        digits = tuple(int(rng.integers(10)) for _ in range(n))
        if digits in seen:
            continue
        seen.add(digits)
        words = [DIGITS[d] for d in digits]
        wave = synthesize_word_sequence(words, rng, SAMPLE_RATE)
        p = wav_dir / ("_".join(str(d) for d in digits) + ".wav")
        write_wav(p, wave, SAMPLE_RATE)
        paths.append(p)
    return sorted(paths)


def load_audiomnist_corpus(wav_dir) -> WavCorpus:
    """Scan a digit-waves directory; transcripts from the filenames
    (3_1_4.wav -> THREE ONE FOUR)."""
    paths = sorted(Path(wav_dir).glob("*.wav"))
    if not paths:
        raise FileNotFoundError(f"no .wav files under {wav_dir}")
    utt_ids, word_seqs = [], []
    for p in paths:
        utt_ids.append(p.stem)
        word_seqs.append([DIGITS[int(d)] for d in p.stem.split("_")])
    return WavCorpus(utt_ids, list(paths), word_seqs, [])


def train_audiomnist_wav(
    wav_dir,
    num_iters: int = 20,
    total_gauss: int = 600,
    num_mel_bins: int = 23,
    seed: int = 0,
    device: DeviceLike = None,
) -> TrainResult:
    """Flat-start monophone EM from WAV files on disk (real-audio path:
    data/wav.py reader -> fbank (kernel C on the card) -> batched device
    EM).  ``device``: None means CUDA (raises without a card)."""
    from khg_tpu_torch.features.fbank import FbankConfig
    from khg_tpu_torch.recipes.synth import SAMPLE_RATE
    from khg_tpu_torch.recipes.yesno_wav import extract_features

    device = resolve_device(device)
    corpus = load_audiomnist_corpus(wav_dir)
    cfg = FbankConfig(sample_rate=SAMPLE_RATE, num_mel_bins=num_mel_bins)
    corpus = extract_features(corpus, cfg, device=device)
    lp = Lexiconp.from_lexicon(
        Lexicon(word2phones=digits_lexicon())
    ).add_lex_disambig()
    train_corpus = SyntheticCorpus(
        word_seqs=corpus.word_seqs, feats=corpus.feats, phone_alignments=[]
    )
    return train_yesno(
        lp, train_corpus,
        num_iters=num_iters,
        total_gauss=total_gauss,
        seed=seed,
        device=device,
    )


def train_audiomnist(
    num_utts: int = 40,
    num_iters: int = 20,
    total_gauss: int = 1000,
    max_iter_inc: int = 10,
    seed: int = 0,
    device: DeviceLike = None,
) -> TrainResult:
    """Synthetic-feature digits corpus -> train_yesno on ``device``
    (None means CUDA and raises without a card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    lp, corpus = make_synthetic_digits_corpus(num_utts=num_utts, rng=rng)
    return train_yesno(
        lp, corpus,
        num_iters=num_iters,
        total_gauss=total_gauss,
        max_iter_inc=max_iter_inc,
        seed=seed,
        device=device,
    )


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] %(message)s",
    )
    t0 = time.time()
    result = train_audiomnist(device=device)
    print("avg log-likes:", [round(x, 3) for x in result.avg_loglikes[::4]])
    print("final info:", result.info)
    print(f"wall time: {time.time() - t0:.1f}s")
    assert result.avg_loglikes[-1] > result.avg_loglikes[0] + 5.0


if __name__ == "__main__":
    main()
