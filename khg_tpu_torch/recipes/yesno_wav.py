"""Waveform yesno recipe: real audio files through the full stack
(PyTorch port of khg_tpu/recipes/yesno_wav.py).

The reference's yesno recipe consumes 8 kHz waveforms via lhotse fbank
(reference egs/yesno/local/compute_fbank_yesno.py:22-85).  This module
provides the same pipeline shape on the port's own audio stack: WAV
files on disk -> data/wav.py reader -> fbank or MFCC (the fbank kernel,
csrc/fbank.cu, on the card; its plain version on the CPU) -> optional
deltas -> monophone EM training -> HCLG decode -> WER.

Because this environment has no network, the corpus itself is
*synthesized speech*: formant-synthesis "yes"/"no" tokens written as
ordinary 8 kHz PCM16 WAV files with the real corpus's layout (60
recordings of 8 words each, filenames encoding the word sequence, e.g.
waves/0_1_1_0_1_0_0_1.wav).  The synthesis is a numpy copy of
khg_tpu's, so one seed writes byte-identical WAVs in both packages; the
real waves_yesno corpus drops into the same directory unchanged.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from khg_tpu_torch.data.wav import read_wav, write_wav
from khg_tpu_torch.features.fbank import FbankConfig, num_frames
from khg_tpu_torch.features.fbank_kernel import fbank_fused
from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
from khg_tpu_torch.utils.platform import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

SAMPLE_RATE = 8000


# ---------------------------------------------------------------------------
# waveform synthesis
# ---------------------------------------------------------------------------

def _harmonic_vowel(
    dur: float,
    f0: float,
    formants: Sequence[Tuple[float, float]],  # (center Hz, bandwidth Hz)
    rng: np.random.Generator,
    rate: int = SAMPLE_RATE,
    formant_glide: float = 0.0,  # multiplicative drift of formant centers
) -> np.ndarray:
    """Sum-of-harmonics voiced segment shaped by a formant envelope."""
    n = int(dur * rate)
    t = np.arange(n) / rate
    # small vibrato so segments aren't phase-locked across utterances
    f0_t = f0 * (1.0 + 0.01 * np.sin(2 * np.pi * 4.5 * t + rng.uniform(0, 6)))
    phase = 2 * np.pi * np.cumsum(f0_t) / rate
    glide = 1.0 + formant_glide * (t / max(dur, 1e-6))
    wave = np.zeros(n)
    max_h = int((rate / 2 - 100) / f0)
    for h in range(1, max_h + 1):
        freq = h * f0
        amp = 0.0
        for fc, bw in formants:
            fc_t = fc * glide
            amp = amp + np.exp(-0.5 * ((freq - fc_t) / bw) ** 2)
        wave += np.mean(amp) * np.sin(h * phase) / math.sqrt(h)
    # attack/decay envelope
    env = np.minimum(1.0, np.minimum(t / 0.02, (dur - t) / 0.04))
    return wave * np.maximum(env, 0.0)


def _fricative(
    dur: float,
    band: Tuple[float, float],
    rng: np.random.Generator,
    rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Band-shaped noise segment (e.g. /s/): filtered in the DFT domain."""
    n = int(dur * rate)
    noise = rng.standard_normal(n)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n, 1.0 / rate)
    lo, hi = band
    gain = np.exp(-0.5 * ((freqs - (lo + hi) / 2) / ((hi - lo) / 2)) ** 2)
    shaped = np.fft.irfft(spec * gain, n)
    env = np.minimum(1.0, np.minimum(np.arange(n) / (0.01 * rate), 1.0))
    return shaped / (np.std(shaped) + 1e-9) * env


def _silence(dur: float, rng: np.random.Generator,
             rate: int = SAMPLE_RATE) -> np.ndarray:
    return rng.standard_normal(int(dur * rate)) * 0.002


def synthesize_word(
    word: str, rng: np.random.Generator, rate: int = SAMPLE_RATE
) -> np.ndarray:
    """One spoken token, peak-normalized to ~0.3 full scale."""
    f0 = rng.uniform(95.0, 150.0)
    j = lambda: rng.uniform(0.92, 1.08)  # noqa: E731  per-token jitter
    d = lambda x: x * rng.uniform(0.8, 1.25)  # noqa: E731
    if word == "YES":
        # /j/ glide: F2 rising toward the vowel
        glide = _harmonic_vowel(
            d(0.07), f0, [(300 * j(), 90), (2100 * j(), 220)], rng,
            rate, formant_glide=-0.12,
        )
        vowel = _harmonic_vowel(
            d(0.16), f0, [(580 * j(), 90), (1750 * j(), 160)], rng, rate
        )
        fric = 0.25 * _fricative(d(0.13), (2600.0, 3900.0), rng, rate)
        parts = [glide, vowel, fric]
    elif word == "NO":
        nasal = _harmonic_vowel(
            d(0.09), f0, [(250 * j(), 60), (1100 * j(), 350)], rng, rate
        ) * 0.5
        vowel = _harmonic_vowel(
            d(0.20), f0, [(480 * j(), 80), (850 * j(), 120)], rng, rate,
            formant_glide=-0.15,
        )
        parts = [nasal, vowel]
    else:
        raise ValueError(word)
    w = np.concatenate(parts)
    return (w / (np.max(np.abs(w)) + 1e-9) * 0.3).astype(np.float32)


def synthesize_utterance(
    words: Sequence[str],
    rng: np.random.Generator,
    rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Words separated (and book-ended) by silences, int16 scale."""
    parts = [_silence(rng.uniform(0.25, 0.5), rng, rate)]
    for w in words:
        parts.append(synthesize_word(w, rng, rate))
        parts.append(_silence(rng.uniform(0.15, 0.4), rng, rate))
    wave = np.concatenate(parts).astype(np.float32)
    return wave * 20000.0  # comfortable 16-bit level


def write_yesno_corpus(
    wav_dir: Path,
    num_utts: int = 60,
    words_per_utt: int = 8,
    seed: int = 2026,
    rate: int = SAMPLE_RATE,
) -> List[Path]:
    """Create the waves directory in the real corpus's layout.

    File names encode the word sequence as in waves_yesno
    (1 = YES, 0 = NO): e.g. 0_1_1_0_1_0_0_1.wav.
    """
    wav_dir = Path(wav_dir)
    wav_dir.mkdir(parents=True, exist_ok=True)
    if num_utts > 2 ** words_per_utt:
        raise ValueError(
            f"only {2 ** words_per_utt} distinct {words_per_utt}-word "
            f"sequences exist; cannot write {num_utts} unique files"
        )
    rng = np.random.default_rng(seed)
    paths = []
    seen = set()
    while len(paths) < num_utts:
        bits = tuple(int(rng.integers(0, 2)) for _ in range(words_per_utt))
        if bits in seen:  # filenames must be unique, like the real corpus
            continue
        seen.add(bits)
        words = ["YES" if b else "NO" for b in bits]
        wave = synthesize_utterance(words, rng, rate)
        p = wav_dir / ("_".join(str(b) for b in bits) + ".wav")
        write_wav(p, wave, rate)
        paths.append(p)
    return sorted(paths)


# ---------------------------------------------------------------------------
# corpus loading + feature extraction
# ---------------------------------------------------------------------------

@dataclass
class WavCorpus:
    utt_ids: List[str]
    wav_paths: List[Path]
    word_seqs: List[List[str]]
    feats: List[np.ndarray]  # filled by extract_features


# The real waves_yesno corpus contract (what `lhotse download yesno`
# produces and the reference trains on, reference egs/yesno/
# run.sh:24-48): 60 recordings, 8 kHz 16-bit mono PCM WAV, file names
# encoding the 8-word transcript with 0=NO / 1=YES joined by "_"
# (e.g. 0_0_1_0_1_0_1_1.wav).  The canonical split sorts file names and
# takes the first half for training, second half for test (30/30).
YESNO_WAVES_CONTRACT = {
    "count": 60,
    "sample_rate": SAMPLE_RATE,
    "channels": 1,
    "name_pattern": r"^[01](_[01])*$",
    "words_per_utt": 8,
}


def validate_yesno_waves(wav_dir: Path, strict: bool = False) -> dict:
    """Check a waves directory against the waves_yesno drop-in contract.

    Returns a report dict {"num_files", "bad_names", "bad_rates",
    "bad_channels", "is_real_corpus_shape"}; raises ValueError under
    ``strict`` when any file violates the name/rate/channel contract.
    ``is_real_corpus_shape`` is True when the directory looks exactly
    like the actual download (60 files of 8 words each) as opposed to a
    synthesized or subset stand-in.
    """
    import re

    wav_dir = Path(wav_dir)
    paths = sorted(wav_dir.glob("*.wav"))
    if not paths:
        raise FileNotFoundError(f"no .wav files under {wav_dir}")
    pat = re.compile(YESNO_WAVES_CONTRACT["name_pattern"])
    bad_names, bad_rates, bad_channels = [], [], []
    words_counts = set()
    for p in paths:
        if not pat.match(p.stem):
            bad_names.append(p.name)
            continue
        words_counts.add(len(p.stem.split("_")))
        w, rate = read_wav(p)
        if rate != YESNO_WAVES_CONTRACT["sample_rate"]:
            bad_rates.append((p.name, rate))
        if w.ndim != 1:
            bad_channels.append((p.name, w.shape[0]))
    report = {
        "num_files": len(paths),
        "bad_names": bad_names,
        "bad_rates": bad_rates,
        "bad_channels": bad_channels,
        "is_real_corpus_shape": (
            len(paths) == YESNO_WAVES_CONTRACT["count"]
            and not bad_names
            and not bad_rates
            and not bad_channels
            and words_counts == {YESNO_WAVES_CONTRACT["words_per_utt"]}
        ),
    }
    if strict and (bad_names or bad_rates or bad_channels):
        raise ValueError(f"waves dir violates the yesno contract: {report}")
    return report


def load_yesno_corpus(wav_dir: Path) -> WavCorpus:
    """Scan a waves directory; transcripts come from the filenames."""
    paths = sorted(Path(wav_dir).glob("*.wav"))
    if not paths:
        raise FileNotFoundError(f"no .wav files under {wav_dir}")
    utt_ids, word_seqs = [], []
    for p in paths:
        bits = p.stem.split("_")
        utt_ids.append(p.stem)
        word_seqs.append(["YES" if b == "1" else "NO" for b in bits])
    return WavCorpus(utt_ids, list(paths), word_seqs, [])


def extract_features(
    corpus: WavCorpus,
    cfg: Optional[FbankConfig] = None,
    bucket_samples: int = 8000,
    speed_perturb_factors: Optional[Sequence[float]] = None,
    feature_type: str = "fbank",
    mfcc_cfg=None,
    delta_order: int = 0,
    max_batch: int = 512,
    device: DeviceLike = None,
) -> WavCorpus:
    """Read every WAV and compute fbank (or MFCC), batched by length
    bucket, on ``device`` (None means CUDA and raises without a card;
    "cpu" runs the plain versions).

    ``feature_type="mfcc"`` switches the per-bucket extractor to MFCC
    (``mfcc_cfg`` a features.mfcc.MfccConfig; its frontend settings win
    over ``cfg``); ``delta_order > 0`` appends delta blocks
    (features/delta.py) to each utterance's features in either mode.

    Waves are symmetric-reflection padded up to a bucket multiple — the
    same mirror rule the framer applies at utterance end — so each
    utterance's first ``num_frames(cfg, N_real)`` rows equal unbatched
    extraction.  A bucket is cut into batches of at most ``max_batch``
    rows, each padded with zero waves up to a power of two rows (as
    khg_tpu does; the padded rows' outputs are discarded).

    ``speed_perturb_factors`` (e.g. ``(0.9, 1.0, 1.1)``) expands the
    corpus lhotse-style — one speed-perturbed copy per factor
    (features/resample.py), ids suffixed ``_sp<factor>``, transcripts
    and paths replicated — before extraction, as the reference's
    training recipe does (compute_fbank_yesno.py:68).  Returns a NEW
    WavCorpus in that case.
    """
    dev = resolve_device(device)
    if feature_type == "mfcc":
        from khg_tpu_torch.features.mfcc import MfccConfig, compute_mfcc_batch

        if mfcc_cfg is None:
            base = cfg or FbankConfig(
                sample_rate=SAMPLE_RATE, num_mel_bins=23
            )
            mfcc_cfg = MfccConfig(fbank=base)
        cfg = mfcc_cfg.frontend_cfg()
    elif feature_type != "fbank":
        raise ValueError(f"unknown feature_type {feature_type!r}")
    if cfg is None:
        cfg = FbankConfig(sample_rate=SAMPLE_RATE)
    if cfg.dither != 0.0:
        # the fused frontend takes no noise, as khg_tpu's Pallas one
        raise ValueError("extract_features: dither the waveforms first")

    waves = []
    for p in corpus.wav_paths:
        w, rate = read_wav(p)
        if w.ndim == 2:  # multichannel: first channel, like kaldi default
            w = w[0]
        if rate != cfg.sample_rate:
            raise ValueError(
                f"{p}: rate {rate} != fbank config {cfg.sample_rate}"
            )
        waves.append(w)

    if speed_perturb_factors:
        from khg_tpu_torch.features.resample import speed_perturb_corpus

        waves, src = speed_perturb_corpus(
            waves, cfg.sample_rate, factors=speed_perturb_factors, device=dev
        )
        utt_ids = []
        for f in speed_perturb_factors:
            for uid in corpus.utt_ids:
                utt_ids.append(uid if f == 1.0 else f"{uid}_sp{f:g}")
        corpus = WavCorpus(
            utt_ids=utt_ids,
            wav_paths=[corpus.wav_paths[i] for i in src],
            word_seqs=[list(corpus.word_seqs[i]) for i in src],
            feats=[],
        )

    buckets = {}
    for i, w in enumerate(waves):
        nb = -(-len(w) // bucket_samples) * bucket_samples
        buckets.setdefault(nb, []).append(i)

    dcfg = None
    if delta_order > 0:
        from khg_tpu_torch.features.delta import DeltaConfig, add_deltas

        dcfg = DeltaConfig(order=delta_order)
    feats: List[Optional[np.ndarray]] = [None] * len(waves)
    for nb, idxs in sorted(buckets.items()):
        for lo in range(0, len(idxs), max_batch):
            chunk = idxs[lo : lo + max_batch]
            rows = 1 << (len(chunk) - 1).bit_length()
            batch = np.zeros((rows, nb), dtype=np.float32)
            for r, i in enumerate(chunk):
                batch[r] = np.pad(waves[i], (0, nb - len(waves[i])),
                                  mode="symmetric")
            x = torch.as_tensor(batch, device=dev)
            if feature_type == "mfcc":
                out = compute_mfcc_batch(x, mfcc_cfg)
            else:
                out = fbank_fused(x, cfg)
            if dcfg is None:
                out = out.cpu().numpy()
            for r, i in enumerate(chunk):
                f = out[r, : num_frames(cfg, len(waves[i]))]
                # deltas per utterance: each pads its own edges
                feats[i] = f if dcfg is None else add_deltas(f, dcfg).cpu().numpy()
    corpus.feats = list(feats)
    logger.info(
        "extracted %s for %d utts (%d length buckets, device=%s, "
        "delta_order=%d)",
        feature_type, len(waves), len(buckets), dev, delta_order,
    )
    return corpus


def make_yesno_lexiconp() -> Lexiconp:
    lexicon = Lexicon(
        word2phones={"<SIL>": ["SIL"], "YES": ["Y"], "NO": ["N"]}
    )
    return Lexiconp.from_lexicon(lexicon).add_lex_disambig()
