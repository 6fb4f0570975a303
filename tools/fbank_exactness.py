#!/usr/bin/env python3
"""How far the fbank frontend's f32 formulations lie from the exact
function, and from each other, on synthetic speech (CPU only).

    JAX_PLATFORMS=cpu python3 tools/fbank_exactness.py [--check-rows N] [--out FILE]

Three versions of the fused frontend (8 kHz, 23 mel bins) run on the
same bucket-padded waves:

- ``pallas``: khg_tpu's Pallas kernel (``compute_fbank_pallas``,
  interpret mode), the reference of
  ``tests/test_torch_fbank.py::test_extract_features_matches_jax``;
- ``plain``: the port's plain version (``fbank_fused`` on CPU tensors:
  f32 frames against the f32 folded matrices);
- ``exact``: the same function in f64, step by step (DC removal,
  pre-emphasis, window, ``numpy.fft.rfft``, power, mel, log), checked
  against the f64 folded matrices applied to f64 frames.

Problems: the five utterances that test writes (seed 3, 2 to 6 words,
padded to whole seconds), and the first N of chip_smoke.py's check rows
(4.2 s of its synthetic corpus, as ``check_fbank`` cuts them; N = 32 by
default).  For each pair (plain, exact) x (pallas) and exact x plain it
reports the largest absolute difference, where it lies (utterance,
frame, mel filter) and the reference's value there, the largest
difference per mel filter, and how many values break the test's
``assert_allclose(rtol=1e-3, atol=1e-3)`` (|a - ref| > 1e-3 + 1e-3
|ref|).  Prints one JSON object and writes it to FILE (default
build/fbank_exactness.json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def exact_fbank(padded, cfg, T):
    """(T, M) log-mel of one padded wave in f64, step by step, and the
    same from the f64 folded matrices (their largest difference)."""
    import numpy as np

    from khg_tpu_torch.features.fbank import _dft_matrices, _window, mel_banks

    flen, shift, N = cfg.frame_length, cfg.frame_shift, cfg.fft_size
    idx = np.arange(T)[:, None] * shift + np.arange(flen)[None, :]
    x = padded.astype(np.float64)[idx]
    if cfg.remove_dc_offset:
        x = x - x.mean(-1, keepdims=True)
    prev = np.concatenate([x[:, :1], x[:, :-1]], -1)
    y = (x - cfg.preemph_coeff * prev) * _window(cfg).astype(np.float64)
    spec = np.fft.rfft(y, n=N)
    power = spec.real ** 2 + spec.imag ** 2
    mel = mel_banks(cfg).astype(np.float64)
    feats = np.log(np.maximum(power @ mel.T, 1.1754944e-38))
    # the folded map in f64: the composition the plain version rounds to f32
    cos_m, sin_m = _dft_matrices(N)
    L = np.diag(_window(cfg).astype(np.float64))
    E = np.eye(flen)
    E[0, 0] = 1.0 - cfg.preemph_coeff
    E[np.arange(flen - 1), np.arange(1, flen)] = -cfg.preemph_coeff
    L = (np.eye(flen) - np.full((flen, flen), 1.0 / flen)) @ (E @ L)
    raw = padded.astype(np.float64)[idx]
    re = raw @ (L @ cos_m[:flen].astype(np.float64))
    im = raw @ (L @ sin_m[:flen].astype(np.float64))
    folded = np.log(np.maximum((re * re + im * im) @ mel.T, 1.1754944e-38))
    return feats, float(np.abs(folded - feats).max())


def compare(got, ref):
    """Largest |got - ref| over lists of (T_i, M) arrays, where, per
    filter, and the test's breaches."""
    import numpy as np

    starts = np.cumsum([0] + [x.shape[0] for x in ref])
    g, r = (np.concatenate(xs).astype(np.float64) for xs in (got, ref))
    d = np.abs(g - r)
    row, col = np.unravel_index(int(np.argmax(d)), d.shape)
    utt = int(np.searchsorted(starts, row, side="right") - 1)
    breach = d > 1e-3 + 1e-3 * np.abs(r)
    return dict(max_abs=float(d.max()),
                at=dict(utt=utt, frame=int(row - starts[utt]), filter=int(col)),
                ref_there=float(r[row, col]), got_there=float(g[row, col]),
                max_rel=float((d / np.maximum(np.abs(r), 1e-30)).max()),
                max_abs_per_filter=[float(v) for v in d.max(0)],
                breaches=int(breach.sum()), values=int(d.size))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check-rows", type=int, default=32)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "fbank_exactness.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from khg_tpu.data.wav import write_wav
    from khg_tpu.features.fbank import FbankConfig as JFbankConfig
    from khg_tpu.features.pallas_fbank import compute_fbank_pallas
    from khg_tpu.recipes.yesno_wav import synthesize_utterance
    from khg_tpu_torch.data.wav import read_wav
    from khg_tpu_torch.features.fbank import FbankConfig, num_frames
    from khg_tpu_torch.features.fbank_kernel import _padded_wave, fbank_fused

    kw = dict(sample_rate=8000, num_mel_bins=23)
    cfg, jcfg = FbankConfig(**kw), JFbankConfig(**kw)
    problems = {}
    with tempfile.TemporaryDirectory(prefix="khg_fbank_exact_") as tmp:
        rng = np.random.default_rng(3)  # as test_extract_features_matches_jax
        rows = []
        for i in range(5):
            words = ["YES" if b else "NO" for b in rng.integers(0, 2, 2 + i)]
            write_wav(Path(tmp) / f"u{i}.wav", synthesize_utterance(words, rng), 8000)
            w = read_wav(Path(tmp) / f"u{i}.wav")[0]
            nb = -(-len(w) // 8000) * 8000
            rows.append((np.pad(w, (0, nb - len(w)), mode="symmetric"), len(w)))
        problems["test_extract_features"] = rows
        if args.check_rows:
            (Path(tmp) / "corpus").mkdir()
            corpus = chip_smoke.make_corpus(Path(tmp) / "corpus")
            n = int(4.2 * cfg.sample_rate)
            problems["check_rows"] = [
                (np.pad(w, (0, max(0, n - len(w))), mode="symmetric")[:n], n)
                for w in (read_wav(p)[0] for p in corpus.wav_paths[:args.check_rows])]
    result = dict(config=kw)
    for name, rows in problems.items():
        pallas, plain, exact, folded_gap = [], [], [], 0.0
        for wave, length in rows:
            T = num_frames(cfg, length)
            pallas.append(np.asarray(compute_fbank_pallas(wave[None].astype(np.float32), jcfg,
                                                          interpret=True))[0, :T])
            plain.append(fbank_fused(torch.as_tensor(wave[None], dtype=torch.float32),
                                     cfg)[0, :T].numpy())
            Tp = num_frames(cfg, len(wave))
            padded = _padded_wave(torch.as_tensor(wave[None], dtype=torch.float64), cfg, Tp)
            f, gap = exact_fbank(padded[0].numpy(), cfg, Tp)
            exact.append(f[:T])
            folded_gap = max(folded_gap, gap)
        result[name] = dict(utterances=len(rows), frames=int(sum(x.shape[0] for x in pallas)),
                            plain_vs_pallas=compare(plain, pallas),
                            exact_vs_pallas=compare(exact, pallas),
                            exact_vs_plain=compare(exact, plain),
                            exact_steps_vs_folded_f64=folded_gap)
        r = result[name]
        print(f"{name}: plain vs pallas {r['plain_vs_pallas']['max_abs']:.3e} "
              f"({r['plain_vs_pallas']['breaches']} breaches); exact vs pallas "
              f"{r['exact_vs_pallas']['max_abs']:.3e} ({r['exact_vs_pallas']['breaches']} "
              f"breaches of {r['exact_vs_pallas']['values']}); exact vs plain "
              f"{r['exact_vs_plain']['max_abs']:.3e}", flush=True)
    line = json.dumps(result)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
