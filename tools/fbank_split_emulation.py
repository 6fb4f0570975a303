#!/usr/bin/env python3
"""How many split products the fbank kernel's tensor-core product needs,
on the CPU.

    python3 tools/fbank_split_emulation.py [--rows 16] [--out FILE]

The fbank kernel (khg_tpu_torch/csrc/fbank.cu) takes the frontend's two
folded products (frames by the f32 folded matrices) on the tensor
cores.  This script runs the numpy emulation of the kernel's arithmetic
in tests/test_torch_fbank_split.py (``emulate_kernel``) with each
candidate product of ``PRODUCTS`` there: TF32 parts rounded ties away
from zero as ``cvt.rna``, BF16 parts to nearest even, the chosen part
products exact in f64 and their sum rounded to f32.  Each is held
against the plain version ``fbank_plain`` (max abs difference, and how
many values exceed the kernel's 1e-3) on the first ROWS of
``chip_smoke.check_fbank``'s rows (the synthetic corpus's WAV samples,
4.2 s at 8 kHz: integers), on the same rows times 0.7 (full f32
mantissas), and on 3 of them upsampled to 48 kHz and rounded to
integers as a WAV holds them (FFT size 2,048).

Prints one JSON object (and writes it to FILE, default
chiprun_out/fbank_split_emulation.json).  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "fbank_split_emulation.json")
    args = ap.parse_args()

    import numpy as np
    import torch
    from scipy.signal import resample_poly

    import chip_smoke
    from khg_tpu_torch.data.wav import read_wav
    from khg_tpu_torch.features.fbank import FbankConfig, num_frames
    from khg_tpu_torch.features.fbank_kernel import _padded_wave, fbank_plain
    from khg_tpu_torch.recipes.synth import SAMPLE_RATE
    from test_torch_fbank_split import PRODUCTS, emulate_kernel

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory(prefix="khg_split_emul_") as tmp:
        corpus = chip_smoke.make_corpus(Path(tmp))
        waves = [read_wav(p)[0] for p in corpus.wav_paths[: args.rows]]
    cfg = FbankConfig(sample_rate=SAMPLE_RATE, num_mel_bins=23)
    n = int(4.2 * cfg.sample_rate)
    rows = np.stack([np.pad(w, (0, max(0, n - len(w))), mode="symmetric")[:n]
                     for w in waves]).astype(np.float32)
    up = np.clip(np.round(resample_poly(rows[:3].astype(np.float64), 6, 1, axis=1)),
                 -32768, 32767).astype(np.float32)
    cases = {
        f"{args.rows} WAV rows, 8 kHz": (rows, cfg),
        "the same rows x 0.7, 8 kHz": ((rows * np.float32(0.7)).astype(np.float32), cfg),
        "3 WAV rows upsampled to 48 kHz": (up, FbankConfig(sample_rate=48000, num_mel_bins=23)),
    }
    result = {}
    for case, (r, c) in cases.items():
        T = num_frames(c, r.shape[1])
        padded = _padded_wave(torch.as_tensor(r), c, T)
        plain = fbank_plain(padded, c, T)[0].numpy()
        result[case] = {"values": int(plain.size)}
        for name, product in PRODUCTS.items():
            d = np.abs(emulate_kernel(padded, c, T, product)[0] - plain)
            result[case][name] = {"max_abs": float(d.max()), "over_1e-3": int((d > 1e-3).sum())}
            print(f"{case}: {name}: max |d| {d.max():.3g}, {(d > 1e-3).sum()} values > 1e-3",
                  flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
