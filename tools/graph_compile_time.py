#!/usr/bin/env python3
"""Time the port's training-graph compile on the native C++ FST core
against the pure-Python fstlib, on the digit recipe's transcripts.

    python3 tools/graph_compile_time.py [--num-utts 1024] [--seed 11]

Draws ``--num-utts`` distinct digit sequences of 3 to 7 digits (the
distribution of chip_smoke.py's phase-3 corpus and of
khg_tpu_torch.egs.audiomnist_10k's stage 0), compiles them with
``compile_training_graphs`` once with ``use_native=False`` and once
with the default (native where its library loads), checks that every
graph is the same arc for arc (weights rounded to f32), and prints both
wall times, the machine's CPU count and, where nvidia-smi answers, the
card's name and power limit.  Host work only: no card is needed.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import numpy as np

    from khg_tpu_torch.egs.audiomnist_10k import digit_lexiconp
    from khg_tpu_torch.fstlib import native
    from khg_tpu_torch.lang.topo import generate_hmm_topo
    from khg_tpu_torch.recipes.audiomnist import DIGITS
    from khg_tpu_torch.recipes.corpus_train import compile_training_graphs
    from khg_tpu_torch.recipes.steps import gmm_init_mono

    ap = argparse.ArgumentParser()
    ap.add_argument("--num-utts", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    seqs = set()
    while len(seqs) < args.num_utts:
        seqs.add(tuple(int(rng.integers(10)) for _ in range(int(rng.integers(3, 8)))))
    word_seqs = [[DIGITS[d] for d in s] for s in sorted(seqs)]
    lp = digit_lexiconp()
    topo = generate_hmm_topo(non_sil_phones=lp.get_non_sil_phone_ids(),
                             sil_phone=lp.get_sil_phone_id())
    tm, tree, _am = gmm_init_mono(
        topo, [np.random.default_rng(0).standard_normal((64, 23)).astype(np.float32)])
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError(f"native core: {native.build_error()}")
    build_s = time.perf_counter() - t0

    import khg_tpu_torch.recipes.corpus_train as ct

    real = ct.TrainingGraphCompiler
    times, graphs = {}, {}
    for use_native in (False, True):
        ct.TrainingGraphCompiler = functools.partial(real, use_native=use_native)
        try:
            t0 = time.perf_counter()
            graphs[use_native] = compile_training_graphs(lp, tm, tree, word_seqs)
            times[use_native] = time.perf_counter() - t0
        finally:
            ct.TrainingGraphCompiler = real

    def key(g):
        return (g.start, [float(np.float32(f)) for f in g.final],
                [[(a.ilabel, a.olabel, float(np.float32(a.weight)), a.nextstate)
                  for a in arcs] for arcs in g.arcs])

    same = all(key(a) == key(b) for a, b in zip(graphs[False], graphs[True]))
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = "no nvidia-smi"
    print(json.dumps({
        "graphs": len(word_seqs), "python_s": times[False], "native_s": times[True],
        "native_build_or_load_s": build_s, "arc_for_arc_equal": same,
        "cpus": os.cpu_count(), "card": card,
    }))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
