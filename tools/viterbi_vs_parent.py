#!/usr/bin/env python3
"""Hold the non-banded Viterbi kernel (kernel G, ``csrc/viterbi.cu``)
against another commit's on one card: costs and tids to the bit, times
in turns.

    python3 tools/viterbi_vs_parent.py PARENT_ROOT [--out FILE]
                                (default build/viterbi_vs_parent.json)

PARENT_ROOT is a checkout of a commit whose ``csrc/viterbi.cu`` has this
checkout's ``launch_viterbi`` signature (for example the parent commit
unpacked with ``git archive``).  Its source is built with nvcc for
sm_90a into ``build/vs_parent/`` (``kernel_split.build_variants``).
Problems: chip_smoke.py's check batch (B=256, T=512, S=256, M=4), then
chip_smoke.py's random arc tables of T=200 frames at (B, S, M) =
(64, 2048, 4), (64, 256, 16) and (8, 8000, 4), with the seeds of
``chip_smoke.check_viterbi``.  Times are CUDA-event means, taken
parent, new, new, parent (``kernel_split.timed_in_turns``).  Prints one
JSON object (and writes it to FILE).  Needs one NVIDIA card and nvcc;
exits 1 if a cost or a tid differs from the parent's.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def viterbi_rows(chip_smoke, parent_lib, setup):
    import numpy as np
    import torch

    from kernel_split import timed_in_turns
    from khg_tpu_torch import kernels
    from khg_tpu_torch.align.viterbi_kernel import viterbi_cuda, viterbi_plan

    problems = {"check": chip_smoke.viterbi_batch(setup)[:3]}
    for name, B, S, M, seed in (("s2048_m4", 64, 2048, 4, 5), ("s256_m16", 64, 256, 16, 6),
                                ("s8000_m4", 8, 8000, 4, 4)):
        rng = np.random.default_rng(seed)  # as chip_smoke.check_viterbi_generic
        g = chip_smoke.random_arc_tables(rng, B, S, M, 50)
        ll = torch.as_tensor((-20 + 5 * rng.standard_normal((B, 200, 50))).astype(np.float32),
                             device="cuda")
        nf = torch.as_tensor(rng.integers(100, 201, B).astype(np.int32), device="cuda")
        problems[name] = (g, ll, nf)
    out, ok = {}, True
    for name, (g, ll, nf) in problems.items():
        B, S, M = g.in_src.shape
        T, P = ll.shape[1], ll.shape[2]
        bp = torch.empty((B, T, -(-S // 16) * 16), dtype=torch.int8, device="cuda")
        tids = torch.empty((B, T), dtype=torch.int32, device="cuda")
        cost = torch.empty((B,), dtype=torch.float32, device="cuda")

        def parent():
            err = parent_lib.launch_viterbi(
                g.in_src.data_ptr(), g.in_pdf.data_ptr(), g.in_cost.data_ptr(),
                g.in_tid.data_ptr(), g.init_cost.data_ptr(), g.final_cost.data_ptr(),
                ll.data_ptr(), nf.data_ptr(), bp.data_ptr(), None, tids.data_ptr(),
                cost.data_ptr(), B, S, M, T, P, 0.1, kernels.stream_handle(ll.device))
            if err:
                raise RuntimeError(f"parent viterbi failed to launch: error {err}")
            return tids, cost

        calls = {"parent": parent, "new": lambda: viterbi_cuda(g, ll, nf, 0.1)}
        tp, cp = (x.clone() for x in parent())
        tk, ck = calls["new"]()
        torch.cuda.synchronize()
        eq = bool(torch.equal(tk, tp) and torch.equal(ck, cp))
        ok &= eq
        mf = int(nf.max())
        ms = timed_in_turns(calls)
        out[name] = dict(B=B, T=T, S=S, M=M, max_frames=mf, plan=viterbi_plan(S, M)[0],
                         bit_equal_to_parent=eq, ms=ms,
                         us_per_frame={k: t / mf * 1e3 for k, t in ms.items()})
        print(f"G {name}: {json.dumps(out[name])}", flush=True)
    return out, ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="checkout holding the other viterbi.cu")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "viterbi_vs_parent.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("viterbi_vs_parent: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke
    from kernel_split import build_variants
    from khg_tpu_torch import kernels
    from khg_tpu_torch.data.wav import read_wav
    from khg_tpu_torch.features.fbank import FbankConfig
    from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
    from khg_tpu_torch.lang.topo import generate_hmm_topo
    from khg_tpu_torch.recipes.audiomnist import digits_lexicon
    from khg_tpu_torch.recipes.corpus_train import compile_training_graphs
    from khg_tpu_torch.recipes.steps import gmm_init_mono
    from khg_tpu_torch.recipes.synth import SAMPLE_RATE

    src = args.parent / "khg_tpu_torch" / "csrc" / "viterbi.cu"
    parent_lib = build_variants(src, ROOT / "build" / "vs_parent", {"parent": []}, "G")["parent"]
    kernels.lib()
    with tempfile.TemporaryDirectory(prefix="khg_vs_parent_") as tmp:
        corpus = chip_smoke.make_corpus(Path(tmp))
        lens = [len(read_wav(p)[0]) for p in corpus.wav_paths]
    cfg = FbankConfig(sample_rate=SAMPLE_RATE, num_mel_bins=23)
    lp = Lexiconp.from_lexicon(Lexicon(word2phones=digits_lexicon())).add_lex_disambig()
    topo = generate_hmm_topo(non_sil_phones=lp.get_non_sil_phone_ids(),
                             sil_phone=lp.get_sil_phone_id())
    tm0, tree, _am = gmm_init_mono(
        topo, [np.random.default_rng(0).standard_normal((64, 23)).astype(np.float32)])
    graphs = compile_training_graphs(lp, tm0, tree, corpus.word_seqs)
    setup = (lp, tm0, tree, graphs, lens, cfg)

    result = {"card": chip_smoke.card_line()}
    result["G"], result["ok"] = viterbi_rows(chip_smoke, parent_lib, setup)
    line = json.dumps(result)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    print(line)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
