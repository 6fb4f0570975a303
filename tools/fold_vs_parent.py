#!/usr/bin/env python3
"""Hold the stats fold (kernel F, ``stats/fold_kernel.fold_cuda``)
against the first port's design on one card, to the bit.

    python3 tools/fold_vs_parent.py PARENT_ROOT [--out FILE]   (default build/fold_vs_parent.json)

PARENT_ROOT is a checkout of a commit whose ``csrc/stats_fold.cu`` is
the one-block-per-(utterance, state) kernel with the C entry point
``launch_stats_fold`` (for example a parent commit unpacked with ``git
archive``).  That source is built with nvcc for sm_90a into
``build/fold_parent/``; its (B, S, K, 1+2D) partials are summed onto the
pdfs by ``stats.accum.scatter_local_stats`` (the sorted segment sum the
first port ran after it).  Both run on chip_smoke.py's first triphone
batch (B=64, T=300, S=64, K=32, D=80, P=2,051) and on random problems
(shared and absent pdfs, zero weights, padding components, K of 8 to 40,
D of 13 to 80), and are timed in turns (parent, new, new, parent).  Prints one JSON object: per
problem, whether the (P, K, 1+2D) stats, the (B, S) Σ w·loglike and Σ w
and their totals are bit-equal, the largest difference, and both
times.  Needs one NVIDIA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build_parent(src: Path) -> ctypes.CDLL:
    from khg_tpu_torch import kernels

    out = ROOT / "build" / "fold_parent"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libfold_parent.so"
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([kernels._nvcc(), *flags, "-shared", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.launch_stats_fold.argtypes = [P] * 10 + [I] * 5 + [P]
    lib.launch_stats_fold.restype = ctypes.c_int
    return lib


def parent_fold(lib, g, miv, iv, x, pid, w, sp):
    """The first port's kernel, then its segment-sum scatter: (out (P,
    K, 1+2D), ll (B, S), frames (B, S))."""
    import torch

    from khg_tpu_torch import kernels
    from khg_tpu_torch.stats.accum import scatter_local_stats

    P, K, D = miv.shape
    B, T, _ = x.shape
    S = sp.shape[1]
    local = torch.empty((B, S, K, 2 * D + 1), dtype=torch.float32, device="cuda")
    ll = torch.empty((B, S), dtype=torch.float32, device="cuda")
    frames = torch.empty((B, S), dtype=torch.float32, device="cuda")
    err = lib.launch_stats_fold(
        g.data_ptr(), miv.data_ptr(), iv.data_ptr(), x.data_ptr(), pid.data_ptr(),
        w.data_ptr(), sp.data_ptr(), local.data_ptr(), ll.data_ptr(),
        frames.data_ptr(), B, S, T, K, D, kernels.stream_handle(x.device))
    if err:
        raise RuntimeError(f"parent fold failed to launch: {err}")
    return scatter_local_stats(local, sp, P), ll, frames


def random_problem(seed, B, T, D, P, K, S, pad):
    """Random model, features and an alignment drawn from each
    utterance's states: a pdf on two states, frames of an absent pdf,
    zero and fractional weights, one utterance with no weight."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = rng.standard_normal((P, K)).astype(np.float32) - 5.0
    miv = rng.standard_normal((P, K, D)).astype(np.float32)
    iv = rng.uniform(0.5, 2.0, (P, K, D)).astype(np.float32)
    if pad:
        g[:, K - pad:] = -np.inf
        miv[:, K - pad:] = 0.0
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    sp = rng.integers(0, P // 2, (B, S)).astype(np.int32)
    sp[:, S // 2] = sp[:, 0]
    pid = np.take_along_axis(sp, rng.integers(0, S, (B, T)), axis=1)
    pid[0, :5] = P - 1
    w = rng.uniform(0.0, 1.0, (B, T)).astype(np.float32)
    w[w < 0.2] = 0.0
    w[1] = 0.0
    return [torch.as_tensor(a, device="cuda") for a in (g, miv, iv, feats, pid, w, sp)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="checkout holding the first port's stats_fold.cu")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "fold_vs_parent.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("fold_vs_parent: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke
    from khg_tpu_torch.stats.fold_kernel import fold_cuda

    lib = build_parent(args.parent / "khg_tpu_torch" / "csrc" / "stats_fold.cu")
    problems = {}
    (g, miv, iv, _w), _t, _o, x, _l, _s, pid, fw, sp = chip_smoke.tri_batch(
        chip_smoke.triphone_system())
    problems["triphone_batch"] = [g, miv, iv, x, pid, fw, sp]
    for name, shape in (("K8-D13", (3, 70, 13, 40, 8, 13, 0)),
                        ("K32-D16-pad3", (4, 50, 16, 61, 32, 21, 3)),
                        ("K40-D80-pad5", (2, 33, 80, 30, 40, 9, 5))):
        problems[name] = random_problem(len(problems), *shape)
    result = {"card": chip_smoke.card_line()}
    all_equal = True
    for name, a in problems.items():
        new = fold_cuda(*a)
        old = parent_fold(lib, *a)
        torch.cuda.synchronize()
        eq = {k: bool(torch.equal(n, o)) for k, n, o in zip(("stats", "ll", "frames"), new, old)}
        eq["tot_log_like"] = bool(torch.equal(torch.sum(new[1]), torch.sum(old[1])))
        eq["tot_frames"] = bool(torch.equal(torch.sum(new[2]), torch.sum(old[2])))
        diff = max(float((n - o).abs().max()) if n.numel() else 0.0
                   for n, o in zip(new, old))
        parent_ms = chip_smoke.time_ms(lambda: parent_fold(lib, *a), reps=10)
        ms = chip_smoke.time_ms(lambda: fold_cuda(*a), reps=10)
        ms2 = chip_smoke.time_ms(lambda: fold_cuda(*a), reps=10)
        parent_ms2 = chip_smoke.time_ms(lambda: parent_fold(lib, *a), reps=10)
        all_equal &= all(eq.values())
        result[name] = dict(shape=dict(zip("BTD", a[3].shape), K=a[1].shape[1],
                                       P=a[1].shape[0], S=a[6].shape[1]),
                            bit_equal=eq, max_abs_diff=diff,
                            ms=[ms, ms2], parent_ms=[parent_ms, parent_ms2])
    result["all_bit_equal"] = all_equal
    line = json.dumps(result)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    print(line)
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
