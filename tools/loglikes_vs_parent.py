#!/usr/bin/env python3
"""Hold the fused GMM log-likelihood kernel (kernel B,
``csrc/loglikes.cu``) against another commit's kernel on one card, to
the bit.

    python3 tools/loglikes_vs_parent.py PARENT_ROOT [--out FILE]   (default build/loglikes_vs_parent.json)

PARENT_ROOT is a checkout of a commit whose ``csrc/loglikes.cu`` has the
C entry point ``launch_fused_loglikes(x2, model, gconst, out, N, P, K,
D2P, bf16, stream)`` (for example a parent commit unpacked with ``git
archive``).  That source is built with nvcc for sm_90a into
``build/loglikes_parent/``; each ``--variant`` builds a copy of this
checkout's source with other tile constants (``constexpr int R = 4;``
and the like, patched in the copy) beside it.  All run on the same
buffers (the operands ``gmm.fused_loglikes.kernel_operands`` prepares), in f32 and
in bf16, on chip_smoke.py's two check problems (N=131,072 rows at D=23;
4,096 rows of the first triphone batch at D=80, P=2,051, K=32), on that
whole batch (N=19,200, what phase 7's narrow route scores per launch)
and on random problems: padding components, a pdf with none real, N not
a multiple of the kernel's 128-row tile, P not a multiple of its 8-pdf
tile, D of 13, 23, 39, 80 and 100.  Prints one JSON object: per problem
and type, whether each kernel's outputs are bit-equal to the parent's,
the largest difference, and every kernel's times, taken in turns
(parent, new, variants, then back: variants, new, parent).  Needs one
NVIDIA card and nvcc; exits 1 unless every output is bit-equal.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build(src: Path, name: str, constants=()):
    """nvcc a copy of ``src`` for sm_90a into build/loglikes_<name>/,
    each ``NAME=VALUE`` of ``constants`` patched into its ``constexpr int
    NAME = ...;`` line (a constant the source lacks is an error); returns
    (library, ptxas's report)."""
    from khg_tpu_torch import kernels

    out = ROOT / "build" / f"loglikes_{name}"
    out.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    for spec in constants:
        key, value = spec.split("=", 1)
        text, n = re.subn(rf"constexpr int {re.escape(key)} = [^;]+;",
                          f"constexpr int {key} = {value};", text, count=1)
        if n != 1:
            raise RuntimeError(f"{src.name}: no constant {key} to patch")
    cu = out / f"loglikes_{name}.cu"
    cu.write_text(text)
    so = out / f"libloglikes_{name}.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                           "-I", str(src.parent), "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.launch_fused_loglikes.argtypes = [P] * 4 + [I] * 5 + [P]
    lib.launch_fused_loglikes.restype = ctypes.c_int
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    return lib, report


def run(lib, ops):
    """One launch of ``lib``'s kernel on the prepared operands: (N, P)."""
    import torch

    from khg_tpu_torch import kernels

    x2, A, g, N, P, K, d2p, bf16 = ops
    out = torch.empty((N, P), dtype=torch.float32, device="cuda")
    err = lib.launch_fused_loglikes(x2.data_ptr(), A.data_ptr(), g.data_ptr(),
                                    out.data_ptr(), N, P, K, d2p, int(bf16),
                                    kernels.stream_handle(x2.device))
    if err:
        raise RuntimeError(f"fused_loglikes failed to launch: error {err}")
    return out


def random_problem(seed, N, D, P, K):
    """Random model with 0 to K real components per pdf (pdf 0 none),
    padding components at gconst -inf with zero rows, and N rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    means = rng.standard_normal((P, K, D))
    var = rng.uniform(0.5, 2.0, (P, K, D))
    w = rng.dirichlet(np.ones(K), P)
    g = np.log(w) - 0.5 * (D * np.log(2 * np.pi) + np.log(var).sum(-1)
                           + (means ** 2 / var).sum(-1))
    iv = 1.0 / var
    nreal = rng.integers(0, K + 1, P)
    nreal[0] = 0
    for p in range(P):
        g[p, nreal[p]:] = -np.inf
        means[p, nreal[p]:] = 0.0
        iv[p, nreal[p]:] = 0.0
    x = 3.0 * rng.standard_normal((N, D))
    return [torch.as_tensor(a.astype(np.float32), device="cuda")
            for a in (g, means * iv, iv, x)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="checkout holding the other loglikes.cu")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "loglikes_vs_parent.json")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=KEY=V,KEY=V",
                    help="also build a copy of this checkout's loglikes.cu with these "
                         "tile constants (e.g. r8=R=8,MIN_BLOCKS=2) and hold it to the "
                         "parent too")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("loglikes_vs_parent: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke
    from khg_tpu_torch import kernels
    from khg_tpu_torch.gmm.fused_loglikes import kernel_operands

    libs = {"parent": build(args.parent / "khg_tpu_torch" / "csrc" / "loglikes.cu", "parent")[0],
            "new": kernels.lib()}
    result = {"card": chip_smoke.card_line(), "ptxas": {"new": [
        ln.strip() for ln in kernels.build_info.get("ptxas", {}).get("loglikes.cu", "").splitlines()
        if "registers" in ln or "spill" in ln]}}
    for spec in args.variant:
        name, defs = spec.split("=", 1)
        libs[name], result["ptxas"][name] = build(kernels.CSRC / "loglikes.cu", name,
                                                 defs.split(","))
    problems = {}
    g, miv, iv, x, _nreal = chip_smoke.loglikes_problem(50)
    problems["check_d23"] = (g, miv, iv, x)
    (g, miv, iv, _w), _t, _o, x, _l, _s, _p, _f, _sp = chip_smoke.tri_batch(
        chip_smoke.triphone_system())
    x = x.reshape(-1, x.shape[-1])
    problems["check_d80"] = (g, miv, iv, x[:4096].contiguous())
    problems["phase7_batch"] = (g, miv, iv, x.contiguous())
    for name, shape in (("D13-N300-P37-K5", (300, 13, 37, 5)),
                        ("D23-N1000-P50-K24", (1000, 23, 50, 24)),
                        ("D39-N129-P17-K13", (129, 39, 17, 13)),
                        ("D80-N200-P33-K32", (200, 80, 33, 32)),
                        ("D80-N1-P1-K9", (1, 80, 1, 9)),
                        ("D100-N515-P21-K7", (515, 100, 21, 7))):
        problems[name] = random_problem(len(problems), *shape)
    all_equal = True
    for name, model in problems.items():
        for dtype in (None, "bfloat16"):
            ops = kernel_operands(*model, compute_dtype=dtype)
            ref = run(libs["parent"], ops)
            row = dict(N=ops[3], P=ops[4], K=ops[5], D2P=ops[6])
            for lib_name, lib in libs.items():
                if lib_name == "parent":
                    continue
                a = run(lib, ops)
                torch.cuda.synchronize()
                eq = bool(torch.equal(a, ref))
                fin = torch.isfinite(a) & torch.isfinite(ref)
                diff = float((a[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
                all_equal &= eq
                row[lib_name] = dict(bit_equal=eq, max_abs_diff=diff)
            # times in turns: parent, new, variants, then back again
            reps = max(3, min(20, int(2e9 // max(1, ops[3] * ops[4] * ops[5] * ops[6]))))
            order = list(libs)
            for lib_name in order + order[::-1]:
                t = chip_smoke.time_ms(lambda: run(libs[lib_name], ops), reps=reps)
                row.setdefault("ms", {}).setdefault(lib_name, []).append(t)
            result[f"{name}/{dtype or 'f32'}"] = row
            print(f"{name} {dtype or 'f32'}: " + "; ".join(
                f"{k} {', '.join(f'{t:.4f}' for t in v)} ms"
                + ("" if k == "parent" else f" (bit-equal {row[k]['bit_equal']})")
                for k, v in row["ms"].items()), flush=True)
    result["all_bit_equal"] = all_equal
    line = json.dumps(result)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    print(line)
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
