#!/usr/bin/env python3
"""Run a checkout's chip_smoke.py and keep, to the bit, the records that
its training phases produce, so that two commits can be compared on one
card.

    python3 tools/chip_records.py run ROOT OUT.json
    python3 tools/chip_records.py compare A.json B.json

``run`` imports chip_smoke.py and khg_tpu_torch from ROOT (a checkout,
e.g. a parent commit unpacked with ``git archive``), wraps
``train_corpus``, ``EStepPipeline.em_passes_resident`` and
``EStepPipeline.fb_em_passes_resident`` so that every call's result is
kept, runs ``chip_smoke.main()`` (all its phases and checks, its output
as usual) and writes the kept records as hexadecimal floats, in call
order: stage 2's average log-likelihood per pass and failures, and the
(passes, columns) record of every resident hard and soft EM run of
phases 4 to 7.  ``compare`` matches the k-th call of each name in one
file with the k-th in the other and prints whether they are equal and,
for each call where they differ, the largest difference of each of its
records; it exits 1 if they differ.  ``run`` needs one
NVIDIA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def _hex(values):
    import numpy as np

    return [float(x).hex() for x in np.asarray(values, dtype=np.float64).ravel()]


def run(root: Path, out: Path) -> int:
    import numpy as np

    sys.path.insert(0, str(root.resolve()))
    import chip_smoke
    from khg_tpu_torch.recipes import corpus_train, pipeline

    kept = []
    train = corpus_train.train_corpus

    def train_corpus(*args, **kw):
        res = train(*args, **kw)
        kept.append(dict(call="train_corpus", avg_loglikes=_hex(res.avg_loglikes),
                         align_failures=_hex(res.align_failures)))
        return res

    def keep(name):
        fn = getattr(pipeline.EStepPipeline, name)

        def wrapped(self, *args, **kw):
            out = fn(self, *args, **kw)  # (model, record[, ...])
            rec_np = np.asarray(out[1])
            kept.append(dict(call=name, shape=list(rec_np.shape), record=_hex(rec_np)))
            return out
        return wrapped

    corpus_train.train_corpus = train_corpus
    for name in ("em_passes_resident", "fb_em_passes_resident"):
        setattr(pipeline.EStepPipeline, name, keep(name))
    rc = chip_smoke.main()
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(root=str(root), rc=rc, records=kept)) + "\n")
    print(f"chip_records: {len(kept)} records from {root} -> {out} (chip_smoke rc {rc})")
    return rc


def compare(a: Path, b: Path) -> int:
    ra = json.loads(a.read_text())["records"]
    rb = json.loads(b.read_text())["records"]
    # the k-th call of each name in one file against the k-th in the other
    names = list(dict.fromkeys(r["call"] for r in ra + rb))
    differ = 0
    for name in names:
        xa = [r for r in ra if r["call"] == name]
        xb = [r for r in rb if r["call"] == name]
        if len(xa) != len(xb):
            differ += 1
            print(f"{name}: {len(xa)} calls against {len(xb)}; the first "
                  f"{min(len(xa), len(xb))} compared")
        for k, (x, y) in enumerate(zip(xa, xb)):
            if x == y:
                continue
            differ += 1
            gaps = {}
            for key in (key for key in x if key not in ("call", "shape")):
                vx = [float.fromhex(v) for v in x[key]]
                vy = [float.fromhex(v) for v in y.get(key, [])]
                gaps[key] = (max((abs(p - q) for p, q in zip(vx, vy)), default=0.0)
                             if len(vx) == len(vy) else f"{len(vx)} values against {len(vy)}")
            print(f"{name} call {k} differs: max |difference| {gaps}")
    if differ:
        print(f"records differ ({differ} findings above)")
        return 1
    print(f"records equal to the bit: {len(ra)} calls "
          f"({', '.join(f'{c} x{[r['call'] for r in ra].count(c)}' for c in names)})")
    return 0


def main() -> int:
    if len(sys.argv) != 4 or sys.argv[1] not in ("run", "compare"):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    mode, x, y = sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3])
    return run(x, y) if mode == "run" else compare(x, y)


if __name__ == "__main__":
    sys.exit(main())
