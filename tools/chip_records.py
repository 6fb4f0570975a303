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
phases 4 to 7.  ``compare`` prints whether two such files are equal and
where they first differ; it exits 1 if they differ.  ``run`` needs one
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
    if len(ra) != len(rb):
        print(f"records differ: {len(ra)} calls against {len(rb)}")
        return 1
    for i, (x, y) in enumerate(zip(ra, rb)):
        if x != y:
            print(f"records differ from call {i} ({x['call']})")
            return 1
    calls = [r["call"] for r in ra]
    print(f"records equal to the bit: {len(ra)} calls "
          f"({', '.join(f'{c} x{calls.count(c)}' for c in dict.fromkeys(calls))})")
    return 0


def main() -> int:
    if len(sys.argv) != 4 or sys.argv[1] not in ("run", "compare"):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    mode, x, y = sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3])
    return run(x, y) if mode == "run" else compare(x, y)


if __name__ == "__main__":
    sys.exit(main())
