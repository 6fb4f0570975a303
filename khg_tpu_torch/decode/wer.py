"""WER scoring: edit-distance alignment and an error report.

Report content matches the fields of the reference's error report
(reference scripts/utils.py:7-165) — overall %WER line, per-utt
alignments, substitution/deletion/insertion tallies, per-word stats —
but is built here from a flat edit-operation record stream rather than
the reference's parallel counter dictionaries, with an internal aligner
instead of kaldialign.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Iterable, List, Sequence, TextIO, Tuple

ERR = "*"

# edit-operation kinds
_COR, _SUB, _INS, _DEL = "cor", "sub", "ins", "del"


def levenshtein_align(
    ref: Sequence[str], hyp: Sequence[str], gap: str = ERR
) -> List[Tuple[str, str]]:
    """Minimum-edit alignment of two sequences as (ref, hyp) pairs with
    ``gap`` marking insertions/deletions (sub/ins/del all cost 1).

    Rolling two-row cost DP plus a dense backpointer byte matrix — the
    alignment is recovered from the backpointers alone.
    """
    n, m = len(ref), len(hyp)
    DIAG, UP, LEFT = 0, 1, 2
    bp = bytearray((n + 1) * (m + 1))
    width = m + 1
    prev = list(range(m + 1))
    for j in range(1, m + 1):
        bp[j] = LEFT
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        bp[i * width] = UP
        ri = ref[i - 1]
        for j in range(1, m + 1):
            c_diag = prev[j - 1] + (ri != hyp[j - 1])
            c_up = prev[j] + 1
            c_left = cur[j - 1] + 1
            if c_diag <= c_up and c_diag <= c_left:
                cur[j], bp[i * width + j] = c_diag, DIAG
            elif c_up <= c_left:
                cur[j], bp[i * width + j] = c_up, UP
            else:
                cur[j], bp[i * width + j] = c_left, LEFT
        prev = cur
    pairs: List[Tuple[str, str]] = []
    i, j = n, m
    while i or j:
        move = bp[i * width + j]
        if move == DIAG and i and j:
            i, j = i - 1, j - 1
            pairs.append((ref[i], hyp[j]))
        elif move == UP and i:
            i -= 1
            pairs.append((ref[i], gap))
        else:
            j -= 1
            pairs.append((gap, hyp[j]))
    pairs.reverse()
    return pairs


@dataclass(frozen=True)
class _Op:
    """One aligned token pair from one utterance."""

    kind: str  # _COR/_SUB/_INS/_DEL
    ref: str   # "" for insertions
    hyp: str   # "" for deletions


def _ops_of(pairs: Iterable[Tuple[str, str]]) -> List[_Op]:
    ops = []
    for r, h in pairs:
        if r == ERR:
            ops.append(_Op(_INS, "", h))
        elif h == ERR:
            ops.append(_Op(_DEL, r, ""))
        elif r == h:
            ops.append(_Op(_COR, r, h))
        else:
            ops.append(_Op(_SUB, r, h))
    return ops


class _Report:
    """Error-report accumulator over a flat stream of edit ops."""

    def __init__(self) -> None:
        self.ops: List[_Op] = []
        self.utt_lines: List[str] = []
        self.ref_len = 0

    def add_utt(self, utt_id: str, ref: Sequence[str], hyp: Sequence[str]):
        pairs = levenshtein_align(ref, hyp)
        self.ops.extend(_ops_of(pairs))
        self.ref_len += len(ref)
        rendered = " ".join(
            r if r == h else f"({r}->{h})" for r, h in pairs
        )
        self.utt_lines.append(f"{utt_id}:\t{rendered}")

    def count(self, kind: str) -> int:
        return sum(op.kind == kind for op in self.ops)

    @property
    def num_errs(self) -> int:
        return sum(op.kind != _COR for op in self.ops)

    def wer_percent(self) -> float:
        return 100.0 * self.num_errs / max(self.ref_len, 1)

    def _ranked(self, counter: Counter) -> List[Tuple[int, object]]:
        return sorted(((c, k) for k, c in counter.items()), reverse=True)

    def render(self, f: TextIO, name: str, enable_log: bool) -> float:
        n_ins, n_del, n_sub = (
            self.count(_INS), self.count(_DEL), self.count(_SUB)
        )
        wer = self.wer_percent()
        headline = (
            f"[{name}] %WER {wer:.2f}% "
            f"[{self.num_errs} / {self.ref_len}, {n_ins} ins, "
            f"{n_del} del, {n_sub} sub ]"
        )
        if enable_log:
            print(headline)
        print(headline, file=f)
        print(
            f"Errors: {n_ins} insertions, {n_del} deletions, "
            f"{n_sub} substitutions, over {self.ref_len} reference words "
            f"({self.count(_COR)} correct)",
            file=f,
        )

        print("PER-UTT DETAILS: corr or (ref->hyp)", file=f)
        for line in self.utt_lines:
            print(line, file=f)

        print("SUBSTITUTIONS: count ref -> hyp", file=f)
        subs = Counter((o.ref, o.hyp) for o in self.ops if o.kind == _SUB)
        for c, (r, h) in self._ranked(subs):
            print(f"{c}   {r} -> {h}", file=f)
        print("DELETIONS: count ref", file=f)
        for c, r in self._ranked(
            Counter(o.ref for o in self.ops if o.kind == _DEL)
        ):
            print(f"{c}   {r}", file=f)
        print("INSERTIONS: count hyp", file=f)
        for c, h in self._ranked(
            Counter(o.hyp for o in self.ops if o.kind == _INS)
        ):
            print(f"{c}   {h}", file=f)

        print(
            "PER-WORD STATS: word corr tot_errs count_in_ref count_in_hyp",
            file=f,
        )
        vocab = {o.ref for o in self.ops if o.ref} | {
            o.hyp for o in self.ops if o.hyp
        }
        rows = []
        for w in vocab:
            corr = sum(o.kind == _COR and o.ref == w for o in self.ops)
            errs = sum(
                o.kind != _COR and w in (o.ref, o.hyp) for o in self.ops
            )
            in_ref = sum(o.ref == w for o in self.ops)
            in_hyp = sum(o.hyp == w for o in self.ops)
            rows.append((errs, w, corr, in_ref, in_hyp))
        for errs, w, corr, in_ref, in_hyp in sorted(rows, reverse=True):
            print(f"{w}   {corr}   {errs}   {in_ref}   {in_hyp}", file=f)
        return wer


def write_error_stats(
    f: TextIO,
    test_set_name: str,
    results: List[Tuple[str, List[str], List[str]]],
    enable_log: bool = True,
) -> float:
    """Write the WER report for ``results`` = [(utt_id, ref, hyp)] and
    return the WER in percent."""
    report = _Report()
    for utt_id, ref, hyp in results:
        report.add_utt(utt_id, ref, hyp)
    return report.render(f, test_set_name, enable_log)
