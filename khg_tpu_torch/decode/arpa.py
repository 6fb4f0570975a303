"""ARPA language model -> G FST.

Builds the standard backoff word acceptor: one state per n-gram history,
n-gram arcs emit the word with cost -ln(10)·logprob, and every non-null
history state gets a backoff arc to its longest existing suffix history
with the backoff cost, carrying the ``#0`` disambiguation symbol on the
input side (so LG stays determinizable).

Functional equivalent of kaldilm.arpa2fst as used by the reference's
decode recipe (reference egs/yesno/decode.py:52-73).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from khg_tpu_torch.fstlib.fst import Arc, VectorFst

LOG10 = math.log(10.0)


def parse_arpa(text: str) -> Dict[int, List[Tuple[float, Tuple[str, ...], float]]]:
    """order -> list of (logprob10, ngram words, backoff10)."""
    ngrams: Dict[int, List[Tuple[float, Tuple[str, ...], float]]] = {}
    cur_order = None
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("ngram ") or line == "\\data\\":
            continue
        if line == "\\end\\":
            break
        if line.startswith("\\") and line.endswith("-grams:"):
            cur_order = int(line[1 : line.index("-")])
            ngrams[cur_order] = []
            continue
        if cur_order is None:
            continue
        parts = line.split()
        logprob = float(parts[0])
        words = tuple(parts[1 : 1 + cur_order])
        backoff = (
            float(parts[1 + cur_order]) if len(parts) > 1 + cur_order else 0.0
        )
        ngrams[cur_order].append((logprob, words, backoff))
    return ngrams


def arpa_to_fst(
    arpa_text: str,
    word2id: Dict[str, int],
    disambig_symbol: str = "#0",
    bos: str = "<s>",
    eos: str = "</s>",
) -> VectorFst:
    """Word-level backoff acceptor (backoff arcs have ilabel #0, olabel eps)."""
    ngrams = parse_arpa(arpa_text)
    max_order = max(ngrams)
    disambig_id = word2id.get(disambig_symbol, 0)

    # Histories that need a state: every n-gram context, plus every n-gram
    # with an explicit backoff weight (it can be a context of longer paths),
    # plus the null history.
    histories = {()}
    backoff_of: Dict[Tuple[str, ...], float] = {}
    for order, entries in ngrams.items():
        for logprob, words, backoff in entries:
            histories.add(words[:-1])
            if order < max_order:
                h = words[-(max_order - 1):] if max_order > 1 else ()
                histories.add(h)
                backoff_of[h] = backoff

    fst = VectorFst()
    state_of: Dict[Tuple[str, ...], int] = {}
    for h in sorted(histories, key=lambda h: (len(h), h)):
        state_of[h] = fst.add_state()

    def suffix_state(words: Tuple[str, ...]) -> int:
        h = words[-(max_order - 1):] if max_order > 1 else ()
        while h not in state_of:
            h = h[1:]
        return state_of[h]

    # n-gram arcs and finals
    for order, entries in ngrams.items():
        for logprob, words, backoff in entries:
            hist, word = words[:-1], words[-1]
            src = state_of[hist]
            cost = -logprob * LOG10
            if word == eos:
                fst.final[src] = min(fst.final[src], cost)
            elif word == bos:
                pass  # <s> is never emitted; its state exists as a history
            else:
                if word not in word2id:
                    raise KeyError(f"ARPA word {word!r} not in the word table")
                fst.add_arc(
                    src, Arc(word2id[word], word2id[word], cost, suffix_state(words))
                )

    # backoff arcs: from each non-null history to its longest proper suffix
    for h in histories:
        if not h:
            continue
        shorter = h[1:]
        while shorter not in state_of:
            shorter = shorter[1:]
        cost = -backoff_of.get(h, 0.0) * LOG10
        fst.add_arc(state_of[h], Arc(disambig_id, 0, cost, state_of[shorter]))

    start = state_of.get((bos,), state_of[()])
    fst.set_start(start)
    return fst
