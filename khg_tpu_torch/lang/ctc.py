"""CTC topology as an FST alternative to HMM topologies.

Builds the fully-connected CTC topology over token ids (blank = 0),
shifts labels by one to resolve the blank-vs-epsilon conflict, and adds
disambiguation self-loops for composition with L.

Reference semantics: reference scripts/ctc_topo.py:6-105.  The
"decodable" for CTC is a (T, vocab) log-softmax matrix; with the +1 label
shift, ilabel i scores log_softmax[t, i-1] — expressed here as the
identity-minus-one ``id2pdf`` map consumed by the decoders.
"""

from __future__ import annotations

import numpy as np

from khg_tpu_torch.fstlib.fst import Arc, VectorFst


def build_standard_ctc_topo(max_token_id: int) -> VectorFst:
    """Fully-connected CTC topology; state i = "last emitted token i".

    Self-loops (repeats) output epsilon; label 0 is the blank.
    """
    num_states = max_token_id + 1
    fst = VectorFst()
    for i in range(num_states):
        s = fst.add_state()
        fst.set_final(s, 0.0)
    fst.set_start(0)
    for i in range(num_states):
        for k in range(num_states):
            fst.add_arc(i, Arc(k, k if i != k else 0, 0.0, k))
    return fst


def add_one(fst: VectorFst, treat_ilabel_zero_specially: bool) -> None:
    """Shift labels by +1 (blank 0 would collide with epsilon), in place."""
    for arcs in fst.arcs:
        for a in arcs:
            if not treat_ilabel_zero_specially or a.ilabel != 0:
                a.ilabel += 1
            if a.olabel != 0:
                a.olabel += 1


def add_disambig_self_loops(fst: VectorFst, start: int, end: int) -> None:
    """Self-loop (eps : disambig-id) on every state for ids start..end."""
    for s in range(fst.num_states):
        for i in range(start, end + 1):
            fst.add_arc(s, Arc(0, i, 0.0, s))


def ctc_id2pdf(vocab_size: int) -> np.ndarray:
    """(vocab_size+1,) map: shifted ilabel i -> log-softmax column i-1."""
    arr = np.arange(-1, vocab_size, dtype=np.int32)
    return arr


def build_hl_graph(
    max_token_id: int,
    lexicon_fst,
    disambig_start: int = 0,
    disambig_end: int = -1,
):
    """HL = CTC topology ∘ L: decode token posteriors directly to words.

    ``lexicon_fst`` maps tokens (as phones, UNSHIFTED ids) to words and may
    contain disambiguation symbols with ids in [disambig_start,
    disambig_end].  The topology gets +1-shifted input labels (blank=1)
    and disambig self-loops so the composition is exact; the result's
    input labels are shifted token ids (use ``ctc_id2pdf``).

    Contract: non-blank token id v (1..max_token_id) IS the lexicon's phone
    id for that token; blank is 0 and never reaches L.  Only the INPUT side
    of the topology is shifted (+1, so blank=1 is distinct from epsilon);
    output labels stay unshifted to match L.

    Mirrors the reference's CTC decode flow
    (reference scripts/test_ctc_topo.py:64-176).
    """
    return build_hlg_graph(
        max_token_id, lexicon_fst, None, disambig_start, disambig_end
    )


def build_hlg_graph(
    max_token_id: int,
    lexicon_fst,
    G,
    disambig_start: int = 0,
    disambig_end: int = -1,
):
    """HLG = CTC topology ∘ det(L ∘ G): token posteriors -> LM-weighted
    words.  ``G`` is a word-level acceptor (e.g. decode.arpa.arpa_to_fst
    output); pass None for the no-LM HL graph.  Same label contract as
    build_hl_graph (input side +1-shifted, use ``ctc_id2pdf``).

    Mirrors the reference's HLG decode construction
    (reference scripts/test_ctc_topo.py:64-176) minus the context
    expansion CTC does not need.
    """
    from khg_tpu_torch.fstlib.fst import DeterminizeError, compose, determinize_star

    right = lexicon_fst.copy()
    if G is not None:
        right.arcsort("olabel")
        Gs = G.copy()
        Gs.arcsort("ilabel")
        right = compose(right, Gs)
        assert right.start != -1, "empty LG (word symbol mismatch?)"
        right = determinize_star(right, semiring="log")

    topo = build_standard_ctc_topo(max_token_id)
    for arcs in topo.arcs:
        for a in arcs:
            a.ilabel += 1  # input-side shift only
    if disambig_end >= disambig_start and disambig_end > 0:
        add_disambig_self_loops(topo, disambig_start, disambig_end)
    right.arcsort("ilabel")
    topo.arcsort("olabel")
    hl = compose(topo, right)
    assert hl.start != -1, "empty HL (token/lexicon symbol mismatch?)"
    try:
        # size optimization only, so cap the subset expansion: with an
        # LM on the right the weighted cycles of topo ∘ LG need not be
        # log-determinizable, and the decoders handle nondeterministic
        # input graphs directly
        hl = determinize_star(
            hl, semiring="log", max_states=20 * max(hl.num_states, 1)
        )
    except DeterminizeError:
        pass
    return hl


def build_ctc_training_graph(
    tokens: list, vocab_size: int
) -> VectorFst:
    """CTC alignment graph for a token sequence (blank-insertion form).

    States follow the standard CTC lattice: optional blank between tokens,
    repeated tokens require a separating blank.  Input labels are
    SHIFTED token ids (token t -> t+1, blank -> 1) so label 0 stays
    epsilon-free; use ``ctc_id2pdf`` to map them onto log-softmax columns.
    """
    blank = 0
    fst = VectorFst()
    # interleave blanks: B t1 B t2 B ... tn B
    seq = [blank]
    for t in tokens:
        seq.extend([t, blank])
    n = len(seq)
    states = [fst.add_state() for _ in range(n + 1)]
    fst.set_start(states[0])
    fst.set_final(states[n], 0.0)
    if n >= 2:
        fst.set_final(states[n - 1], 0.0)  # may end on last token

    def lab(tok):
        return tok + 1

    for i, tok in enumerate(seq):
        # self-loop (stay on this symbol)
        fst.add_arc(states[i], Arc(lab(tok), 0, 0.0, states[i]))
        # advance
        olabel = tok + 1 if tok != blank else 0
        fst.add_arc(states[i], Arc(lab(tok), olabel, 0.0, states[i + 1]))
        # skip the following blank when the next-next token differs
        if tok != blank and i + 2 < n and seq[i + 2] != tok:
            fst.add_arc(states[i], Arc(lab(tok), olabel, 0.0, states[i + 2]))
    # the leading blank is optional: the start state also offers the first
    # token's arcs (paths may begin at lattice position 0 or 1)
    if len(tokens) > 0:
        for a in list(fst.arcs[states[1]]):
            dst = states[1] if a.nextstate == states[1] else a.nextstate
            fst.add_arc(states[0], Arc(a.ilabel, a.olabel, a.weight, dst))
    return fst
