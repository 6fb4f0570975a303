"""Test-time decoding-graph (HCLG) construction.

  L_disambig (lexicon WITH #N symbols) ∘ G  -> determinize-star (log)
  -> context expansion -> H ∘ CLG -> remove H-side disambig -> self-loops

Mirrors the reference decode recipe (reference egs/yesno/decode.py:
76-141) with reorder=False self-loops (as decode.py uses).  Handles
general (N, P) context: trees with N > 1 go through compose_context with
a subsequential loop when P != N-1 (exercised end-to-end by
khg_tpu's tests/test_triphone_decode.py with an N=3, P=1 tree).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from khg_tpu_torch.fstlib.fst import (
    VectorFst,
    compose,
    determinize_star,
    minimize_encoded,
    remove_input_symbols,
)
from khg_tpu_torch.graph.h_builder import add_self_loops, get_h_transducer
from khg_tpu_torch.lang.lexicon import Lexiconp
from khg_tpu_torch.lang.lfst import make_lexicon_fst_with_silence
from khg_tpu_torch.model.context_dep import ContextDependency
from khg_tpu_torch.model.transition_model import TransitionModel


def build_hclg(
    lexiconp_disambig: Lexiconp,
    G: VectorFst,
    transition_model: TransitionModel,
    tree: ContextDependency,
    sil_prob: float = 0.5,
    sil_phone: str = "SIL",
    transition_scale: float = 1.0,
    self_loop_scale: float = 1.0,
    reorder: bool = False,
) -> VectorFst:
    L = make_lexicon_fst_with_silence(
        lexiconp=lexiconp_disambig, sil_prob=sil_prob, sil_phone=sil_phone
    )
    L.arcsort("olabel")
    G.arcsort("ilabel")
    LG = compose(L, G)
    assert LG.start != -1, "empty LG"
    LG = determinize_star(LG, semiring="log")

    disambig_ids = lexiconp_disambig.disambig_phone_ids()
    N, P = tree.context_width, tree.central_position
    from khg_tpu_torch.graph.context import compose_context

    phones = transition_model.phones
    subseq = max(phones[-1] + 1, (max(disambig_ids) + 1) if disambig_ids else 0)
    if P != N - 1:
        from khg_tpu_torch.fstlib.fst import add_subsequential_loop

        add_subsequential_loop(subseq, LG)
    CLG, ilabel_info = compose_context(LG, phones, disambig_ids, N, P, subseq)

    Ha, disambig_syms_h = get_h_transducer(
        ilabel_info, tree, transition_model, transition_scale=transition_scale
    )
    Ha.arcsort("olabel")
    HCLGa = compose(Ha, CLG)
    assert HCLGa.start != -1, "empty HCLGa"

    if disambig_syms_h:
        remove_input_symbols(disambig_syms_h, HCLGa)

    HCLG = add_self_loops(
        transition_model,
        HCLGa,
        self_loop_scale=self_loop_scale,
        disambig_syms=[],
        reorder=reorder,
        check_no_self_loops=True,
    )
    return HCLG
