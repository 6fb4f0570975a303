"""Per-utterance training-graph compiler (HCLG for a linear transcript).

Pipeline (reference semantics,
reference kaldi-hmm-gmm/csrc/training-graph-compiler.cc:20-168):

  transcript -> linear word acceptor G
  LG    = compose(L, G)                     (L olabel-sorted)
  CLG   = context expansion (monophone: identity relabel + ilabel_info)
  H     = get_h_transducer(ilabel_info, ...)
  HCLGa = compose(H, CLG)
  determinize-star in the log semiring
  remove the H-side disambig input symbols
  minimize (encoded)
  add self-loops (reorder=True)

The resulting graph has transition-ids on the input side and word ids on
the output side.  Weights include transition probs scaled by
transition_scale/self_loop_scale (default 1.0/1.0 at compile time; the
aligner typically applies its own scales on a graph compiled with the
defaults, via add_transition_probs on a copy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from khg_tpu_torch.fstlib.fst import (
    VectorFst,
    add_subsequential_loop,
    compose,
    determinize_star,
    make_linear_acceptor,
    minimize_encoded,
    remove_input_symbols,
)
from khg_tpu_torch.graph.context import compose_context_monophone
from khg_tpu_torch.graph.h_builder import add_self_loops, get_h_transducer
from khg_tpu_torch.model.context_dep import ContextDependency
from khg_tpu_torch.model.transition_model import TransitionModel


@dataclass(frozen=True)
class TrainingGraphCompilerOptions:
    transition_scale: float = 1.0
    self_loop_scale: float = 1.0
    rm_eps: bool = False
    reorder: bool = True


class TrainingGraphCompiler:
    def __init__(
        self,
        trans_model: TransitionModel,
        ctx_dep: ContextDependency,
        lex_fst: VectorFst,
        disambig_syms: Optional[List[int]] = None,
        opts: TrainingGraphCompilerOptions = TrainingGraphCompilerOptions(),
        use_native: Optional[bool] = None,
    ):
        """``use_native``: compose, determinize-star and minimize on the
        native C++ FST core (fstlib/native.py); None means whenever its
        library builds and loads.  Its graphs equal the pure-Python
        fstlib's arc for arc, with weights rounded to f32."""
        self.trans_model = trans_model
        self.ctx_dep = ctx_dep
        self.opts = opts
        self.disambig_syms = sorted(set(disambig_syms or []))

        from khg_tpu_torch.fstlib import native as native_mod

        if use_native is None:
            use_native = native_mod.available()
        self._native = native_mod if (use_native and native_mod.available()) else None

        phone_syms = trans_model.phones
        for d in self.disambig_syms:
            if d in phone_syms:
                raise ValueError(f"Disambiguation symbol {d} is also a phone")

        self.subsequential_symbol = phone_syms[-1] + 1
        if self.disambig_syms and self.subsequential_symbol <= self.disambig_syms[-1]:
            self.subsequential_symbol = self.disambig_syms[-1] + 1

        self.lex_fst = lex_fst.copy()
        N, P = ctx_dep.context_width, ctx_dep.central_position
        if P != N - 1:
            add_subsequential_loop(self.subsequential_symbol, self.lex_fst)
        self.lex_fst.arcsort("olabel")

    def compile_graph_from_text(self, transcript: List[int]) -> VectorFst:
        word_fst = make_linear_acceptor(transcript)
        return self.compile_graph(word_fst)

    def compile_graph(self, word_fst: VectorFst) -> VectorFst:
        phone2word_fst = compose(self.lex_fst, word_fst)
        return self.compile_graph_from_lg(phone2word_fst)

    def compile_graph_from_lg(self, phone2word_fst: VectorFst) -> VectorFst:
        assert phone2word_fst.start != -1, "empty LG (transcript not in lexicon?)"
        N, P = self.ctx_dep.context_width, self.ctx_dep.central_position
        from khg_tpu_torch.graph.context import compose_context

        ctx2word_fst, ilabel_info = compose_context(
            phone2word_fst,
            self.trans_model.phones,
            self.disambig_syms,
            N,
            P,
            self.subsequential_symbol,
        )
        assert ctx2word_fst.start != -1

        H, disambig_syms_h = get_h_transducer(
            ilabel_info,
            self.ctx_dep,
            self.trans_model,
            transition_scale=self.opts.transition_scale,
        )
        H.arcsort("olabel")
        compose_fn = self._native.compose if self._native else compose
        det_fn = (
            self._native.determinize_star if self._native else determinize_star
        )
        min_fn = (
            self._native.minimize_encoded if self._native else minimize_encoded
        )
        trans2word_fst = compose_fn(H, ctx2word_fst)
        assert trans2word_fst.start != -1

        # Epsilon removal + determinization, summing in the log semiring.
        trans2word_fst = det_fn(trans2word_fst, semiring="log")

        if disambig_syms_h:
            remove_input_symbols(disambig_syms_h, trans2word_fst)

        trans2word_fst = min_fn(trans2word_fst)

        trans2word_fst = add_self_loops(
            self.trans_model,
            trans2word_fst,
            self_loop_scale=self.opts.self_loop_scale,
            disambig_syms=[],
            reorder=self.opts.reorder,
            check_no_self_loops=True,
        )
        return trans2word_fst

    def compile_graphs_from_text(
        self, transcripts: List[List[int]]
    ) -> List[VectorFst]:
        return [self.compile_graph_from_text(t) for t in transcripts]
