"""The port's training-graph compiler on the native C++ FST core
(khg_tpu_torch/graph/compiler.py, ``use_native``) against its
pure-Python fstlib compile, arc for arc, and against khg_tpu's compiler
on the same native core.

Tolerance: states, start, arcs (labels, order, destinations) and which
states are final exact; arc and final weights equal once rounded to
f32 (the native core carries weights in f32, the Python fstlib in
f64: they differ by at most half an f32 ulp)."""

import numpy as np
import pytest

from khg_tpu_torch.fstlib import native
from khg_tpu_torch.graph.compiler import (
    TrainingGraphCompiler,
    TrainingGraphCompilerOptions,
)
from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
from khg_tpu_torch.lang.lfst import make_lexicon_fst_with_silence
from khg_tpu_torch.lang.topo import generate_hmm_topo
from khg_tpu_torch.model.context_dep import monophone_context_dependency
from khg_tpu_torch.model.transition_model import TransitionModel
from khg_tpu_torch.recipes.audiomnist import DIGITS, digits_lexicon
from tests.torch_parity import port_copy, reference_copy

YESNO = {"<SIL>": ["SIL"], "YES": ["Y"], "NO": ["N"]}


def _compilers(word2phones):
    lp = Lexiconp.from_lexicon(Lexicon(word2phones=word2phones))
    lpd = lp.add_lex_disambig()
    topo = generate_hmm_topo(non_sil_phones=lpd.get_non_sil_phone_ids(),
                             sil_phone=lpd.get_sil_phone_id())
    tree = monophone_context_dependency(topo.phones,
                                        topo.get_phone_to_num_pdf_classes())
    tm = TransitionModel(ctx_dep=tree, hmm_topo=topo)
    L = make_lexicon_fst_with_silence(lexiconp=lp, sil_prob=0.5, sil_phone="SIL")
    kw = dict(trans_model=tm, ctx_dep=tree, lex_fst=L,
              disambig_syms=lpd.disambig_phone_ids(),
              opts=TrainingGraphCompilerOptions())
    return lpd, {n: TrainingGraphCompiler(**kw, use_native=n) for n in (True, False)}


def _arcs(g):
    return [[(a.ilabel, a.olabel, float(np.float32(a.weight)), a.nextstate)
             for a in g.arcs[s]] for s in range(g.num_states)]


def _finals(g):
    return [float(np.float32(f)) for f in g.final]


def test_native_is_the_default():
    assert native.available(), native.build_error()
    _lp, gcs = _compilers(YESNO)
    assert gcs[True]._native is native and gcs[False]._native is None
    lp = Lexiconp.from_lexicon(Lexicon(word2phones=YESNO))
    gc = TrainingGraphCompiler(gcs[True].trans_model, gcs[True].ctx_dep,
                               make_lexicon_fst_with_silence(lp, 0.5, "SIL"))
    assert gc._native is native


@pytest.mark.parametrize("lexicon,transcripts", [
    (YESNO, [["YES"], ["NO", "YES", "YES"], ["YES", "NO"] * 4]),
    (digits_lexicon(), [["ONE"], ["THREE", "ONE", "FOUR"],
                        [DIGITS[d] for d in (8, 0, 7, 7, 2, 9, 5)]]),
], ids=["yesno", "digits"])
def test_native_compile_equals_python_arc_for_arc(lexicon, transcripts):
    lp, gcs = _compilers(lexicon)
    for words in transcripts:
        ids = [lp.word2id[w] for w in words]
        nat = gcs[True].compile_graph_from_text(ids)
        py = gcs[False].compile_graph_from_text(ids)
        assert (nat.num_states, nat.start) == (py.num_states, py.start)
        assert _arcs(nat) == _arcs(py), words
        assert _finals(nat) == _finals(py), words
        assert sum(len(a) for a in nat.arcs) > 0


def test_native_compile_equals_khg_tpu_s():
    """khg_tpu's compiler, native by default too, gives the same graph."""
    from khg_tpu.graph.compiler import TrainingGraphCompiler as JCompiler

    lp, gcs = _compilers(YESNO)
    gc = gcs[True]
    jgc = JCompiler(
        trans_model=reference_copy(gc.trans_model), ctx_dep=reference_copy(gc.ctx_dep),
        lex_fst=reference_copy(make_lexicon_fst_with_silence(
            Lexiconp.from_lexicon(Lexicon(word2phones=YESNO)), 0.5, "SIL")),
        disambig_syms=gc.disambig_syms,
    )
    assert jgc._native is not None
    ids = [lp.word2id[w] for w in ("NO", "YES", "NO")]
    got = gc.compile_graph_from_text(ids)
    ref = port_copy(jgc.compile_graph_from_text(ids))
    assert _arcs(got) == _arcs(ref) and _finals(got) == _finals(ref)

