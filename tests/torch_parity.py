"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The port (khg_tpu_torch) and the reference (khg_tpu) run on identical
inputs: numpy data from fixed seeds, and host objects (models, FSTs,
transition models) carried between the reference's classes and the
port's identical copies by a pickle round trip that renames the modules.
"""

import io
import pickle

import torch

# each xdist worker keeps to two torch threads
torch.set_num_threads(2)


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "khg_tpu" or module.startswith("khg_tpu."):
            module = "khg_tpu_torch" + module[len("khg_tpu"):]
        return super().find_class(module, name)


def port_copy(obj):
    """A deep copy of a reference-package object as the port's class."""
    return _PortUnpickler(io.BytesIO(pickle.dumps(obj))).load()



class _ReferenceUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "khg_tpu_torch" or module.startswith("khg_tpu_torch."):
            module = "khg_tpu" + module[len("khg_tpu_torch"):]
        return super().find_class(module, name)


def reference_copy(obj):
    """A deep copy of a port object as the reference package's class."""
    return _ReferenceUnpickler(io.BytesIO(pickle.dumps(obj))).load()


def build_yesno_like():
    """tests/test_graph_compiler.build_yesno_like on the port's classes:
    (lexiconp, topology, tree, transition model, graph compiler)."""
    from khg_tpu_torch.graph.compiler import (
        TrainingGraphCompiler,
        TrainingGraphCompilerOptions,
    )
    from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
    from khg_tpu_torch.lang.lfst import make_lexicon_fst_with_silence
    from khg_tpu_torch.lang.topo import generate_hmm_topo
    from khg_tpu_torch.model.context_dep import monophone_context_dependency
    from khg_tpu_torch.model.transition_model import TransitionModel

    lexicon = Lexicon(word2phones={"<SIL>": ["SIL"], "YES": ["Y"], "NO": ["N"]})
    lexiconp = Lexiconp.from_lexicon(lexicon)
    lp = lexiconp.add_lex_disambig()
    topo = generate_hmm_topo(
        non_sil_phones=lp.get_non_sil_phone_ids(), sil_phone=lp.get_sil_phone_id(),
    )
    tree = monophone_context_dependency(
        topo.phones, topo.get_phone_to_num_pdf_classes()
    )
    tm = TransitionModel(ctx_dep=tree, hmm_topo=topo)
    lex_fst = make_lexicon_fst_with_silence(
        lexiconp=lexiconp, sil_prob=0.5, sil_phone="SIL"
    )
    gc = TrainingGraphCompiler(
        trans_model=tm, ctx_dep=tree, lex_fst=lex_fst,
        disambig_syms=[lp.phone2id[f"#{i}"] for i in range(lp.max_disambig + 1)],
        opts=TrainingGraphCompilerOptions(),
    )
    return lp, topo, tree, tm, gc
