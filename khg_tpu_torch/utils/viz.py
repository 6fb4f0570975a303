"""Graphviz DOT rendering for topologies, decision trees, and FSTs.

Emits DOT source strings (no graphviz dependency needed to generate;
render with any dot tool).  Equivalents of the reference's TreeRenderer
(kaldi-hmm-gmm/csrc/tree-renderer.cc) and
hmm_topo_utils.draw_hmm_topology
(python/kaldi_hmm_gmm/hmm_topo_utils.py:4-65).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from khg_tpu_torch.fstlib.fst import VectorFst
from khg_tpu_torch.model.context_dep import ContextDependency
from khg_tpu_torch.model.event_map import (
    ConstantEventMap,
    EventMap,
    K_PDF_CLASS,
    SplitEventMap,
    TableEventMap,
)
from khg_tpu_torch.model.topology import HmmTopology, K_NO_PDF


def draw_hmm_topology(topo: HmmTopology, phone: int) -> str:
    """DOT digraph of one phone's HMM prototype."""
    entry = topo.topology_for_phone(phone)
    lines = [
        "digraph topology {",
        "  rankdir = LR;",
        '  node [shape="circle"];',
    ]
    for i, st in enumerate(entry):
        label = f"{i}"
        if st.forward_pdf_class != K_NO_PDF:
            if st.forward_pdf_class == st.self_loop_pdf_class:
                label += f"\\npdf={st.forward_pdf_class}"
            else:
                label += (
                    f"\\nfwd={st.forward_pdf_class}"
                    f"\\nself={st.self_loop_pdf_class}"
                )
        shape = "doublecircle" if i == len(entry) - 1 else "circle"
        lines.append(f'  {i} [label="{label}", shape="{shape}"];')
    for i, st in enumerate(entry):
        for dst, prob in st.transitions:
            lines.append(f'  {i} -> {dst} [label="{prob:g}"];')
    lines.append("}")
    return "\n".join(lines)


def _key_name(key: int, phone_syms: Optional[Dict[int, str]]) -> str:
    if key == K_PDF_CLASS:
        return "pdf-class"
    return f"ctx[{key}]"


def _value_name(key: int, value: int, phone_syms: Optional[Dict[int, str]]) -> str:
    if key != K_PDF_CLASS and phone_syms and value in phone_syms:
        return phone_syms[value]
    return str(value)


def draw_tree(
    tree: ContextDependency,
    phone_syms: Optional[Dict[int, str]] = None,
    query: Optional[Dict[int, int]] = None,
) -> str:
    """DOT digraph of the decision tree (leaves are pdf-ids).

    ``query`` optionally highlights one lookup's path in red — the
    equivalent of the reference TreeRenderer's query mode
    (tree-renderer.h:20-58, "-query" in draw-tree): a mapping from
    event key (K_PDF_CLASS or context position) to value, e.g.
    ``{0: phone_id, K_PDF_CLASS: 1}`` for a monophone tree.  Nodes and
    edges on the decision path are drawn bold red; the answering leaf
    is filled red.
    """
    lines = ["digraph tree {", '  node [shape="box"];']
    counter = [0]
    HL = ' color="red", penwidth=2.0'

    def node_id() -> str:
        counter[0] += 1
        return f"n{counter[0]}"

    def render(m: EventMap, on_path: bool) -> str:
        nid = node_id()
        hl_node = "," + HL if on_path else ""
        if isinstance(m, ConstantEventMap):
            fill = "indianred1" if on_path else "lightgray"
            lines.append(
                f'  {nid} [label="pdf {m.answer}", shape="ellipse", '
                f'style="filled", fillcolor="{fill}"{hl_node}];'
            )
        elif isinstance(m, TableEventMap):
            lines.append(
                f'  {nid} [label="{_key_name(m.key, phone_syms)}?"'
                f'{hl_node}];'
            )
            qv = query.get(m.key) if (on_path and query) else None
            for value, child in enumerate(m.table):
                if child is None:
                    continue
                taken = qv is not None and value == qv
                cid = render(child, taken)
                hl_edge = "," + HL if taken else ""
                lines.append(
                    f'  {nid} -> {cid} '
                    f'[label="{_value_name(m.key, value, phone_syms)}"'
                    f'{hl_edge}];'
                )
        elif isinstance(m, SplitEventMap):
            values = " ".join(
                _value_name(m.key, v, phone_syms) for v in sorted(m.yes_set)
            )
            lines.append(
                f'  {nid} [label="{_key_name(m.key, phone_syms)} in '
                f'{{{values}}}?"{hl_node}];'
            )
            qv = query.get(m.key) if (on_path and query) else None
            take_yes = qv is not None and qv in m.yes_set
            take_no = qv is not None and qv not in m.yes_set
            yid = render(m.yes, take_yes)
            nid2 = render(m.no, take_no)
            lines.append(
                f'  {nid} -> {yid} [label="yes"'
                f'{"," + HL if take_yes else ""}];'
            )
            lines.append(
                f'  {nid} -> {nid2} [label="no"'
                f'{"," + HL if take_no else ""}];'
            )
        else:
            raise TypeError(type(m))
        return nid

    render(tree.to_pdf, query is not None)
    lines.append("}")
    return "\n".join(lines)


def draw_fst(
    fst: VectorFst,
    isymbols: Optional[Dict[int, str]] = None,
    osymbols: Optional[Dict[int, str]] = None,
    acceptor: bool = False,
) -> str:
    """DOT digraph of an FST (OpenFST draw-style)."""

    def sym(table, label):
        if table and label in table:
            return table[label]
        return "<eps>" if label == 0 else str(label)

    lines = ["digraph FST {", "  rankdir = LR;", '  node [shape="circle"];']
    for s in range(fst.num_states):
        if fst.is_final(s):
            lines.append(
                f'  {s} [shape="doublecircle", label="{s}/{fst.final[s]:g}"];'
            )
        else:
            lines.append(f'  {s} [label="{s}"];')
    for s in range(fst.num_states):
        for a in fst.arcs[s]:
            if acceptor:
                lab = f"{sym(isymbols, a.ilabel)}/{a.weight:g}"
            else:
                lab = (
                    f"{sym(isymbols, a.ilabel)}:{sym(osymbols, a.olabel)}"
                    f"/{a.weight:g}"
                )
            lines.append(f'  {s} -> {a.nextstate} [label="{lab}"];')
    lines.append("}")
    return "\n".join(lines)
