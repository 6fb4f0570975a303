"""Lattice decoding in the port (khg_tpu_torch/decode/lattice.py and the
native core through khg_tpu_torch/fstlib/native.py) against khg_tpu on
the same f32 loglikes, on both backends; the reference decoder's goldens
(tests/golden/lattice_{problem,golden}.txt); native == python and
parallel == serial inside the port; and where the port's native library
is built: under build/native/, never the tracked native/libkhg_native.so.
"""

import math
import subprocess

import pytest

from khg_tpu.decode.lattice import LatticeFasterDecoder as JLatticeFasterDecoder
from khg_tpu.decode.lattice import (
    LatticeFasterDecoderConfig as JLatticeFasterDecoderConfig,
)
from khg_tpu.gmm.likelihoods import loglikes_np as j_loglikes_np
from khg_tpu_torch.decode.lattice import (
    LatticeFasterDecoder,
    LatticeFasterDecoderConfig,
    LatticeSimpleDecoder,
    decode_utterance_lattice_faster,
    decode_utterances_parallel,
)
from khg_tpu_torch.fstlib import native
from tests.test_decode import trained_and_graph  # noqa: F401
from tests.test_reference_parity import _parse_lattice_golden, _parse_lattice_problem
from tests.torch_parity import port_copy

CONFIGS = [
    dict(),
    dict(beam=8.0, lattice_beam=4.0),
    dict(beam=100.0, lattice_beam=8.0, prune_interval=5),
    dict(beam=16.0, max_active=20, min_active=5, lattice_beam=6.0,
         prune_interval=3),
    dict(beam=40.0, lattice_beam=6.0),
]


def _lls(trained_and_graph, n=4):
    _lp, corpus, result, _hclg = trained_and_graph
    packed = result.am.pack()
    return [j_loglikes_np(packed, f) for f in corpus.feats[:n]]


def lattice_signature(lat):
    """A lattice's states, keys, finals and arcs in order (exact)."""
    fst = lat.fst
    return (
        fst.num_states, fst.start, lat.state_keys, list(fst.final),
        [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
         for arcs in fst.arcs],
        lat.acoustic_costs,
    )


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=[str(i) for i in range(len(CONFIGS))])
def test_lattice_decoder_matches_jax(trained_and_graph, backend, cfg):
    """Best path (tids, words, cost) bitwise and the same lattice size
    as khg_tpu's decoder on the same backend."""
    _lp, _corpus, result, hclg = trained_and_graph
    id2pdf = result.transition_model.id2pdf_array()
    port = LatticeFasterDecoder(port_copy(hclg), LatticeFasterDecoderConfig(**cfg),
                                backend=backend)
    ref = JLatticeFasterDecoder(hclg, JLatticeFasterDecoderConfig(**cfg),
                                backend=backend)
    for ll in _lls(trained_and_graph):
        got = port.decode(ll, id2pdf, acoustic_scale=2.0)
        want = ref.decode(ll, id2pdf, acoustic_scale=2.0)
        assert got is not None and want is not None
        assert got.best_path() == want.best_path()
        assert (got.fst.num_states, got.fst.num_arcs) == (
            want.fst.num_states, want.fst.num_arcs)
        assert port.last_max_live_links == ref.last_max_live_links


@pytest.mark.parametrize("backend", ["python", "native"])
def test_lattice_goldens(backend):
    """The reference LatticeFasterDecoderTpl's best paths on the golden
    problems, through the port's decoder: words, every tid, and the
    cost within 1e-4 (as khg_tpu's test_reference_parity holds its own)."""
    scale, id2pdf, utts = _parse_lattice_problem()
    golden = _parse_lattice_golden()
    assert len(golden) == len(utts)
    for i, (g, ll, beam, max_active, lattice_beam, prune_interval) in enumerate(utts):
        decoder = LatticeFasterDecoder(
            port_copy(g),
            LatticeFasterDecoderConfig(
                beam=beam, max_active=max_active, min_active=0,
                lattice_beam=lattice_beam, prune_interval=prune_interval,
            ),
            backend=backend,
        )
        ok, tids, words, like = decode_utterance_lattice_faster(
            decoder, ll, id2pdf, acoustic_scale=scale
        )
        gold_cost, gold_tids, gold_words = golden[i]
        assert ok, i
        assert words == gold_words, i
        assert tids == gold_tids, i
        assert math.isclose(-like, gold_cost, rel_tol=1e-4), (i, -like, gold_cost)


@pytest.mark.parametrize("cfg", CONFIGS + [
    dict(beam=200.0, lattice_beam=200.0),
    dict(beam=100.0, max_active=0, min_active=0, lattice_beam=8.0),
], ids=[str(i) for i in range(len(CONFIGS) + 2)])
def test_native_matches_python(trained_and_graph, cfg):
    """Inside the port, the native core reproduces the Python decoder
    exactly: states, keys, arcs, costs, finals, max live links."""
    _lp, _corpus, result, hclg = trained_and_graph
    id2pdf = result.transition_model.id2pdf_array()
    g = port_copy(hclg)
    dn = LatticeFasterDecoder(g, LatticeFasterDecoderConfig(**cfg), backend="native")
    dp = LatticeFasterDecoder(g, LatticeFasterDecoderConfig(**cfg), backend="python")
    for ll in _lls(trained_and_graph, 3):
        ln = dn.decode(ll, id2pdf, acoustic_scale=2.0)
        lpy = dp.decode(ll, id2pdf, acoustic_scale=2.0)
        assert lattice_signature(ln) == lattice_signature(lpy)
        assert dn.last_max_live_links == dp.last_max_live_links
        assert ln.best_path() == lpy.best_path()


def test_simple_decoder_matches_jax(trained_and_graph):
    from khg_tpu.decode.lattice import LatticeSimpleDecoder as JLatticeSimpleDecoder

    _lp, _corpus, result, hclg = trained_and_graph
    id2pdf = result.transition_model.id2pdf_array()
    port = LatticeSimpleDecoder(port_copy(hclg), backend="native")
    ref = JLatticeSimpleDecoder(hclg, backend="python")
    for ll in _lls(trained_and_graph, 2):
        got = port.decode(ll, id2pdf, acoustic_scale=2.0)
        want = ref.decode(ll, id2pdf, acoustic_scale=2.0)
        assert lattice_signature(got) == lattice_signature(want)


def test_parallel_decode_matches_serial(trained_and_graph):
    """Thread-parallel decoding returns exactly the serial results, in
    input order (the native core releases the GIL)."""
    _lp, corpus, result, hclg = trained_and_graph
    id2pdf = result.transition_model.id2pdf_array()
    lls = _lls(trained_and_graph, len(corpus.feats))
    d = LatticeFasterDecoder(
        port_copy(hclg), LatticeFasterDecoderConfig(beam=100.0, lattice_beam=8.0),
        backend="native",
    )
    par = decode_utterances_parallel(d, lls, id2pdf, acoustic_scale=2.0, max_workers=4)
    ser = [decode_utterance_lattice_faster(d, ll, id2pdf, acoustic_scale=2.0)
           for ll in lls]
    assert par == ser


def test_native_library_lives_under_build(trained_and_graph, tmp_path, monkeypatch):
    """The port builds native/khg_native.cc into build/native/<digest>/
    and never writes or loads the tracked native/libkhg_native.so: a
    build into a fresh root goes through a temporary file, renamed into
    place, and decoding leaves the tracked library's mtime as it was."""
    root = native._ROOT
    tracked = root / "native" / "libkhg_native.so"
    path = native.library_path()
    assert path.parent.parent == root / "build" / "native"
    assert path.name == "libkhg_native.so" and path != tracked
    before = tracked.stat().st_mtime_ns if tracked.exists() else None

    calls = []
    real_run = subprocess.run

    def spy(cmd, *a, **kw):
        calls.append(list(map(str, cmd)))
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", None)
    monkeypatch.setattr(native.subprocess, "run", spy)
    fresh = native.library_path()
    assert native.get_lib() is not None
    assert fresh.exists() and fresh.parent.parent == tmp_path / "native"
    assert len(calls) == 1 and calls[0][0] == "g++"
    out = calls[0][calls[0].index("-o") + 1]
    assert out.startswith(str(fresh.parent)) and out != str(fresh)
    assert not any(str(tracked) == c for c in calls[0])
    assert list(fresh.parent.iterdir()) == [fresh]

    _lp, _corpus, result, hclg = trained_and_graph
    d = LatticeFasterDecoder(port_copy(hclg), backend="native")
    assert d.decode(_lls(trained_and_graph, 1)[0],
                    result.transition_model.id2pdf_array()) is not None
    after = tracked.stat().st_mtime_ns if tracked.exists() else None
    assert after == before


def test_native_backend_raises_when_the_build_fails(trained_and_graph, monkeypatch,
                                                    tmp_path):
    """backend="native" raises with g++'s reason instead of decoding in
    Python; "auto" falls back to Python."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ["-include", "khg_no_such_header.h"])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", None)
    _lp, _corpus, result, hclg = trained_and_graph
    ll = _lls(trained_and_graph, 1)[0]
    id2pdf = result.transition_model.id2pdf_array()
    g = port_copy(hclg)
    with pytest.raises(RuntimeError, match="native core unavailable: g\\+\\+ failed"):
        LatticeFasterDecoder(g, backend="native").decode(ll, id2pdf)
    auto = LatticeFasterDecoder(g, backend="auto")
    assert not auto._use_native()
    assert auto.decode(ll, id2pdf) is not None
    assert not list((tmp_path / "native").rglob("*.so*"))
