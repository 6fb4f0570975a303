"""ctypes bindings to the native (C++) FST core.

Copy of khg_tpu/fstlib/native.py with one change: the library is built
from the repository's ``native/khg_native.cc`` (unchanged, with the same
``g++ -O2 -shared -fPIC -std=c++17`` flags) into
``build/native/<digest of the source>/libkhg_native.so`` at the
repository root (``.gitignore`` lists ``build/``).  The port never
writes or loads the tracked ``native/libkhg_native.so``.  The build
writes a temporary file beside its target and renames it into place, so
processes that build at once each load a whole library.

It exposes lattice decode, shortest path, compose / determinize_star /
minimize_encoded / connect with the same signatures and semantics as the
Python implementations in khg_tpu_torch.fstlib.fst, which are the
reference.  The graph compiler (graph/compiler.py) uses compose,
determinize_star and minimize_encoded whenever the library loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from khg_tpu_torch.fstlib.fst import Arc, VectorFst

logger = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC_PATH = _ROOT / "native" / "khg_native.cc"
BUILD_ROOT = _ROOT / "build" / "native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib = None
# why the library could not be built or loaded (None while it can be)
_lib_error: Optional[str] = None


class _FstBuf(ctypes.Structure):
    _fields_ = [
        ("num_states", ctypes.c_int32),
        ("start", ctypes.c_int32),
        ("finals", ctypes.POINTER(ctypes.c_float)),
        ("num_arcs", ctypes.c_int64),
        ("src", ctypes.POINTER(ctypes.c_int32)),
        ("il", ctypes.POINTER(ctypes.c_int32)),
        ("ol", ctypes.POINTER(ctypes.c_int32)),
        ("w", ctypes.POINTER(ctypes.c_float)),
        ("dst", ctypes.POINTER(ctypes.c_int32)),
    ]


class _LatticeBuf(ctypes.Structure):
    _fields_ = [
        ("num_states", ctypes.c_int32),
        ("start", ctypes.c_int32),
        ("num_arcs", ctypes.c_int64),
        ("src", ctypes.POINTER(ctypes.c_int32)),
        ("il", ctypes.POINTER(ctypes.c_int32)),
        ("ol", ctypes.POINTER(ctypes.c_int32)),
        ("gc", ctypes.POINTER(ctypes.c_double)),
        ("ac", ctypes.POINTER(ctypes.c_double)),
        ("dst", ctypes.POINTER(ctypes.c_int32)),
        ("key_t", ctypes.POINTER(ctypes.c_int32)),
        ("key_s", ctypes.POINTER(ctypes.c_int32)),
        ("num_finals", ctypes.c_int32),
        ("final_state", ctypes.POINTER(ctypes.c_int32)),
        ("final_w", ctypes.POINTER(ctypes.c_double)),
        ("partial", ctypes.c_int32),
        ("max_live_links", ctypes.c_int64),
    ]


class _PathBuf(ctypes.Structure):
    _fields_ = [
        ("found", ctypes.c_int32),
        ("n_il", ctypes.c_int32),
        ("n_ol", ctypes.c_int32),
        ("il", ctypes.POINTER(ctypes.c_int32)),
        ("ol", ctypes.POINTER(ctypes.c_int32)),
        ("cost", ctypes.c_double),
    ]


def library_path() -> Path:
    """Where the library built from the current source lies."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC_PATH.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libkhg_native.so"


def _build(so_path: Path) -> None:
    """Compile the source into ``so_path`` by way of a temporary file."""
    so_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(so_path.parent), suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, str(_SRC_PATH), "-o", tmp],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None if it cannot be
    built or loaded; ``build_error()`` then says why."""
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        return None
    try:
        so_path = library_path()
        if not so_path.exists():
            _build(so_path)
        lib = ctypes.CDLL(str(so_path))
    except subprocess.CalledProcessError as e:
        _lib_error = f"g++ failed: {e.stderr.strip()[-2000:]}"
    except OSError as e:  # no g++, no source, or a library that will not load
        _lib_error = f"native build or load failed: {e}"
    if _lib_error is not None:
        logger.warning("%s", _lib_error)
        return None
    lib.khg_compose.argtypes = [
        ctypes.POINTER(_FstBuf), ctypes.POINTER(_FstBuf), ctypes.POINTER(_FstBuf)
    ]
    lib.khg_compose.restype = ctypes.c_int
    lib.khg_determinize_star.argtypes = [
        ctypes.POINTER(_FstBuf), ctypes.c_int, ctypes.POINTER(_FstBuf)
    ]
    lib.khg_determinize_star.restype = ctypes.c_int
    lib.khg_minimize_encoded.argtypes = [
        ctypes.POINTER(_FstBuf), ctypes.POINTER(_FstBuf)
    ]
    lib.khg_minimize_encoded.restype = ctypes.c_int
    lib.khg_connect.argtypes = [ctypes.POINTER(_FstBuf), ctypes.POINTER(_FstBuf)]
    lib.khg_connect.restype = ctypes.c_int
    lib.khg_free_fst.argtypes = [ctypes.POINTER(_FstBuf)]
    lib.khg_free_fst.restype = None
    lib.khg_lattice_decode.argtypes = [
        ctypes.c_int32,                         # num_states
        ctypes.c_int32,                         # start
        ctypes.POINTER(ctypes.c_double),        # finals
        ctypes.POINTER(ctypes.c_int64),         # arc_offsets (CSR)
        ctypes.POINTER(ctypes.c_int32),         # ilabels
        ctypes.POINTER(ctypes.c_int32),         # olabels
        ctypes.POINTER(ctypes.c_double),        # weights
        ctypes.POINTER(ctypes.c_int32),         # dests
        ctypes.POINTER(ctypes.c_float),         # loglikes (T, P)
        ctypes.c_int32,                         # T
        ctypes.c_int32,                         # P
        ctypes.POINTER(ctypes.c_int32),         # id2pdf
        ctypes.c_double,                        # acoustic_scale
        ctypes.c_double,                        # beam
        ctypes.c_int32,                         # max_active
        ctypes.c_int32,                         # min_active
        ctypes.c_double,                        # lattice_beam
        ctypes.c_int32,                         # prune_interval
        ctypes.c_int32,                         # allow_partial
        ctypes.POINTER(_LatticeBuf),
    ]
    lib.khg_lattice_decode.restype = ctypes.c_int
    lib.khg_free_lattice.argtypes = [ctypes.POINTER(_LatticeBuf)]
    lib.khg_free_lattice.restype = None
    lib.khg_shortest_path.argtypes = [
        ctypes.c_int32,                         # num_states
        ctypes.c_int32,                         # start
        ctypes.POINTER(ctypes.c_double),        # finals
        ctypes.c_int64,                         # num_arcs
        ctypes.POINTER(ctypes.c_int32),         # src
        ctypes.POINTER(ctypes.c_int32),         # ilabels
        ctypes.POINTER(ctypes.c_int32),         # olabels
        ctypes.POINTER(ctypes.c_double),        # weights
        ctypes.POINTER(ctypes.c_int32),         # dests
        ctypes.POINTER(_PathBuf),
    ]
    lib.khg_shortest_path.restype = ctypes.c_int
    lib.khg_free_path.argtypes = [ctypes.POINTER(_PathBuf)]
    lib.khg_free_path.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable, or None."""
    get_lib()
    return _lib_error


def _to_buf(fst: VectorFst, keep):
    """VectorFst -> _FstBuf (numpy arrays kept alive via ``keep``)."""
    n = fst.num_states
    finals = np.array(
        [f if f != float("inf") else np.float32(np.inf) for f in fst.final],
        dtype=np.float32,
    ) if n else np.zeros(0, dtype=np.float32)
    src, il, ol, w, dst = [], [], [], [], []
    for s in range(n):
        for a in fst.arcs[s]:
            src.append(s)
            il.append(a.ilabel)
            ol.append(a.olabel)
            w.append(a.weight)
            dst.append(a.nextstate)
    src = np.asarray(src, dtype=np.int32)
    il = np.asarray(il, dtype=np.int32)
    ol = np.asarray(ol, dtype=np.int32)
    w = np.asarray(w, dtype=np.float32)
    dst = np.asarray(dst, dtype=np.int32)
    keep.extend([finals, src, il, ol, w, dst])
    buf = _FstBuf()
    buf.num_states = n
    buf.start = fst.start
    buf.finals = finals.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    buf.num_arcs = len(src)
    buf.src = src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    buf.il = il.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    buf.ol = ol.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    buf.w = w.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    buf.dst = dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    return buf


def _from_buf(lib, buf: _FstBuf) -> VectorFst:
    fst = VectorFst()
    n = buf.num_states
    for _ in range(n):
        fst.add_state()
    fst.start = buf.start
    if n:
        finals = np.ctypeslib.as_array(buf.finals, shape=(n,))
        for s in range(n):
            f = float(finals[s])
            fst.final[s] = f if np.isfinite(f) else float("inf")
    na = buf.num_arcs
    if na:
        src = np.ctypeslib.as_array(buf.src, shape=(na,))
        il = np.ctypeslib.as_array(buf.il, shape=(na,))
        ol = np.ctypeslib.as_array(buf.ol, shape=(na,))
        w = np.ctypeslib.as_array(buf.w, shape=(na,))
        dst = np.ctypeslib.as_array(buf.dst, shape=(na,))
        for i in range(na):
            fst.add_arc(
                int(src[i]),
                Arc(int(il[i]), int(ol[i]), float(w[i]), int(dst[i])),
            )
    lib.khg_free_fst(ctypes.byref(buf))
    return fst


def compose(a: VectorFst, b: VectorFst) -> VectorFst:
    lib = get_lib()
    keep = []
    ba, bb = _to_buf(a, keep), _to_buf(b, keep)
    out = _FstBuf()
    rc = lib.khg_compose(ctypes.byref(ba), ctypes.byref(bb), ctypes.byref(out))
    assert rc == 0
    return _from_buf(lib, out)


def determinize_star(fst: VectorFst, semiring: str = "tropical") -> VectorFst:
    lib = get_lib()
    keep = []
    buf = _to_buf(fst, keep)
    out = _FstBuf()
    rc = lib.khg_determinize_star(
        ctypes.byref(buf), 1 if semiring == "log" else 0, ctypes.byref(out)
    )
    if rc != 0:
        raise RuntimeError("native determinize_star failed")
    return _from_buf(lib, out)


def minimize_encoded(fst: VectorFst) -> VectorFst:
    lib = get_lib()
    keep = []
    buf = _to_buf(fst, keep)
    out = _FstBuf()
    rc = lib.khg_minimize_encoded(ctypes.byref(buf), ctypes.byref(out))
    assert rc == 0
    return _from_buf(lib, out)


def connect(fst: VectorFst) -> VectorFst:
    lib = get_lib()
    keep = []
    buf = _to_buf(fst, keep)
    out = _FstBuf()
    rc = lib.khg_connect(ctypes.byref(buf), ctypes.byref(out))
    assert rc == 0
    return _from_buf(lib, out)
