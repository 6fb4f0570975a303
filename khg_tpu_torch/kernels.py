"""Build, load and count the hand-written Hopper kernels.

The CUDA C++ sources under ``csrc/`` compile with ``nvcc`` for
``sm_90a`` into ONE shared library with a plain C interface, loaded
with ``ctypes``.  Each source compiles in its own ``nvcc`` process, all
started together, and the objects link into the library.  The build
happens on first use, into ``build/kernels/<hash>/`` at the repository
root (``.gitignore`` lists ``build/``), keyed by a hash of the sources
and flags, so an edited source never loads a stale library.

Every launch function returns ``cudaGetLastError()``; ``check`` turns a
non-zero code into an exception.  ``LAUNCHES`` counts successful
launches per kernel: the wrappers add one where they launch and
nowhere else, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES: Dict[str, int] = {
    "banded_viterbi": 0,
    "fused_loglikes": 0,
    "fbank": 0,
    "banded_fb_fwd": 0,
    "banded_fb_bwd": 0,
    "banded_viterbi_sac": 0,
    "stats_fold": 0,
    "viterbi": 0,
}

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # plane_cost, plane_tid, state_pdf, init, final, loglikes, nf, offsets,
    # bp, tids, total_cost, B, DK, S, T, P, scale, stream
    "launch_banded_viterbi": [_P] * 11 + [_I] * 5 + [_F, _P],
    # x2, model, gconst, out, N, P, K, D2P, bf16, stream
    "launch_fused_loglikes": [_P] * 4 + [_I] * 5 + [_P],
    # wave, table, mel_w, mel_rng, chunk_rng, feats, energy, B, L, T,
    # shift, flen, kp, stride, ncols, nbins, M, remove_dc, use_power,
    # use_log, log_energy_floor, stream
    "launch_fbank": [_P] * 7 + [_I] * 13 + [_F, _P],
    # plane_cost, state_pdf, init, final, loglikes, nf, offsets, alphas,
    # log_z, B, DK, S, T, P, scale, stream
    "launch_banded_fb_fwd": [_P] * 9 + [_I] * 5 + [_F, _P],
    # plane_cost, state_pdf, final, loglikes, nf, offsets, alphas, log_z,
    # spost, apost, B, DK, S, T, P, scale, stream
    "launch_banded_fb_bwd": [_P] * 10 + [_I] * 5 + [_F, _P],
    # pdf_ids, weights, state_pdf, int workspace, ll, frames, B, S, T, P,
    # stream
    "launch_stats_fold_group": [_P] * 6 + [_I] * 4 + [_P],
    # gconsts, miv, iv, feats, pdf_ids, weights, int and float
    # workspaces, B, S, T, P, K, D, stream
    "launch_stats_fold_score": [_P] * 8 + [_I] * 6 + [_P],
    # int and float workspaces, out, ll, frames, B, S, T, P, K, D, stream
    "launch_stats_fold_fold": [_P] * 5 + [_I] * 6 + [_P],
    # in_src, in_pdf, in_cost, in_tid, init, final, loglikes, nf, bp,
    # alpha_ws, tids, total_cost, B, S, M, T, P, scale, stream
    "launch_viterbi": [_P] * 12 + [_I] * 5 + [_F, _P],
    # in, out, iters, stream (a measurement probe, not a path's kernel)
    "launch_latency_probe": [_P, _P, _I, _P],
    # next, out, iters, stream (a dependent global-load chain)
    "launch_latency_chase": [_P, _P, _I, _P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the library;
    returns its path.  Reuses a finished build with the same hash."""
    sources = _sources()
    out_dir = BUILD_ROOT / _digest(sources)
    lib_path = out_dir / "libkhg_kernels.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        logs = {}
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            logs[src.name] = out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    (out_dir / "ptxas.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items())
    )
    build_info.update(
        path=str(lib_path), seconds=time.perf_counter() - t0,
        cached=False, ptxas=logs,
    )
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(name: str, err: int, count: bool = True) -> None:
    """Raise on a non-zero cudaGetLastError() code from a launch;
    count the launch otherwise (``count=False`` for the earlier launches
    of a kernel that takes several: it counts once per call)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    if count:
        LAUNCHES[name] += 1


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
