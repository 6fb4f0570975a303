#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (khg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Toolchain: torch, CUDA, nvcc, g++ (for the native decoder) and the
   card's name and power limit.
2. Build: the hand-written kernels from khg_tpu_torch/csrc with nvcc
   for sm_90a (one nvcc per source, in parallel), and the native
   decoder core from native/khg_native.cc with g++.
3. Corpus and kernel checks: synthesise 1,024 spoken-digit WAVs and
   build the triphone-bench system (682 single-phone words + SIL, 2,051
   pdfs of 32 Gaussians over 80-dim features), then hold each kernel
   against its plain PyTorch version at main-path shapes, and time
   kernel, plain version and (where one exists) the library call
   computing the same function.  Each kernel's bound is worked out from
   this run's inputs; for the Viterbi kernels and banded
   forward-backward it includes the serial frame chain, whose step
   latencies csrc/latency_probe.cu times on the card.  The fbank kernel
   is also held to its plain version at 48 kHz, and its SASS must hold
   TF32 tensor-core instructions.
4. Main path: WAV -> extract_features (fbank kernel) -> train_corpus at
   the audiomnist_10k widths (1,000 Gaussians, batch 256, 256-multiple
   padding), depth cut to 6 passes.  Launch counts are set to 0 just
   before and read just after.
5. The fused-loglikes backend: 2 resident passes with
   likelihood_backend="pallas" against the same passes with "xla";
   then 2 passes with align_backend="xla", every batch through the
   non-banded Viterbi kernel.
6. Soft EM: from phase 4's model, 2 resident Baum-Welch passes
   (fb_em_passes_resident) through the banded forward-backward
   kernels, run twice (are the records bit-identical?  the rerun times
   each launch of kernels D and E with CUDA events), then with the
   dense FB (align_backend="xla"); then pass 2 of both routes again from
   one state (the banded route's model and transition model after one
   pass); then one accumulate_forward_backward pass.  Launch counts are
   set to 0 just before the first run and read just after.
7. Wide hard EM at the triphone-bench widths: 512 utterances of 300
   standard-normal 80-dim frames over 16 distinct 3-word graphs (8
   batches of 64), 3 resident passes with align_backend="banded", run
   twice: per-state scoring, the banded kernel on that lattice and the
   stats fold kernel (the rerun times each launch of both); then the
   same passes through the narrow route (full-P fused loglikes, the
   banded kernel on (B, T, P), the P-wide fold), which must agree.
8. Stage 3 of the corpus recipe from phase 4's model: 256 new held-out
   WAVs (their own seed, digit sequences outside the training corpus)
   -> fbank -> the unigram digit HCLG -> score_held_out (kernel B, one
   launch per 128-frame bucket) -> decode_held_out (native lattice
   decoder, threaded, streamed f32 fetch) -> WER, which must be at most
   5%; decode_dense (kernel G, generic route) on the first 16.  Launch
   counts are set to 0 just before and read just after.  Scores from
   B's plain version on the card and a float16 fetch must decode to
   identical words; decode_dense must give the lattice decoder's words
   and cost (1e-3 relative); G at the HCLG's shape is held to its plain
   version and timed.
9. The yesno recipe (egs/yesno_wav/run.py's defaults) through the port's
   runner khg_tpu_torch.egs.yesno_wav, in this process: 60 synthesized
   WAVs -> fbank (kernel C) -> train_yesno, 30 passes with Viterbi
   realignment (kernel G) and mix-up to 300 Gaussians on the 30
   training WAVs -> the test half scored by kernel B and decoded over
   the yes/no HCLG -> WER, which must be at most 25%; then again with
   --speed-perturb (90 training utterances).  Launch counts are set to
   0 just before and read just after the two runs; the log-likelihood
   must rise and no alignment may fail.  Then kernel C on the
   speed-perturbed waves (non-integer samples: the sixth product) and
   MFCC + deltas on C are held to C's plain version, B's scores to its
   plain version, and one realignment batch on G to G's plain version.
10. CTC (BASELINE config #4): the port's runner khg_tpu_torch.egs.ctc_synth
   at tests/test_ctc_train.py's arguments (24/6 utterances, 8 passes;
   kernel G aligns, kernel B scores the test set), whose WER must be
   0.00%, and again from stage 2, which must reproduce it; then
   train_ctc_gmm at full width on phase 4's 1,024 fbank utterances (the
   letter-phones of each utterance's digit words as tokens, blank 0),
   8 passes with mix-up toward 1,000 Gaussians at pass 4, all
   utterances in one batch: the average log-likelihood may not fall by
   more than 1e-3 a pass and must rise overall, no alignment may fail
   after pass 0, and G on the last pass's batch must give its plain
   version's costs to the bit.
11. Data-parallel EM (parallel/mesh.py) on phase 4's corpus and model at
   the audiomnist_10k widths: (a) world size 1 on NCCL in this process,
   the sharded resident loop (2 passes, kernels A and G) held to
   em_passes_resident within 1e-5, the sharded Baum-Welch loop (1 pass,
   D and E) to fb_em_passes_resident at phase 6's 1e-4 per frame, and
   the per-state step (A-sac, F) on phase 7's first wide batch to the
   pipeline's; (b) two ranks on the one card, spawned with
   torch.multiprocessing and joined before the phase ends, on gloo (NCCL
   refuses two ranks on one GPU), each folding half of the batches:
   packets and model within 1e-5 of (a)'s, the model bit-identical on
   both ranks; (c) weak_scaling_curve at world size 1 (G).  Launch
   counts are read around each sharded call alone (reference runs
   outside), and every kernel of a path must have launched in it.
12. Parity leftovers (parity_leftovers) on phase 4's corpus and model:
   dither with a CUDA generator (fbank, and MFCC on kernel C)
   reproducible, bit-equal to the undithered path on the same noise,
   its moments within 5 sigma; careful alignment of the first 64
   utterances through kernel G (launches counted around that call
   alone), equal to the plain graphs' alignments, and G bit-equal to
   its plain version on the careful batch; bf16 per-state scores
   within their rounding bound of f32; the local stats fold on
   precomputed state scores bit-equal to the fold that scores itself.
   Its wall time is printed beside the card's nvidia-smi line.

Prints a ``{"kernels": [...]}`` line, the card's nvidia-smi line, and as
its last line ``{"ok": true, "device": {...}}``.  It needs one card and
no network; it writes only to a temporary directory and the
repository's build/ directory, and starts no process that outlives it
(phase 11's two ranks are joined, or killed, before it ends).
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

NUM_UTTS = 1024
SEED = 11
DEVICE = "cuda"
# stop after the kernel checks (a quick first run of new kernels)
KERNELS_ONLY = False
# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over memory rate and
    operations over the type's peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def banded_shape(tables, offsets, loglikes, num_frames, *rest):
    """(B, DK, S, T, num_frames) of a banded kernel wrapper's call."""
    return (*tables.plane_cost.shape, loglikes.shape[1], num_frames)


@contextlib.contextmanager
def event_timed(module, names, calls, describe=banded_shape):
    """While inside, each call of ``module.<name>`` is bracketed by CUDA
    events: calls[name] collects (start, end, describe(*args)).
    Nothing is synchronised; read the events after."""
    import torch

    saved = {n: getattr(module, n) for n in names}

    def timed(name, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            calls.setdefault(name, []).append((start, end, describe(*args)))
            return out
        return call

    for n, fn in saved.items():
        setattr(module, n, timed(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def device_trace_ms(fn, reps: int):
    """{kernel or copy, as the trace names it: mean device ms per call
    of fn} over reps calls, from a torch.profiler trace (CUPTI); {}
    where the trace shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us:
            out[e.key] = out.get(e.key, 0.0) + us / reps / 1e3
    return out


def kernel_device_ms(fn, reps: int, prefix: str):
    """{kernel: mean device ms per call of fn} over reps calls, for the
    kernels whose name holds ``prefix`` (device_trace_ms)."""
    out = {}
    for key, ms in device_trace_ms(fn, reps).items():
        found = re.search(r"\b(" + prefix + r"\w*)", key)
        if found:
            out[found.group(1)] = out.get(found.group(1), 0.0) + ms
    return out


_LATENCIES = {}


def step_latencies(iters: int = 100_000):
    """Dependent-step latencies on this card in ns, timed once by
    csrc/latency_probe.cu: the frame exchange step, one fp32 operation,
    a shared-memory read, a precise expf, a precise logf (+ add), and a
    global load from L2 and from device memory."""
    import torch

    from khg_tpu_torch import kernels

    if _LATENCIES:
        return _LATENCIES
    inp = torch.rand(512, device="cuda") * 1e-3
    out = torch.zeros(6, dtype=torch.int64, device="cuda")
    stream = kernels.stream_handle(inp.device)
    for n in (1000, iters):  # the first call warms up
        err = kernels.lib().launch_latency_probe(
            inp.data_ptr(), out.data_ptr(), n, stream
        )
        if err != 0:
            raise RuntimeError(f"latency probe failed to launch: error {err}")
    torch.cuda.synchronize()
    v = [x / iters for x in out.tolist()]
    _LATENCIES.update(step=v[0], op=v[1] / 2, read=v[2], exp=v[4], log=v[5],
                      l2=chase_ns(1 << 15), hbm=chase_ns(1 << 23))
    return _LATENCIES


def chase_ns(lines: int, iters: int = 20_000) -> float:
    """ns per dependent global load (csrc/latency_probe.cu's chase) over
    a random cycle through ``lines`` 128-byte lines: 4 MB stays in L2,
    1 GB is spread over device memory."""
    import torch

    from khg_tpu_torch import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    heads = torch.randperm(lines, device="cuda", generator=gen) * 32
    nxt = torch.zeros(lines * 32, dtype=torch.int32, device="cuda")
    nxt[heads] = torch.roll(heads, -1).to(torch.int32)
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = kernels.stream_handle(nxt.device)
    for n in (iters // 10, iters):  # the first call warms up
        err = kernels.lib().launch_latency_chase(nxt.data_ptr(), out.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"latency chase failed to launch: error {err}")
    torch.cuda.synchronize()
    return out[0].item() / iters


def serial_bound(max_frames: int, DK: int, S: int):
    """(ms, derivation): the least time of banded Viterbi's serial chain.

    Frame t+1 needs every alpha of frame t, so whatever the design, the
    longest utterance runs ``max_frames`` frames one after another.  A
    frame is at least: one exchange step (read a neighbour's alpha from
    shared memory, add the plane cost, min, write, block barrier), the
    rest of a min tree over the DK candidates (ceil(log2 DK) levels) and
    the acoustic subtraction, one dependent fp32 operation each.  Then
    the final argmin over S states (ceil(log2 S) exchange steps) and a
    backtrace of one dependent shared-memory read per frame.  The step
    times are measured on this card by csrc/latency_probe.cu."""
    lat = step_latencies()
    step_ns, op_ns, read_ns = lat["step"], lat["op"], lat["read"]
    levels = math.ceil(math.log2(max(DK, 1)))
    frame_ns = step_ns + (levels + 1) * op_ns
    total_ns = (max_frames * (frame_ns + read_ns)
                + math.ceil(math.log2(S)) * step_ns)
    chain = (f"{max_frames} frames x ({step_ns:.2f} ns step + {levels + 1} "
             f"x {op_ns:.2f} ns op + {read_ns:.2f} ns backtrace read) + "
             f"{math.ceil(math.log2(S))} x {step_ns:.2f} ns argmin")
    return total_ns * 1e-6, chain


def fb_serial_bound(max_frames: int, DK: int, S: int, log_z: bool):
    """(ms, derivation): the least time of one banded forward-backward
    pass's serial chain.  As for Viterbi, the longest utterance runs
    ``max_frames`` dependent frames, whatever the design.  A frame is at
    least one exchange step, a max tree over the DK candidates
    (ceil(log2 DK) levels), one expf (the DK of them in parallel), a
    sum tree of the same depth, one logf with the add of the maximum,
    and the add of the acoustic term.  The forward pass ends with log Z:
    a max and a sum over S states (2 ceil(log2 S) exchange steps), one
    expf and one logf."""
    lat = step_latencies()
    levels = math.ceil(math.log2(max(DK, 1)))
    frame_ns = (lat["step"] + 2 * levels * lat["op"] + lat["exp"]
                + lat["log"] + lat["op"])
    total_ns = max_frames * frame_ns
    chain = (f"{max_frames} frames x ({lat['step']:.2f} ns step + "
             f"{2 * levels + 1} x {lat['op']:.2f} ns op + {lat['exp']:.2f} ns "
             f"expf + {lat['log']:.2f} ns logf)")
    if log_z:
        rlev = math.ceil(math.log2(S))
        total_ns += 2 * rlev * lat["step"] + lat["exp"] + lat["log"]
        chain += f" + {2 * rlev} x {lat['step']:.2f} ns log-Z steps + expf + logf"
    return total_ns * 1e-6, chain


# ----------------------------------------------------------------- phase 1-2

def phase_toolchain():
    import torch

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout
    release = [ln for ln in ver.splitlines() if "release" in ln]
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}")
    log(f"nvcc: {release[-1].strip() if release else ver.strip()}")
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native decoder cannot be built")
    log("g++: " + subprocess.run([gxx, "--version"], capture_output=True, text=True,
                                 check=True).stdout.splitlines()[0])
    card = card_line()
    log(card)
    return card


def phase_build():
    from khg_tpu_torch import kernels
    from khg_tpu_torch.fstlib import native

    def timed_native():
        t0 = time.perf_counter()
        return native.get_lib(), time.perf_counter() - t0

    # g++ builds the native core while nvcc builds the kernels
    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = ex.submit(timed_native)
        t0 = time.perf_counter()
        kernels.lib()
        secs = time.perf_counter() - t0
        core, native_s = pending.result()
    log(f"build: {secs:.1f} s ({kernels.build_info.get('path')})")
    if core is None:
        raise RuntimeError(f"native decoder core: {native.build_error()}")
    log(f"native decoder core: {native_s:.1f} s ({native.library_path()})")
    for src, out in (kernels.build_info.get("ptxas") or {}).items():
        for ln in out.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas {src}: {ln.strip()}")
    return secs


# ------------------------------------------------------------------- phase 3

def make_corpus(wav_dir: Path):
    import numpy as np

    from khg_tpu_torch.data.wav import write_wav
    from khg_tpu_torch.recipes.audiomnist import DIGITS, load_audiomnist_corpus
    from khg_tpu_torch.recipes.synth import SAMPLE_RATE, synthesize_word_sequence

    rng = np.random.default_rng(SEED)
    seen = set()
    while len(seen) < NUM_UTTS:
        digits = tuple(int(rng.integers(10)) for _ in range(int(rng.integers(3, 8))))
        if digits in seen:
            continue
        seen.add(digits)
        wave = synthesize_word_sequence([DIGITS[d] for d in digits], rng, SAMPLE_RATE)
        write_wav(wav_dir / ("_".join(map(str, digits)) + ".wav"), wave, SAMPLE_RATE)
    return load_audiomnist_corpus(wav_dir)


def short_utterances(setup):
    """(indices, frame counts, T): the 256 shortest utterances, all of
    at most T=512 frames."""
    import numpy as np

    from khg_tpu_torch.features.fbank import num_frames

    _lp, _tm0, _tree, _graphs, wave_lens, cfg = setup
    nfr = np.array([num_frames(cfg, n) for n in wave_lens])
    idx = [int(i) for i in np.argsort(nfr, kind="stable")[:256]]
    if nfr[idx].max() > 512:
        raise AssertionError("kernel checks: 256 utterances of <= 512 frames needed")
    return idx, nfr, 512


def banded_batch(setup, fb: bool):
    """The kernel checks' batch: the 256 shortest utterances (all of at
    most T=512 frames), packed as the main path packs them (S padded to
    256; for forward-backward in the log semiring without parallel
    arcs), with random loglikes of the main path's width.  Returns
    (pipeline, tables, offsets, loglikes, num_frames, T, P)."""
    import numpy as np
    import torch

    from khg_tpu_torch.recipes.pipeline import EStepPipeline

    lp, tm0, tree, graphs, wave_lens, cfg = setup
    idx, nfr, T = short_utterances(setup)
    pipe = EStepPipeline(
        copy.deepcopy(tm0), acoustic_scale=0.1, self_loop_scale=0.1,
        batch_size=256, states_pad_multiple=256, frames_pad_multiple=256,
        align_backend="banded", device=DEVICE,
    )
    base = pipe.pack_graphs_base(graphs)
    _g, banded, _sp = pipe._batch_graphs(idx, base, fb=fb)
    if banded is None:
        raise AssertionError(f"kernel checks: batch did not pack banded (fb={fb})")
    tables, offsets = banded
    B = tables.plane_cost.shape[0]
    P = int(pipe.id2pdf.max()) + 1
    gen = np.random.default_rng(1)
    ll = torch.as_tensor(
        (-40.0 + 8.0 * gen.standard_normal((B, T, P))).astype(np.float32),
        device=DEVICE,
    )
    nf = torch.as_tensor(nfr[idx].astype(np.int32), device=DEVICE)
    return pipe, tables, offsets, ll, nf, T, P


def check_viterbi_kernel(results, name, label, source, replaces, kernel, plain,
                         nbytes, ops, max_frames, width, S, shape):
    """One Viterbi kernel (A, A-sac, G) against its plain version:
    ``kernel()`` and ``plain()`` return (tids, total costs), which must
    be bit-equal.  Times both, and bounds the kernel by the larger of
    its throughput (``nbytes``, fp32 ``ops``) and its serial frame chain
    (``max_frames`` frames, a min over ``width`` candidates, S states)."""
    import torch

    tids_k, cost_k = kernel()
    tids_p, cost_p = plain()
    torch.cuda.synchronize()
    if not torch.equal(cost_k, cost_p):
        raise AssertionError(
            f"kernel {label}: total costs not bit-equal "
            f"(max diff {(cost_k - cost_p).abs().max().item()})"
        )
    if not torch.equal(tids_k, tids_p):
        raise AssertionError(f"kernel {label}: tids differ from the plain version")
    ms = time_ms(kernel, reps=10)
    plain_ms = time_ms(plain, reps=2)
    tp_ms, tp_by = bound(nbytes, ops, FP32_OPS_PER_S)
    serial_ms, chain = serial_bound(max_frames, width, S)
    b_ms, b_by = (serial_ms, "operations") if serial_ms > tp_ms else (tp_ms, tp_by)
    us_frame = ms / max_frames * 1e3
    serial_us_frame = serial_ms / max_frames * 1e3
    results[name] = dict(
        name=name, route="cuda", source=source, replaces=replaces,
        max_abs_err=float((cost_k - cost_p).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        throughput_bound_ms=tp_ms, serial_bound_ms=serial_ms,
        us_per_frame=us_frame, serial_bound_us_per_frame=serial_us_frame,
        serial_chain=chain, shape=shape,
        tolerance="costs bit-equal, tids equal",
    )
    dims = " ".join(f"{k}={v}" for k, v in shape.items())
    log(f"kernel {label} {name}: {dims}: bit-equal; {ms:.3f} ms, "
        f"{us_frame:.3f} us per frame of the longest utterance (serial bound "
        f"{serial_us_frame:.3f}) (plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
        f"{b_by}: serial {serial_ms:.4f}, throughput {tp_ms:.4f} {tp_by}; {chain})")


def check_banded(setup, results):
    """Kernel A at B=256, T=512, S=256 on real packed graphs."""
    from khg_tpu_torch.align.banded_kernel import banded_cuda, banded_plain

    _pipe, tables, offsets, ll, nf, T, P = banded_batch(setup, fb=False)
    B, DK, S = tables.plane_cost.shape
    steps = int(nf.sum())
    nbytes = (B * DK * S * 8 + B * S * 12 + B * T * P * 4 + B * 4 + DK * 4
              + B * T * 4 + B * 4)
    ops = steps * S * (2 * DK + 3)  # add + compare per plane; scale, sub, min
    check_viterbi_kernel(
        results, "banded_viterbi", "A", "khg_tpu_torch/csrc/banded_viterbi.cu",
        "khg_tpu/align/pallas_banded.py:51",
        lambda: banded_cuda(tables, offsets, ll, nf, 0.1),
        lambda: banded_plain(tables, offsets, ll, nf, 0.1),
        nbytes, ops, int(nf.max()), DK, S,
        dict(B=B, T=T, S=S, DK=DK, P=P, frames=steps, max_frames=int(nf.max())),
    )
    lat = step_latencies()
    log("dependent-step latencies (ns): " + ", ".join(
        f"{k} {v:.2f}" for k, v in lat.items()))


def check_banded_fb(setup, results):
    """Kernels D and E at B=256, T=512, S=256 on the utterances of the
    kernel A check, packed for forward-backward (log semiring, no
    parallel arcs)."""
    import torch

    from khg_tpu_torch.align.banded_fb import (
        banded_fb_bwd_cuda,
        banded_fb_bwd_plain,
        banded_fb_fwd_cuda,
        banded_fb_fwd_plain,
    )
    from khg_tpu_torch.align.forward_backward import (
        NEG_BIG,
        gamma_from_state_posteriors,
        tid_counts_from_posteriors,
    )

    pipe, tables, offsets, ll, nf, T, P = banded_batch(setup, fb=True)
    B, DK, S = tables.plane_cost.shape
    num_tids = pipe.tm.num_transition_ids
    args = (tables, offsets, ll, nf, 0.1)
    alphas_k, lz_k = banded_fb_fwd_cuda(*args)
    sp_k, ap_k = banded_fb_bwd_cuda(*args, alphas_k, lz_k)
    alphas_p, lz_p = banded_fb_fwd_plain(*args)
    sp_p, ap_p = banded_fb_bwd_plain(*args, alphas_p, lz_p)
    torch.cuda.synchronize()
    fail_k, fail_p = lz_k < NEG_BIG / 2, lz_p < NEG_BIG / 2
    if not torch.equal(fail_k, fail_p):
        raise AssertionError("kernel D: failures differ from the plain version")
    lz_rel = float(((lz_k - lz_p).abs() / lz_p.abs()).max())
    gam_k = gamma_from_state_posteriors(sp_k, tables.state_pdf, P)
    gam_p = gamma_from_state_posteriors(sp_p, tables.state_pdf, P)
    ok = ~fail_p
    gam_err = float((gam_k - gam_p)[ok].abs().max())
    cnt_err = float((tid_counts_from_posteriors(ap_k, tables.plane_tid, num_tids)
                     - tid_counts_from_posteriors(ap_p, tables.plane_tid, num_tids)
                     )[ok].abs().max())
    if lz_rel > 1e-5 or gam_err > 1e-4 or cnt_err > 1e-3:
        raise AssertionError(
            f"kernels D/E: log Z rel err {lz_rel} (<= 1e-5), gamma err "
            f"{gam_err} (<= 1e-4), tid-count err {cnt_err} (<= 1e-3)"
        )
    bit_equal = dict(log_z=bool(torch.equal(lz_k, lz_p)),
                     spost=bool(torch.equal(sp_k, sp_p)),
                     apost=bool(torch.equal(ap_k, ap_p)))
    ms_f = time_ms(lambda: banded_fb_fwd_cuda(*args), reps=10)
    ms_b = time_ms(lambda: banded_fb_bwd_cuda(*args, alphas_k, lz_k), reps=10)
    plain_f = time_ms(lambda: banded_fb_fwd_plain(*args), reps=2)
    plain_b = time_ms(lambda: banded_fb_bwd_plain(*args, alphas_p, lz_p), reps=2)
    steps = int(nf.sum())
    # the function's bytes: the tables, the acoustic rows of the active
    # frames, log Z, and the active frames' state posteriors and the
    # plane posteriors.  The design adds the alphas of the active frames
    # (D writes them, E reads them back) and E's zero posteriors past
    # each utterance's end (it writes all B*T*S): its bound beside.
    tab = B * DK * S * 4 + B * S * 4 + B * 4 + DK * 4
    nbytes_f = tab + 2 * B * S * 4 + steps * P * 4 + B * 4
    nbytes_b = (tab + B * S * 4 + steps * P * 4 + B * 4 + steps * S * 4
                + B * DK * S * 4)
    design_f = nbytes_f + steps * S * 4
    design_b = nbytes_b + steps * S * 4 + (B * T - steps) * S * 4
    # operations per active (frame, state): forward 5 DK + 5 (add, max,
    # subtract, expf, sum per plane; log, max add, scale, add, clamp);
    # backward 11 DK + 7 (the posterior: 2 adds, min, expf, 2 sums per
    # plane; beta as the forward; the acoustic term and log Z)
    ops_f = steps * S * (5 * DK + 5) + B * S * 5
    ops_b = steps * S * (11 * DK + 7)
    mf = int(nf.max())
    out = {}
    for name, src_line, ms, plain_ms, nbytes, design, ops, log_z in (
        ("banded_fb_fwd", 110, ms_f, plain_f, nbytes_f, design_f, ops_f, True),
        ("banded_fb_bwd", 155, ms_b, plain_b, nbytes_b, design_b, ops_b, False),
    ):
        tp_ms, tp_by = bound(nbytes, ops, FP32_OPS_PER_S)
        serial_ms, chain = fb_serial_bound(mf, DK, S, log_z)
        b_ms, b_by = ((serial_ms, "operations") if serial_ms > tp_ms
                      else (tp_ms, tp_by))
        dtp_ms, dtp_by = bound(design, ops, FP32_OPS_PER_S)
        d_ms, d_by = ((serial_ms, "operations") if serial_ms > dtp_ms
                      else (dtp_ms, dtp_by))
        out[name] = (f"{b_ms:.4f} ms: serial {serial_ms:.4f}, throughput "
                     f"{tp_ms:.4f} {tp_by}; design {d_ms:.4f} {d_by}")
        out[name] += (f"; {ms / mf * 1e3:.3f} us per frame of the longest "
                      f"utterance (serial bound {serial_ms / mf * 1e3:.3f})")
        results[name] = dict(
            name=name, route="cuda", source="khg_tpu_torch/csrc/banded_fb.cu",
            replaces=f"khg_tpu/align/pallas_banded_fb.py:{src_line}",
            max_abs_err=float((lz_k - lz_p).abs().max()) if log_z else gam_err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, throughput_bound_ms=tp_ms, serial_bound_ms=serial_ms,
            us_per_frame=ms / mf * 1e3, serial_bound_us_per_frame=serial_ms / mf * 1e3,
            design_bound_ms=d_ms, design_bound_by=d_by, serial_chain=chain,
            shape=dict(B=B, T=T, S=S, DK=DK, P=P, frames=steps, max_frames=mf),
            tolerance=("log Z rtol 1e-5, failures equal" if log_z else
                       "gamma atol 1e-4, tid counts atol 1e-3"),
        )
    results["banded_fb_fwd"]["log_z_max_rel_err"] = lz_rel
    results["banded_fb_bwd"]["tid_count_max_abs_err"] = cnt_err
    results["banded_fb_bwd"]["bit_equal"] = bit_equal
    log(f"kernels D/E banded_fb: B={B} T={T} S={S} DK={DK} P={P}, {steps} "
        f"frames (longest {mf}), {int(fail_p.sum())} failed: log Z rel err "
        f"{lz_rel:.2e}, gamma err {gam_err:.2e}, tid-count err {cnt_err:.2e}; "
        f"bit-equal {bit_equal}")
    log(f"  fwd {ms_f:.3f} ms (plain {plain_f:.1f} ms, bound {out['banded_fb_fwd']}); "
        f"bwd {ms_b:.3f} ms (plain {plain_b:.1f} ms, bound {out['banded_fb_bwd']}); "
        f"chain {results['banded_fb_fwd']['serial_chain']}")


def loglikes_problem(P, N=256 * 512, D=23, K=24, seed=2):
    """Kernel B's check problem: a random diagonal GMM of P pdfs with
    K // 2 to K real components each (the rest padding: gconst -inf,
    zero rows) and N standard-normal feature rows, on the card.
    Returns (gconsts, means_invvars, inv_vars, feats (N // 512, 512, D)
    or (N, D), real components per pdf)."""
    import numpy as np
    import torch

    gen = np.random.default_rng(seed)
    means = gen.standard_normal((P, K, D))
    var = gen.uniform(0.5, 2.0, (P, K, D))
    w = gen.dirichlet(np.ones(K), P)
    gconst = (np.log(w) - 0.5 * (D * np.log(2 * np.pi) + np.log(var).sum(-1)
                                 + (means ** 2 / var).sum(-1)))
    nreal = gen.integers(K // 2, K + 1, P)  # padding components: -inf
    for p in range(P):
        gconst[p, nreal[p]:] = -np.inf
        means[p, nreal[p]:] = 0.0
        var[p, nreal[p]:] = np.inf
    iv = np.where(np.isfinite(var), 1.0 / var, 0.0)
    dev = "cuda"
    g_t = torch.as_tensor(gconst.astype(np.float32), device=dev)
    miv_t = torch.as_tensor((means * iv).astype(np.float32), device=dev)
    iv_t = torch.as_tensor(iv.astype(np.float32), device=dev)
    shape = (N // 512, 512, D) if N % 512 == 0 else (N, D)
    x = torch.as_tensor(gen.standard_normal(shape).astype(np.float32), device=dev)
    return g_t, miv_t, iv_t, x, nreal


def check_loglikes(P, results):
    """Kernel B at N=256*512, D=23, K=24, f32 and bf16."""
    import torch

    from khg_tpu_torch.gmm.fused_loglikes import loglikes_cuda, loglikes_plain

    N, D, K = 256 * 512, 23, 24
    g_t, miv_t, iv_t, x, nreal = loglikes_problem(P, N, D, K)
    out = {}
    for dtype, tol in ((None, 1e-4), ("bfloat16", 5e-2)):
        got = loglikes_cuda(g_t, miv_t, iv_t, x, compute_dtype=dtype)
        ref = loglikes_plain(g_t, miv_t, iv_t, x, compute_dtype=dtype)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError("kernel B: wrong shape or non-finite output")
        err = float((got - ref).abs().max())
        if err > tol:
            raise AssertionError(f"kernel B ({dtype or 'f32'}): max abs err {err} > {tol}")
        out[dtype] = err
    ms = time_ms(lambda: loglikes_cuda(g_t, miv_t, iv_t, x), reps=10)
    plain_ms = time_ms(lambda: loglikes_plain(g_t, miv_t, iv_t, x), reps=10)
    ms_bf16 = time_ms(lambda: loglikes_cuda(g_t, miv_t, iv_t, x, "bfloat16"), reps=10)
    A = torch.cat([miv_t, -0.5 * iv_t], -1).reshape(P * K, 2 * D)
    x2 = torch.cat([x, x * x], -1)
    gflat = g_t.reshape(P * K)
    library_ms = time_ms(
        lambda: torch.logsumexp((x2 @ A.T + gflat).reshape(256, 512, P, K), -1),
        reps=10,
    )
    nbytes = N * D * 4 + P * K * (2 * D + 1) * 4 + N * P * 4
    # padding components (gconst -inf) need no work: count the real ones
    real = int(nreal.sum())
    ops = 2 * N * real * 2 * D + 3 * N * real
    b_ms, b_by = bound(nbytes, ops, FP32_OPS_PER_S)
    results["fused_loglikes"] = dict(
        name="fused_loglikes", route="cuda",
        source="khg_tpu_torch/csrc/loglikes.cu",
        replaces="khg_tpu/gmm/pallas_kernels.py:34",
        max_abs_err=out[None], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms,
        bf16=dict(max_abs_err=out["bfloat16"], ms=ms_bf16),
        shape=dict(N=N, D=D, P=P, K=K, real_components=real),
        tolerance="f32 1e-4, bf16 5e-2 (max abs)",
    )
    log(f"kernel B fused_loglikes: N={N} D={D} P={P} K={K}: err f32 "
        f"{out[None]:.2e} bf16 {out['bfloat16']:.2e}; {ms:.3f} ms (bf16 "
        f"{ms_bf16:.3f}, plain {plain_ms:.3f}, matmul+logsumexp "
        f"{library_ms:.3f}, bound {b_ms:.4f} {b_by}, {b_ms / ms:.1%} of it)")


def fbank_sass_hmma():
    """{kernel name: count} of TF32 tensor-core instructions (``HMMA``
    or ``HGMMA`` on TF32 operands) in each fbank kernel of the built
    library's SASS, by ``cuobjdump -sass``."""
    from khg_tpu_torch import kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", kernels.build_info["path"]],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, ""
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            if "fbank_kernel" in fn:
                counts[fn] = 0
        elif "fbank_kernel" in fn and re.search(r"\bH(G)?MMA\S*TF32", ln):
            counts[fn] += 1
    return counts


def fbank_case(rows, cfg, reps):
    """Kernel C against its plain version on (B, n) rows at ``cfg``:
    (padded wave, T, errors, kernel ms, plain ms, frames that take the
    sixth product: those of blocks whose wave span has a sample with a
    third TF32 part)."""
    import torch

    from khg_tpu_torch.features.fbank import num_frames
    from khg_tpu_torch.features.fbank_kernel import (
        _padded_wave,
        fbank_cuda,
        fbank_plain,
    )

    B, n = rows.shape
    waves = torch.as_tensor(rows, device="cuda")
    T = num_frames(cfg, n)
    padded = _padded_wave(waves, cfg, T)
    fk, ek = fbank_cuda(padded, cfg, T)
    fp, ep = fbank_plain(padded, cfg, T)
    torch.cuda.synchronize()
    if fk.shape != (B, T, cfg.num_mel_bins) or not torch.isfinite(fk).all():
        raise AssertionError(f"kernel C at {cfg.sample_rate} Hz: wrong shape or "
                             f"non-finite output")
    err = float((fk - fp).abs().max())
    err_e = float((ek - ep).abs().max())
    if err > 1e-3 or err_e > 1e-3:
        raise AssertionError(f"kernel C at {cfg.sample_rate} Hz: max abs err {err} "
                             f"(energy {err_e}) > 1e-3")
    ms = time_ms(lambda: fbank_cuda(padded, cfg, T), reps=reps)
    plain_ms = time_ms(lambda: fbank_plain(padded, cfg, T), reps=reps)
    return padded, T, err, err_e, ms, plain_ms, sixth_product(padded, cfg, T)[1]


def sixth_product(padded, cfg, T):
    """(blocks, frames) of kernel C's launch on ``padded`` that take the
    sixth product: blocks of FRAMES frames whose wave span has a sample
    with a third TF32 part, and their frames."""
    from khg_tpu_torch.features.fbank_kernel import FRAMES, fbank_plan, split_tf32

    plan = fbank_plan(cfg)
    lo = split_tf32(padded.cpu().numpy())[2] != 0
    blocks = frames = 0
    for t0 in range(0, T, FRAMES):
        span = lo[:, t0 * cfg.frame_shift:(t0 + plan.rows) * cfg.frame_shift]
        n = int(span.any(1).sum())
        blocks += n
        frames += n * min(FRAMES, T - t0)
    return blocks, frames


def fbank_bound(cfg, B, T, n, lo_frames):
    """(bound_ms, bound_by) of kernel C: the larger of its bytes (wave in,
    features and energy out) over the memory rate and its operations:
    the TF32 products over the used bins (5 a frame, 6 for the
    ``lo_frames``) at the tensor cores' rate, the power, mel sums, log
    and energy sums at the fp32 rate."""
    import numpy as np

    from khg_tpu_torch.features.fbank_kernel import kernel_tables, used_bins

    flen, M = cfg.frame_length, cfg.num_mel_bins
    _first, count = used_bins(cfg)
    nnz = int(np.count_nonzero(kernel_tables(cfg)[1]))
    frames = B * T
    tc_ops = (5 * frames + lo_frames) * 2 * flen * 2 * count
    fp32_ops = frames * (3 * count + 2 * nnz + M + 3 * flen)
    t_ops = (tc_ops / TF32_OPS_PER_S + fp32_ops / FP32_OPS_PER_S) * 1e3
    t_bytes = (B * n * 4 + frames * (M + 1) * 4) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_fbank(waves_np, cfg, results):
    """Kernel C on 256 rows of 4.2 s at 8 kHz (the WAVs' integer
    samples), and on 64 of them upsampled to 48 kHz (``resample_poly``,
    rounded to integers as a WAV holds them; FFT size 2,048), each held
    to the plain version at 1e-3.  Also: the TF32 tensor-core
    instructions in the kernels' SASS (there must be some); the times of
    the reflect-pad gather and of the whole ``fbank_fused`` at 8 kHz;
    and, as a yardstick only (the port never calls it),
    ``product_gemm_ms``: one full-fp32 ``torch.matmul`` (TF32 off, set
    here) of the materialised frames against ``[M_re | M_im]``."""
    import dataclasses

    import numpy as np
    import torch
    from scipy.signal import resample_poly

    from khg_tpu_torch.features.fbank_kernel import (
        _padded_wave,
        _tables,
        fbank_fused,
        fbank_plan,
        used_bins,
    )

    sass = fbank_sass_hmma()
    if not sass or not all(sass.values()):
        raise AssertionError(f"kernel C: no TF32 tensor-core instructions in {sass}")
    n = int(4.2 * cfg.sample_rate)
    rows = np.stack([
        np.pad(w, (0, max(0, n - len(w))), mode="symmetric")[:n]
        for w in waves_np[:256]
    ]).astype(np.float32)
    padded, T, err, err_e, ms, plain_ms, lo_frames = fbank_case(rows, cfg, reps=10)
    waves = torch.as_tensor(rows, device="cuda")
    gather_ms = time_ms(lambda: _padded_wave(waves, cfg, T), reps=10)
    fused_ms = time_ms(lambda: fbank_fused(waves, cfg), reps=10)
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick in full fp32
    m_re, m_im, _mel_t = _tables(cfg, "cuda")
    m_cat = torch.cat([m_re, m_im], 1)
    idx = (torch.arange(T, device="cuda")[:, None] * cfg.frame_shift
           + torch.arange(cfg.frame_length, device="cuda")[None, :])
    frames = padded[:, idx]
    gemm_ms = time_ms(lambda: frames @ m_cat, reps=10)
    del frames
    B, M = 256, cfg.num_mel_bins
    b_ms, b_by = fbank_bound(cfg, B, T, n, lo_frames)

    cfg48 = dataclasses.replace(cfg, sample_rate=48000)
    up = 48000 // math.gcd(48000, cfg.sample_rate)
    down = cfg.sample_rate // math.gcd(48000, cfg.sample_rate)
    rows48 = np.clip(np.round(resample_poly(rows[:64].astype(np.float64), up, down, axis=1)),
                     -32768, 32767).astype(np.float32)
    _p48, T48, err48, err48_e, ms48, plain48, lo48 = fbank_case(rows48, cfg48, reps=5)
    b48_ms, b48_by = fbank_bound(cfg48, 64, T48, rows48.shape[1], lo48)

    def plan_of(c):
        return dict(fbank_plan(c)._asdict(), used_bins=used_bins(c)[1])

    results["fbank"] = dict(
        name="fbank", route="cuda", source="khg_tpu_torch/csrc/fbank.cu",
        replaces="khg_tpu/features/pallas_fbank.py:93",
        max_abs_err=max(err, err_e, err48, err48_e), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, feats_max_abs_err=err,
        energy_max_abs_err=err_e, gather_ms=gather_ms, fbank_fused_ms=fused_ms,
        product_gemm_ms=gemm_ms,
        product_gemm="torch.matmul of (B, T, flen) frames by [M_re | M_im], fp32 "
                     "(allow_tf32 False); a yardstick, not the function",
        lo_product_frames=lo_frames, plan=plan_of(cfg), sass_tf32_mma=sass,
        shape=dict(B=B, T=T, frame_len=cfg.frame_length, N=cfg.fft_size,
                   F=cfg.fft_size // 2 + 1, M=M),
        at_48k=dict(B=64, T=T48, frame_len=cfg48.frame_length, N=cfg48.fft_size,
                    max_abs_err=err48, energy_max_abs_err=err48_e, ms=ms48,
                    plain_ms=plain48, bound_ms=b48_ms, bound_by=b48_by,
                    lo_product_frames=lo48, plan=plan_of(cfg48)),
        tolerance="log-mel and log-energy 1e-3 (max abs)",
    )
    log(f"kernel C fbank: B={B} T={T} N={cfg.fft_size} M={M} ({lo_frames} frames "
        f"take the sixth product; plan {plan_of(cfg)}): err {err:.2e} (energy {err_e:.2e}); "
        f"{ms:.4f} ms (plain {plain_ms:.3f}, bound {b_ms:.4f} {b_by}, "
        f"{b_ms / ms:.1%} of it); gather {gather_ms:.4f} ms, fbank_fused "
        f"{fused_ms:.4f} ms; fp32 product GEMM yardstick {gemm_ms:.4f} ms; "
        f"SASS TF32 mma {list(sass.values())}")
    log(f"kernel C fbank at 48 kHz: B=64 T={T48} N={cfg48.fft_size} ({lo48} frames "
        f"take the sixth product; plan {plan_of(cfg48)}): err {err48:.2e} (energy {err48_e:.2e}); "
        f"{ms48:.4f} ms (plain {plain48:.3f}, bound {b48_ms:.4f} {b48_by}, "
        f"{b48_ms / ms48:.1%} of it)")


def viterbi_batch(setup):
    """Kernel G's check batch: the kernel A check's utterances (B=256,
    T=512) packed without bands (incoming-arc tables, S padded to 256),
    random loglikes; returns (graphs, loglikes, num_frames, T, P)."""
    import numpy as np
    import torch

    from khg_tpu_torch.recipes.pipeline import EStepPipeline

    _lp, tm0, _tree, graphs, _wave_lens, _cfg = setup
    idx, nfr, T = short_utterances(setup)
    pipe = EStepPipeline(
        copy.deepcopy(tm0), acoustic_scale=0.1, self_loop_scale=0.1,
        batch_size=256, states_pad_multiple=256, frames_pad_multiple=256,
        align_backend="xla", device=DEVICE,
    )
    g, banded, _sp = pipe._batch_graphs(idx, pipe.pack_graphs_base(graphs))
    if banded is not None:
        raise AssertionError("kernel G check: batch packed banded")
    B, S, M = g.in_src.shape
    P = int(pipe.id2pdf.max()) + 1
    gen = np.random.default_rng(3)
    ll = torch.as_tensor(
        (-40.0 + 8.0 * gen.standard_normal((B, T, P))).astype(np.float32),
        device=DEVICE,
    )
    nf = torch.as_tensor(nfr[idx].astype(np.int32), device=DEVICE)
    return g, ll, nf, T, P


def check_viterbi(setup, results):
    """Kernel G on its check batch (``viterbi_batch``, the compiled
    kernel), then on random arc tables of shapes that take the generic
    kernel: two that the first port's shared-memory kernel took, and one
    beyond any block's shared memory."""
    from khg_tpu_torch.align.viterbi_kernel import viterbi_cuda, viterbi_plain, viterbi_plan

    g, ll, nf, T, P = viterbi_batch(setup)
    B, S, M = g.in_src.shape
    steps = int(nf.sum())
    # the arc tables, init/final, the active frames' loglike rows,
    # num_frames; tids and costs out
    nbytes = B * S * M * 16 + B * S * 8 + steps * P * 4 + B * 4 + B * T * 4 + B * 4
    ops = steps * S * M * 4  # add, scale, subtract, compare per arc
    check_viterbi_kernel(
        results, "viterbi", "G", "khg_tpu_torch/csrc/viterbi.cu",
        "khg_tpu/align/pallas_viterbi.py:63",
        lambda: viterbi_cuda(g, ll, nf, 0.1),
        lambda: viterbi_plain(g, ll, nf, 0.1),
        nbytes, ops, int(nf.max()), M, S,
        dict(B=B, T=T, S=S, M=M, P=P, frames=steps, max_frames=int(nf.max())),
    )
    plan = viterbi_plan(S, M)
    if plan[0] != "compiled":
        raise AssertionError(f"kernel G: the check batch took {plan}, not the compiled kernel")
    results["viterbi"]["plan"] = [plan[0], str(plan[1]), plan[2]]
    for key, B2, S2, M2, seed in (("generic_s2048_m4", 64, 2048, 4, 5),
                                  ("generic_s256_m16", 64, 256, 16, 6),
                                  ("generic", 8, 8000, 4, 4)):
        check_viterbi_generic(results, key, B2, S2, M2, seed)


def random_arc_tables(rng, B, S, M, P):
    """Random incoming-arc tables on the card: state 0 initial, sources
    mostly 0-2 states back (else anywhere), a fifth of the slots beyond
    the first padding (cost BIG), final states at the end."""
    import numpy as np
    import torch

    from khg_tpu_torch.align.packed import BatchedGraphs

    big = np.float32(1e30)
    s = np.arange(S)[None, :, None]
    src = np.where(rng.uniform(size=(B, S, M)) < 0.7,
                   np.maximum(s - rng.integers(0, 3, (B, S, M)), 0),
                   rng.integers(0, S, (B, S, M)))
    real = rng.uniform(size=(B, S, M)) < 0.8
    real[:, :, 0] = True
    cost = np.where(real, rng.uniform(0.1, 3.0, (B, S, M)), big).astype(np.float32)
    tid = np.where(real, rng.integers(1, 90, (B, S, M)), 0).astype(np.int32)
    pdf = rng.integers(0, P, (B, S, M)).astype(np.int32)
    init = np.full((B, S), big, np.float32)
    init[:, 0] = 0.0
    final = np.full((B, S), big, np.float32)
    final[:, -3:] = rng.uniform(0.0, 1.0, (B, 3))
    zeros = np.zeros((B, S, M), np.int32)
    return BatchedGraphs(*[torch.as_tensor(x, device=DEVICE) for x in (
        src.astype(np.int32), tid, pdf, cost, zeros, zeros, zeros,
        np.zeros((B, S, M), np.float32), init, final)])


def check_viterbi_generic(results, key, B, S, M, seed, T=200, P=50):
    """Kernel G's generic kernel at (B, S, M) on random tables (from
    ``seed``) of T=200 frames: bit-equal to the plain version, timed, and bounded by its
    serial frame chain; kept as results["viterbi"][key]."""
    import numpy as np
    import torch

    from khg_tpu_torch.align.viterbi_kernel import viterbi_cuda, viterbi_plain, viterbi_plan

    rng = np.random.default_rng(seed)
    g = random_arc_tables(rng, B, S, M, P)
    ll = torch.as_tensor((-20 + 5 * rng.standard_normal((B, T, P))).astype(np.float32),
                         device=DEVICE)
    nf = torch.as_tensor(rng.integers(T // 2, T + 1, B).astype(np.int32), device=DEVICE)
    plan = viterbi_plan(S, M)
    tk, ck = viterbi_cuda(g, ll, nf, 0.1)
    tp, cp = viterbi_plain(g, ll, nf, 0.1)
    torch.cuda.synchronize()
    if plan[0] != "generic" or not torch.equal(ck, cp) or not torch.equal(tk, tp):
        raise AssertionError(f"kernel G generic {plan} at S={S} M={M}: costs or tids "
                             f"differ from the plain version (max diff "
                             f"{(ck - cp).abs().max().item()})")
    ms = time_ms(lambda: viterbi_cuda(g, ll, nf, 0.1), reps=5)
    plain_ms = time_ms(lambda: viterbi_plain(g, ll, nf, 0.1), reps=1)
    frames = int(nf.max())
    serial_ms, chain = serial_bound(frames, M, S)
    results["viterbi"][key] = dict(
        B=B, S=S, M=M, T=T, P=P, max_frames=frames, plan=[plan[0], str(plan[1]), plan[2]],
        ms=ms, plain_ms=plain_ms, us_per_frame=ms / frames * 1e3,
        serial_bound_ms=serial_ms, serial_chain=chain,
    )
    log(f"kernel G viterbi {key}: B={B} T={T} S={S} M={M} P={P} ({plan[0]}, "
        f"{plan[1]} backpointers, alpha in {plan[2]} memory): bit-equal; {ms:.3f} ms, "
        f"{ms / frames * 1e3:.3f} us per frame of the longest utterance (plain "
        f"{plain_ms:.1f} ms, serial bound {serial_ms:.4f} ms: {chain})")


# ------------------------------------------------------------------ phase 7
# the triphone-bench widths (bench.py build_system / build_problem with
# num_phones=682, dim=80, mix=32, batch=64, frames=300, words_per_utt=3)
TRI_PHONES = 682
TRI_DIM = 80
TRI_MIX = 32
TRI_GRAPHS = 16
TRI_UTTS = 512
TRI_FRAMES = 300
TRI_BATCH = 64
TRI_PASSES = 3


def triphone_system():
    """The triphone-bench system from the port's own modules: 682
    single-phone words plus SIL (2,051 pdfs), a flat start on 100
    standard-normal frames split to 32 Gaussians per pdf, 16 distinct
    3-word training graphs spread over 512 utterances of 300
    standard-normal 80-dim frames (as bench.py draws its features).
    Returns (tm, am, graphs, feats); graphs[i] is the FST of utterance
    i, one object per distinct graph."""
    import numpy as np

    from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
    from khg_tpu_torch.lang.topo import generate_hmm_topo
    from khg_tpu_torch.recipes.corpus_train import compile_training_graphs
    from khg_tpu_torch.recipes.steps import gmm_init_mono

    rng = np.random.default_rng(SEED)
    word2phones = {"<SIL>": ["SIL"]}
    for i in range(TRI_PHONES):
        word2phones[f"W{i}"] = [f"P{i}"]
    lp = Lexiconp.from_lexicon(Lexicon(word2phones=word2phones)).add_lex_disambig()
    topo = generate_hmm_topo(
        non_sil_phones=lp.get_non_sil_phone_ids(),
        sil_phone=lp.get_sil_phone_id(),
    )
    tm, tree, am = gmm_init_mono(
        topo, [rng.standard_normal((100, TRI_DIM)).astype(np.float32)]
    )
    for p in range(am.num_pdfs):
        am.get_pdf(p).split(TRI_MIX, 0.1, rng=rng)
    words = [f"W{i}" for i in range(TRI_PHONES)]
    seqs = set()
    while len(seqs) < TRI_GRAPHS:
        seqs.add(tuple(words[int(rng.integers(TRI_PHONES))] for _ in range(3)))
    seqs = sorted(seqs)
    distinct = compile_training_graphs(lp, tm, tree, seqs)
    graphs = [distinct[i % TRI_GRAPHS] for i in range(TRI_UTTS)]
    feats = [rng.standard_normal((TRI_FRAMES, TRI_DIM)).astype(np.float32)
             for _ in range(TRI_UTTS)]
    return tm, am, graphs, feats


def tri_pipeline(tm, **kw):
    from khg_tpu_torch.recipes.pipeline import EStepPipeline

    return EStepPipeline(
        copy.deepcopy(tm), acoustic_scale=0.1, self_loop_scale=0.1,
        batch_size=TRI_BATCH, frames_pad_multiple=4, states_pad_multiple=8,
        mix_pad_multiple=8, device=DEVICE, **kw,
    )


def tri_packed(pipe, graphs):
    """pack_graphs_base of the distinct graphs, one packed object per
    distinct FST (the pipeline caches batches by object)."""
    packed = {}
    out = []
    for g in graphs:
        if id(g) not in packed:
            packed[id(g)] = pipe.pack_graphs_base([g])[0]
        out.append(packed[id(g)])
    return out


def tri_batch(tri):
    """The first wide batch as the path builds it: (model, tables,
    offsets, bfeats, lens, sac, pdf_ids, frame weights, state_pdf),
    with the alignment kernel A gives on the per-state lattice."""
    import torch

    from khg_tpu_torch.align.banded_kernel import viterbi_align_banded
    from khg_tpu_torch.gmm.likelihoods import loglikes_per_state

    tm, am, graphs, feats = tri
    pipe = tri_pipeline(tm, align_backend="banded")
    base = tri_packed(pipe, graphs)
    model = pipe.pack_model_device(am)
    idx = list(range(TRI_BATCH))
    bfeats, lens, _bt = pipe._batch_feats(idx, feats)
    _g, banded, _sp = pipe._batch_graphs(idx, base)
    if banded is None:
        raise AssertionError("phase 7: the triphone batch did not pack banded")
    tables, offsets = banded
    sac = loglikes_per_state(model[0], model[1], model[2], tables.state_pdf, bfeats)
    res = viterbi_align_banded(tables, offsets, None, lens, pipe._id2pdf_t,
                               acoustic_scale=0.1, sac=sac)
    if bool(res.failed.any()):
        raise AssertionError("phase 7: the triphone batch failed to align")
    T = bfeats.shape[1]
    fw = (torch.arange(T, device=DEVICE)[None, :] < lens[:, None]).to(torch.float32)
    pdf_ids = pipe._id2pdf_t[res.tids.long()].to(torch.int32)
    return model, tables, offsets, bfeats, lens, sac, pdf_ids, fw, tables.state_pdf


def check_fold(batch, results):
    """Kernel F at the triphone-bench widths, on the first batch's graph
    states and its kernel-A alignment: the whole fold function, and its
    parts (grouping, scoring, fold) from CUDA events."""
    import torch

    from khg_tpu_torch.stats.accum import accumulate_am_stats_local
    from khg_tpu_torch.stats.fold_kernel import accumulate_am_stats_fold, fold_cuda

    (g, miv, iv, _w), tables, _offsets, x, _lens, _sac, pid, fw, sp = batch
    args = (g, miv, iv, x, pid, fw, sp)
    got = accumulate_am_stats_fold(*args)
    again = accumulate_am_stats_fold(*args)
    ref = accumulate_am_stats_local(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("kernel F: a rerun is not bit-identical")
    errs = {}
    for name, a, b in zip(("occ", "mean_acc", "var_acc"), got, ref):
        if not torch.allclose(a, b, rtol=2e-4, atol=2e-4):
            raise AssertionError(f"kernel F: {name} off by {(a - b).abs().max().item()}")
        errs[name] = float((a - b).abs().max())
    ll_rel = abs(float(got.tot_log_like - ref.tot_log_like)) / abs(float(ref.tot_log_like))
    if ll_rel > 2e-4 or not torch.equal(got.tot_frames, ref.tot_frames):
        raise AssertionError(f"kernel F: tot_log_like rel err {ll_rel}, frames "
                             f"{got.tot_frames.item()} vs {ref.tot_frames.item()}")
    ms = time_ms(lambda: accumulate_am_stats_fold(*args), reps=10)
    plain_ms = time_ms(lambda: accumulate_am_stats_local(*args), reps=10)
    # the parts, from events around each launch of 10 calls (the gaps
    # while the host enqueues the next launch included), and the
    # kernels' device time from a profiler trace of 10 calls
    parts = {"grouping": 0.0, "scoring": 0.0, "fold": 0.0}
    for _ in range(10):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        fold_cuda(*args, events=ev)
        torch.cuda.synchronize()
        for i, k in enumerate(parts):
            parts[k] += ev[i].elapsed_time(ev[i + 1]) / 10
    device = kernel_device_ms(lambda: fold_cuda(*args), 10, "fold_")
    P, K, D = miv.shape
    B, T, _ = x.shape
    S = sp.shape[1]
    Q = 2 * D + 1
    hit = (pid[:, :, None] == sp[:, None, :]).any(-1) & (fw > 0)
    frames = int(hit.sum())
    used = int(torch.unique(sp).numel())
    # the heaviest pdf's frames set the fold's serial length
    heaviest = int(torch.bincount(pid[hit].long(), minlength=P).max()) if frames else 0
    # the function's bytes: the model rows of the pdfs on the graphs'
    # states, features, ids, weights and state pdfs in; (P, K, 1+2D)
    # stats and two scalars out
    nbytes = used * K * Q * 4 + B * T * D * 4 + B * T * 8 + B * S * 4 + P * K * Q * 4 + 8
    # per aligned frame: K dots of 2D (multiply-add), the logsumexp and
    # posteriors (~6 per component), the fold (multiply-add per entry);
    # then the scatter's adds of the (B, S) partials
    per_frame = K * 2 * D * 2 + 6 * K + K * Q * 2
    ops = frames * per_frame + B * S * K * Q
    b_ms, b_by = bound(nbytes, ops, FP32_OPS_PER_S)
    # the TPU kernel's design scores every state's K rows of every frame
    design_ops = B * T * (S * K * 2 * D * 2 + S * K) + frames * (6 * K + K * Q * 2)
    d_ms, d_by = bound(nbytes, design_ops, FP32_OPS_PER_S)
    results["stats_fold"] = dict(
        name="stats_fold", route="cuda", source="khg_tpu_torch/csrc/stats_fold.cu",
        replaces="khg_tpu/stats/pallas_fold.py:57",
        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, parts_ms=parts, device_ms=device,
        heaviest_pdf_frames=heaviest,
        design_bound_ms=d_ms, design_bound_by=d_by, max_abs_errs=errs,
        tot_log_like_rel_err=ll_rel,
        shape=dict(B=B, T=T, S=S, K=K, D=D, P=P, frames=frames, used_pdfs=used),
        tolerance="occ, moments rtol+atol 2e-4; tot_log_like rel 2e-4; "
                  "tot_frames exact; rerun bit-identical",
    )
    log(f"kernel F stats_fold: B={B} T={T} S={S} K={K} D={D} P={P}, {frames} "
        f"frames on {used} pdfs (heaviest {heaviest}): errs {errs}, ll rel "
        f"{ll_rel:.2e}, rerun bit-identical; {ms:.3f} ms (grouping "
        f"{parts['grouping']:.3f}, scoring {parts['scoring']:.3f}, fold "
        f"{parts['fold']:.3f}; device {json.dumps(device)}; plain {plain_ms:.3f}, "
        f"bound {b_ms:.4f} {b_by}; "
        f"all-states design {d_ms:.4f} {d_by})")


def check_banded_sac(batch, results):
    """Kernel A in external-acoustic mode on the first triphone batch's
    tables and per-state lattice."""
    from khg_tpu_torch.align.banded_kernel import banded_sac_cuda, banded_sac_plain

    _model, tables, offsets, _x, lens, sac, _pid, _fw, _sp = batch
    B, DK, S = tables.plane_cost.shape
    T = sac.shape[1]
    steps = int(lens.sum())
    nbytes = (B * DK * S * 8 + B * S * 12 + steps * S * 4 + B * 4 + DK * 4
              + B * T * 4 + B * 4)
    check_viterbi_kernel(
        results, "banded_viterbi_sac", "A-sac",
        "khg_tpu_torch/csrc/banded_viterbi.cu", "khg_tpu/align/pallas_banded.py:51",
        lambda: banded_sac_cuda(tables, offsets, sac, lens, 0.1),
        lambda: banded_sac_plain(tables, offsets, sac, lens, 0.1),
        nbytes, steps * S * (2 * DK + 3), int(lens.max()), DK, S,
        dict(B=B, T=T, S=S, DK=DK, frames=steps, max_frames=int(lens.max())),
    )


def check_loglikes_wide(batch, results):
    """Kernel B at the triphone widths (D=80, P=2,051, K=32) on 4,096
    of the first batch's frames: the row width the narrow route of
    phase 7 runs."""
    import torch

    from khg_tpu_torch.gmm.fused_loglikes import loglikes_cuda, loglikes_plain

    (g, miv, iv, _w), _t, _o, x, _l, _s, _p, _f, _sp = batch
    xs = x.reshape(-1, x.shape[-1])[:4096].contiguous()
    got = loglikes_cuda(g, miv, iv, xs)
    ref = loglikes_plain(g, miv, iv, xs)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.isfinite(got).all() or err > 1e-4:
        raise AssertionError(f"kernel B at D=80: max abs err {err} > 1e-4")
    ms = time_ms(lambda: loglikes_cuda(g, miv, iv, xs), reps=5)
    plain_ms = time_ms(lambda: loglikes_plain(g, miv, iv, xs), reps=5)
    P, K, D = miv.shape
    N = xs.shape[0]
    A = torch.cat([miv, -0.5 * iv], -1).reshape(P * K, 2 * D)
    x2 = torch.cat([xs, xs * xs], -1)
    gflat = g.reshape(P * K)
    library_ms = time_ms(
        lambda: torch.logsumexp((x2 @ A.T + gflat).reshape(N, P, K), -1), reps=5,
    )
    real = int(torch.isfinite(g).sum())
    b_ms, b_by = bound(N * D * 4 + P * K * (2 * D + 1) * 4 + N * P * 4,
                       2 * N * real * 2 * D + 3 * N * real, FP32_OPS_PER_S)
    results["fused_loglikes"]["d80"] = dict(
        N=N, D=D, P=P, K=K, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
    )
    log(f"kernel B fused_loglikes at N={N} D={D} P={P} K={K}: err {err:.2e}; "
        f"{ms:.3f} ms (plain {plain_ms:.3f}, matmul+logsumexp {library_ms:.3f}, "
        f"bound {b_ms:.4f} {b_by}, {b_ms / ms:.1%} of it)")


# --------------------------------------------------------------- phase 4-5

def main_path(corpus, lp, graphs, cfg):
    import numpy as np

    from khg_tpu_torch import kernels
    from khg_tpu_torch.recipes.corpus_train import train_corpus
    from khg_tpu_torch.recipes.yesno_wav import extract_features

    stages = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    corpus = extract_features(corpus, cfg, device=DEVICE)
    stages["fbank_s"] = time.perf_counter() - t0
    feats = corpus.feats
    for f, p in zip(feats, corpus.wav_paths):
        if f.ndim != 2 or f.shape[1] != cfg.num_mel_bins or not np.isfinite(f).all():
            raise AssertionError(f"bad features for {p.name}: {f.shape}")
    t0 = time.perf_counter()
    res = train_corpus(
        lp, corpus.word_seqs, feats, num_iters=6, total_gauss=1000,
        max_iter_inc=3, stretch=2, batch_size=256, seed=SEED, graphs=graphs,
        device=DEVICE,
    )
    stages["train_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    audio_sec = sum(f.shape[0] for f in feats) / 100.0
    lls = res.avg_loglikes
    log(f"avg log-likes per pass: {[round(float(x), 4) for x in lls]}")
    log(f"Gaussians per pass: {res.num_gauss_after_est}; failures per pass: "
        f"{res.align_failures}; info: {res.info}")
    log(f"main path launches: {launches}")
    if not all(np.isfinite(lls)) or not lls[-1] > lls[0]:
        raise AssertionError(f"avg log-likelihood did not rise: {lls}")
    if any(res.align_failures):
        raise AssertionError(f"alignment failures: {res.align_failures}")
    for k in ("banded_viterbi", "fbank"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    passes = len(lls)
    log(f"audio: {audio_sec:.1f} s; fbank {stages['fbank_s']:.2f} s "
        f"({audio_sec / stages['fbank_s']:.0f} audio-sec/s); train "
        f"{stages['train_s']:.2f} s for {passes} passes "
        f"({audio_sec * passes / stages['train_s']:.0f} audio-sec/s); "
        f"train timings {json.dumps({k: round(v, 3) for k, v in res.timings.items()})}")
    return res, feats, launches


def pallas_backend(res, graphs, feats):
    import numpy as np

    from khg_tpu_torch import kernels
    from khg_tpu_torch.est.mle import MleDiagGmmOptions
    from khg_tpu_torch.model.transition_model import MleTransitionUpdateConfig
    from khg_tpu_torch.recipes.pipeline import EStepPipeline

    recs = {}
    launches = None
    # "xla" twice: whether two identical runs give bit-identical records
    # (index_add_ on the card sums with atomics); then every batch
    # through the non-banded Viterbi kernel (align_backend="xla")
    runs = (("xla", "banded"), ("pallas", "banded"), ("xla", "banded"),
            ("xla", "xla"))
    for run, (backend, align) in enumerate(runs):
        pipe = EStepPipeline(
            copy.deepcopy(res.transition_model), acoustic_scale=0.1,
            self_loop_scale=0.1, batch_size=256, mix_pad_multiple=8,
            states_pad_multiple=256, frames_pad_multiple=256,
            likelihood_backend=backend, align_backend=align,
            device=DEVICE,
        )
        base = pipe.pack_graphs_base(graphs)
        model = pipe.pack_model_device(res.am)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _m, rec = pipe.em_passes_resident(
            model, base, feats, 2, mle_config=MleDiagGmmOptions(),
            transition_cfg=MleTransitionUpdateConfig(),
        )
        secs = time.perf_counter() - t0
        if backend == "pallas":
            launches = dict(kernels.LAUNCHES)
        if align == "xla":
            g_launches = dict(kernels.LAUNCHES)
        recs[run] = rec
        log(f"backend {backend}, align {align}: 2 passes in {secs:.2f} s; avg ll "
            f"{(rec[:, 0] / rec[:, 1]).round(5).tolist()}; failures "
            f"{rec[:, 4].tolist()}")
    log(f"pallas-backend launches: {launches}; align-xla launches: {g_launches}")
    if launches["fused_loglikes"] <= 0:
        raise AssertionError("kernel B never launched on the pallas backend")
    log(f"xla backend run twice: records bit-identical: "
        f"{bool((recs[0] == recs[2]).all())}; max abs diff "
        f"{float(np.abs(recs[0] - recs[2]).max())}")
    x, p = recs[0], recs[1]
    for col in (0, 2):  # tot_log_like, like_sum: per frame
        d = np.abs(x[:, col] - p[:, col]) / np.maximum(x[:, 1], 1.0)
        if d.max() > 1e-3:
            raise AssertionError(f"pallas vs xla records differ by {d.max()} per frame")
    if (x[:, 1] != p[:, 1]).any() or p[:, 4].any():
        raise AssertionError("pallas backend: frame counts differ or alignments failed")
    if g_launches["viterbi"] <= 0 or g_launches["banded_viterbi"] != 0:
        raise AssertionError("align_backend='xla' did not run every batch "
                             "through kernel G")
    x, v = recs[0], recs[3]
    per_frame = np.abs(x[:, [0, 2]] - v[:, [0, 2]]) / x[:, 1:2]
    log(f"banded vs non-banded Viterbi records, per frame: tot_log_like "
        f"{per_frame[:, 0].tolist()}, like_sum {per_frame[:, 1].tolist()}")
    if per_frame.max() > 1e-4 or (x[:, [1, 3, 4, 5]] != v[:, [1, 3, 4, 5]]).any():
        raise AssertionError("align_backend='xla' records differ from the banded "
                             f"ones by {per_frame.max()} per frame, or counts differ")
    return launches, g_launches


# ------------------------------------------------------------------ phase 6

def soft_em(res, graphs, feats):
    """Resident Baum-Welch from phase 4's model: banded kernels twice,
    the dense FB once, each for 2 passes; pass 2 of both routes again
    from one state; and one accumulate_forward_backward pass.

    The 2-pass runs are held to 1e-4 per frame in tot_log_like, tot_frames
    and log Z, except pass 2's tot_log_like, held to 5e-4: each route's
    M-step feeds its own second pass, and in the recorded runs EM
    amplified the routes' pass-1 f32 noise in that likelihood 9-72x
    (8.7e-5 per frame on the first port's fbank features, 1.7e-4 on the
    split-TF32 kernel's).  Pass 2 from one state (the banded route's model and
    transition model after one pass) holds all three to 1e-4.

    The transition and self-loop scales are equal (1.0), so the graph
    weights are the transition probabilities raised to one power and
    the M-step maximises the objective that log Z measures: log Z may
    not fall from pass to pass."""
    import numpy as np
    import torch

    from khg_tpu_torch import kernels
    from khg_tpu_torch.align import banded_fb
    from khg_tpu_torch.est.flags import GMM_ALL
    from khg_tpu_torch.est.mle import MleDiagGmmOptions
    from khg_tpu_torch.model.transition_model import MleTransitionUpdateConfig
    from khg_tpu_torch.recipes.pipeline import EStepPipeline
    from khg_tpu_torch.stats.accum import AccumAmDiagGmm

    frames = sum(f.shape[0] for f in feats)

    def pipeline(backend, tm=None):
        return EStepPipeline(
            copy.deepcopy(res.transition_model if tm is None else tm), acoustic_scale=0.1,
            transition_scale=1.0, self_loop_scale=1.0, batch_size=256,
            mix_pad_multiple=8, states_pad_multiple=256,
            frames_pad_multiple=256, align_backend=backend, device=DEVICE,
        )

    def passes(pipe, model, base, n):
        return pipe.fb_em_passes_resident(
            model, base, feats, n, mle_config=MleDiagGmmOptions(),
            transition_cfg=MleTransitionUpdateConfig(),
        )

    recs, walls = [], {}
    launches = None
    calls = {}
    for run, backend in enumerate(("banded", "banded", "xla")):
        pipe = pipeline(backend)
        base = pipe.pack_graphs_base(graphs)
        model = pipe.pack_model_device(res.am)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        # the rerun times each launch of kernels D and E
        with (event_timed(banded_fb, ("banded_fb_fwd_cuda", "banded_fb_bwd_cuda"),
                          calls) if run == 1 else contextlib.nullcontext()):
            _m, rec = passes(pipe, model, base, 2)
        secs = time.perf_counter() - t0
        if run == 0:
            launches = dict(kernels.LAUNCHES)
        walls[f"{backend}_{run}_s"] = secs
        walls[f"{backend}_{run}_passes_s"] = pipe.counters.wall["fb"]
        recs.append(rec)
        log(f"soft EM {backend} (run {run}): 2 passes in {secs:.2f} s "
            f"({pipe.counters.wall['fb']:.3f} s after packing); log Z "
            f"per frame {(rec[:, 2] / frames).round(6).tolist()}; avg ll "
            f"{(rec[:, 0] / rec[:, 1]).round(6).tolist()}; failures "
            f"{rec[:, 4].tolist()}")
    log(f"soft-EM launches: {launches}")
    torch.cuda.synchronize()
    kernel_ms = {}
    for fn, pairs in calls.items():
        times = [s.elapsed_time(e) for s, e, _shape in pairs]
        kernel_ms[fn] = sum(times) / 2
        shapes = [(*sh[:4], int(sh[4].max())) for _s, _e, sh in pairs]
        log(f"phase 6 rerun, {fn} per launch (ms, (B, DK, S, T, longest "
            f"utterance)): {list(zip(times, shapes))}")
    fb_pass_s = walls["banded_1_passes_s"] / 2
    log(f"phase 6 rerun, per pass: D {kernel_ms['banded_fb_fwd_cuda']:.3f} ms + "
        f"E {kernel_ms['banded_fb_bwd_cuda']:.3f} ms of {fb_pass_s * 1e3:.1f} ms "
        f"wall ({sum(kernel_ms.values()) / (fb_pass_s * 1e3):.1%})")
    b0, b1, x = recs
    if b0[:, 4].any() or x[:, 4].any():
        raise AssertionError("soft EM: forward-backward failures")
    if not b0[1, 2] >= b0[0, 2]:
        raise AssertionError(f"soft EM: log Z fell from pass 1 to pass 2: {b0[:, 2]}")
    for k in ("banded_fb_fwd", "banded_fb_bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the soft-EM path")
    log(f"banded soft EM run twice: records bit-identical: "
        f"{bool((b0 == b1).all())}; max abs diff {float(np.abs(b0 - b1).max())}")
    # tot_log_like, tot_frames and log Z within 1e-4 per frame, pass 2's
    # tot_log_like within 5e-4 (the docstring says why)
    per_frame = np.abs(b0 - x) / frames
    log(f"banded vs dense records, per frame: log Z {per_frame[:, 2].tolist()}, "
        f"tot_log_like {per_frame[:, 0].tolist()}, tot_frames "
        f"{per_frame[:, 1].tolist()}")
    limit = np.full((2, 3), 1e-4)
    limit[1, 0] = 5e-4
    if (per_frame[:, :3] > limit).any():
        raise AssertionError(f"soft EM: banded vs dense records differ by "
                             f"{per_frame[:, :3].tolist()} per frame (limits "
                             f"{limit.tolist()})")
    if (b0[:, 3:6] != x[:, 3:6]).any():
        raise AssertionError("soft EM: banded vs dense utterance counts differ")

    # pass 2 of both routes from one state.  The base graphs depend only
    # on each transition id's pdf: packed once, outside the timings.
    base = pipeline("banded").pack_graphs_base(graphs)
    banded, dense = pipeline("banded"), pipeline("xla")
    m1, r1 = passes(banded, banded.pack_model_device(res.am), base, 1)
    m1x, x1 = passes(dense, dense.pack_model_device(res.am), base, 1)
    dense = pipeline("xla", tm=banded.tm)  # the banded route's state after pass 1
    t0 = time.perf_counter()
    _m, x2 = passes(dense, m1, base, 1)
    walls["xla_pass2_from_banded_s"] = time.perf_counter() - t0
    _m, r2 = passes(banded, m1, base, 1)
    if not (np.concatenate([r1, r2]) == b0).all():
        raise AssertionError("soft EM: the banded route restarted after one pass "
                             "differs from its 2-pass run")
    if not (x1 == x[:1]).all():
        raise AssertionError("soft EM: the dense route's first pass differs from "
                             "its 2-pass run's")
    # how far pass 1 left the two routes' models apart (finite entries;
    # and how many entries are finite in one model only)
    gaps = {}
    for name, a, c in zip(("gconsts", "means_invvars", "inv_vars", "weights"), m1, m1x):
        both = torch.isfinite(a) & torch.isfinite(c)
        gaps[name] = (float((a - c)[both].abs().max()),
                      int((torch.isfinite(a) != torch.isfinite(c)).sum()))
    gap2 = np.abs(r2 - x2)[0] / frames
    log(f"banded restarted after one pass: records equal to its 2-pass run's; "
        f"dense pass 1 equal to its own; models after pass 1, banded vs dense, "
        f"max abs gap (entries finite in one only): {gaps}; pass 2 from the "
        f"banded state, per frame: log Z {gap2[2]}, tot_log_like {gap2[0]}, "
        f"tot_frames {gap2[1]}")
    if x2[:, 4].any():
        raise AssertionError("soft EM: dense forward-backward failures")
    if gap2[:3].max() > 1e-4:
        raise AssertionError(f"soft EM: pass 2 from one state, banded vs dense "
                             f"records differ by {gap2[:3].tolist()} per frame "
                             f"(> 1e-4)")
    if (r2[:, 3:6] != x2[:, 3:6]).any():
        raise AssertionError("soft EM: banded vs dense utterance counts differ")

    pipe = pipeline("banded")
    accs = AccumAmDiagGmm()
    accs.init(res.am, flags=GMM_ALL)
    t0 = time.perf_counter()
    log_z = pipe.accumulate_forward_backward(
        res.am, pipe.refresh_transition_costs(pipe.pack_graphs_base(graphs)),
        feats, accs, pipe.tm.init_stats(),
    )
    walls["accumulate_s"] = time.perf_counter() - t0
    rel = abs(log_z - b0[0, 2]) / abs(b0[0, 2])
    log(f"accumulate_forward_backward: log Z {log_z:.3f} vs pass 1 "
        f"{b0[0, 2]:.3f} (rel {rel:.2e}) in {walls['accumulate_s']:.2f} s")
    if rel > 1e-5:
        raise AssertionError(f"accumulate_forward_backward log Z off by {rel}")
    log(f"soft-EM wall times: {json.dumps({k: round(v, 3) for k, v in walls.items()})}")
    return launches


# ------------------------------------------------------------------ phase 7

def fold_shape(gconsts, miv, iv, feats, pdf_ids, weights, state_pdf):
    """(B, S, T) of a fold_cuda call."""
    return (feats.shape[0], state_pdf.shape[1], feats.shape[1])


def wide_em(tri):
    """Wide hard EM at the triphone-bench widths: 3 resident passes with
    align_backend="banded" twice (the rerun times each launch of kernels
    A-sac and F with CUDA events), 2 passes with align_backend="xla"
    (full-P scores a few utterances at a time, kernel G, the gather
    branch of accumulate_am_stats), then the narrow route once.  Returns
    the wide banded run's launch counts."""
    import numpy as np
    import torch

    from khg_tpu_torch import kernels
    from khg_tpu_torch.align import banded_kernel
    from khg_tpu_torch.est.mle import MleDiagGmmOptions
    from khg_tpu_torch.gmm import fused_loglikes
    from khg_tpu_torch.model.transition_model import MleTransitionUpdateConfig
    from khg_tpu_torch.recipes import pipeline as pipeline_mod
    from khg_tpu_torch.stats import fold_kernel

    tm, am, graphs, feats = tri
    frames = sum(f.shape[0] for f in feats)
    calls = {}

    def run(backend, align="banded", passes=TRI_PASSES):
        pipe = tri_pipeline(tm, likelihood_backend=backend, align_backend=align)
        base = tri_packed(pipe, graphs)
        model = pipe.pack_model_device(am)
        t0 = time.perf_counter()
        _m, rec = pipe.em_passes_resident(
            model, base, feats, passes, mle_config=MleDiagGmmOptions(),
            transition_cfg=MleTransitionUpdateConfig(),
        )
        secs = time.perf_counter() - t0
        log(f"phase 7 {backend}/{align} (wide={pipe._is_wide()}): {passes} passes "
            f"in {secs:.2f} s ({pipe.counters.wall['align']:.3f} s after packing); "
            f"avg ll {(rec[:, 0] / rec[:, 1]).round(6).tolist()}; failures "
            f"{rec[:, 4].tolist()}")
        return rec, pipe.counters.wall["align"]

    kernels.reset_launch_counts()
    rec0, _w0 = run("xla")
    launches = dict(kernels.LAUNCHES)
    with event_timed(banded_kernel, ("banded_sac_cuda",), calls), \
            event_timed(fold_kernel, ("fold_cuda",), calls, describe=fold_shape):
        rec1, wall1 = run("xla")
    kernels.reset_launch_counts()
    # the banded kernel and G may take different arcs of equal cost (the
    # tids, not the pdfs, differ) and the routes fold in different f32
    # orders, so from the second pass on the models differ and near-ties
    # in the alignment flip: the limit holds the first pass, from the
    # same model
    rec3, _w3 = run("xla", align="xla", passes=2)
    xla_launches = dict(kernels.LAUNCHES)
    # the narrow route: full-P scores of every pdf, inside chip_smoke
    # only; each launch of kernel B timed
    saved = pipeline_mod.EXTERNAL_AC_PDFS
    pipeline_mod.EXTERNAL_AC_PDFS = 1 << 30
    try:
        kernels.reset_launch_counts()
        with event_timed(fused_loglikes, ("loglikes_cuda",), calls,
                         describe=lambda g, m, v, x, *rest: tuple(x.shape)):
            rec2, wall2 = run("pallas")
        narrow = dict(kernels.LAUNCHES)
    finally:
        pipeline_mod.EXTERNAL_AC_PDFS = saved
    log(f"phase 7 launches: wide {launches}; wide, align_backend=xla "
        f"{xla_launches}; narrow {narrow}")
    torch.cuda.synchronize()
    per_pass = {}
    for fn, pairs in calls.items():
        times = [s.elapsed_time(e) for s, e, _shape in pairs]
        per_pass[fn] = sum(times) / TRI_PASSES
        log(f"phase 7 rerun, {fn} per launch (ms, shape): "
            f"{[(round(t, 4), sh[:3]) for t, (_s, _e, sh) in zip(times, pairs)]}")
    pass_ms = wall1 / TRI_PASSES * 1e3
    log(f"phase 7 rerun, per pass: A-sac {per_pass['banded_sac_cuda']:.3f} ms + "
        f"F {per_pass['fold_cuda']:.3f} ms of {pass_ms:.1f} ms wall "
        f"({(per_pass['banded_sac_cuda'] + per_pass['fold_cuda']) / pass_ms:.1%})")
    narrow_ms = wall2 / TRI_PASSES * 1e3
    log(f"phase 7 narrow route, per pass: B {per_pass['loglikes_cuda']:.3f} ms "
        f"of {narrow_ms:.1f} ms wall ({per_pass['loglikes_cuda'] / narrow_ms:.1%}); "
        f"wide {frames * TRI_PASSES / 100.0 / (wall1 or 1.0):.0f} and narrow "
        f"{frames * TRI_PASSES / 100.0 / (wall2 or 1.0):.0f} audio-sec x passes "
        f"per s after packing")
    if rec0[:, 4].any() or rec2[:, 4].any() or rec3[:, 4].any():
        raise AssertionError("phase 7: alignment failures")
    avg = rec0[:, 0] / rec0[:, 1]
    if not (np.diff(avg) >= 0).all():
        raise AssertionError(f"phase 7: avg log-likelihood fell: {avg}")
    for k in ("banded_viterbi_sac", "stats_fold"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the wide path")
    if narrow["fused_loglikes"] <= 0 or narrow["stats_fold"] != 0:
        raise AssertionError("phase 7: the narrow route did not score all pdfs")
    if xla_launches["viterbi"] <= 0 or xla_launches["stats_fold"] != 0:
        raise AssertionError("phase 7: align_backend=xla did not go through "
                             "kernel G and the full-P fold")
    log(f"phase 7 wide run twice: records bit-identical: "
        f"{bool((rec0 == rec1).all())}; max abs diff {float(np.abs(rec0 - rec1).max())}")
    if not (rec0 == rec1).all():
        raise AssertionError("phase 7: a rerun of the wide passes is not bit-identical")
    per_frame = np.abs(rec0[:, [0, 2]] - rec2[:, [0, 2]]) / frames
    log(f"phase 7 wide vs narrow records, per frame: tot_log_like "
        f"{per_frame[:, 0].tolist()}, like_sum {per_frame[:, 1].tolist()}")
    if per_frame.max() > 1e-4 or (rec0[:, [1, 3, 4, 5]] != rec2[:, [1, 3, 4, 5]]).any():
        raise AssertionError(f"phase 7: wide vs narrow records differ by "
                             f"{per_frame.max()} per frame, or counts differ")
    per_frame = np.abs(rec0[:2, [0, 2]] - rec3[:, [0, 2]]) / frames
    log(f"phase 7 banded vs align_backend=xla records, per frame: tot_log_like "
        f"{per_frame[:, 0].tolist()}, like_sum {per_frame[:, 1].tolist()} "
        f"(limit on pass 1); transition objf {rec0[:2, 6].tolist()} vs "
        f"{rec3[:, 6].tolist()}")
    if per_frame[0].max() > 1e-4 or (rec0[:2, [1, 3, 4, 5]] != rec3[:, [1, 3, 4, 5]]).any():
        raise AssertionError(f"phase 7: banded vs align_backend=xla records differ "
                             f"by {per_frame.max()} per frame, or counts differ")
    return launches


# ------------------------------------------------------------------ phase 8

HELD_OUT = 256
HELD_OUT_SEED = 1011
# the dense decode's utterances, and its cost tolerance against the
# lattice decoder's best path (relative, as khg_tpu's tests/test_decode.py)
DENSE_UTTS = 16
DENSE_RTOL = 1e-3
MAX_WER = 5.0
# kernel B against its plain version on the card, over every held-out
# score, two ways: max |kernel - plain| <= PLAIN_RTOL * max |plain
# score| (scores reach ~2e4; the two f32 orders of summation left
# 1.2e-4 and 2.4e-4 on phase 4's models); and at each (frame, pdf),
# |kernel - plain| <= TERMS_RTOL * the sum of the magnitudes of the
# terms the score adds (score_terms): two f32 sums of n = 2D + 1 terms
# differ by at most ~2n 2^-24 (5.6e-6 at D = 23) of it, and the
# logsumexp over components is 1-Lipschitz, so a correct kernel always
# passes, while a small constant error shows at the pdfs that match well
PLAIN_RTOL = 1e-6
TERMS_RTOL = 1e-5


def make_held_out(wav_dir: Path, train_seqs):
    """HELD_OUT spoken-digit WAVs from their own seed, with digit
    sequences outside the training corpus, written by the runner's
    stage-0 worker function, in this process: on an H100 machine's 8
    cores a spawn pool took 10.9 s (each worker imports torch), this
    process ~7 s."""
    import numpy as np

    from khg_tpu_torch.egs.audiomnist_10k import synth_chunk
    from khg_tpu_torch.recipes.audiomnist import DIGITS, load_audiomnist_corpus

    taken = {tuple(DIGITS.index(w) for w in words) for words in train_seqs}
    rng = np.random.default_rng(HELD_OUT_SEED)
    seqs = []
    while len(seqs) < HELD_OUT:
        digits = tuple(int(rng.integers(10)) for _ in range(int(rng.integers(3, 8))))
        if digits not in taken:
            taken.add(digits)
            seqs.append(digits)
    wav_dir.mkdir()
    synth_chunk((str(wav_dir), seqs, HELD_OUT_SEED + 1))
    return load_audiomnist_corpus(wav_dir)


@contextlib.contextmanager
def plain_scoring():
    """While inside, loglikes_fused runs its plain version on the card."""
    from khg_tpu_torch.gmm import fused_loglikes

    saved = fused_loglikes.loglikes_fused
    fused_loglikes.loglikes_fused = fused_loglikes.loglikes_plain
    try:
        yield
    finally:
        fused_loglikes.loglikes_fused = saved


def score_terms(am, feats_list):
    """Per utterance, (T, P): the largest, over the pdf's real
    components, of |gconst| + sum_d |A_kd x2_td| (A = [mu/var, -1/(2
    var)], x2 = [x, x^2]): the magnitude of the terms a score sums."""
    import torch

    from khg_tpu_torch.utils.convert import model_to_torch

    pm = am.pack(mix_pad_to=8)
    g, m, v = model_to_torch(pm.gconsts, pm.means_invvars, pm.inv_vars, device=DEVICE)
    P, K, D = m.shape
    A = torch.cat([m, 0.5 * v], -1).abs().reshape(P * K, 2 * D)
    ga = torch.where(torch.isfinite(g), g.abs(), 0.0).reshape(P * K)
    out = []
    for f in feats_list:
        x = torch.as_tensor(f, device=DEVICE)
        x2 = torch.cat([x, x * x], -1).abs()
        out.append((x2 @ A.T + ga).reshape(-1, P, K).amax(-1))
    return out


def words_of(out):
    return [d[2] for d in out.decoded]


def held_out_decode(res, lp, cfg, corpus, tmp: Path, results):
    """Stage 3 of the corpus recipe on the card, from phase 4's model:
    HELD_OUT new WAVs -> fbank (kernel C) -> the unigram digit HCLG ->
    score_held_out (kernel B, one launch per bucket) -> decode_held_out
    (native lattice decoder, threaded, f32 streamed fetch) -> WER; and
    decode_dense (kernel G, generic route) on the first DENSE_UTTS.
    Launch counts are set to 0 just before and read just after.  Then:
    the same utterances scored by B's plain version on the card, and
    fetched in float16, must decode to identical words; G at the HCLG's
    shape is held to its plain version and timed.  Returns phase 8's
    launch counts."""
    import numpy as np
    import torch

    from khg_tpu_torch import kernels
    from khg_tpu_torch.align.packed import pack_graph, pack_graph_batch
    from khg_tpu_torch.align.viterbi_kernel import viterbi_cuda, viterbi_plain, viterbi_plan
    from khg_tpu_torch.decode.decoder import decode_dense
    from khg_tpu_torch.decode.score_stream import stream_scores
    from khg_tpu_torch.egs.audiomnist_10k import build_decoder, decode_held_out, score_held_out
    from khg_tpu_torch.gmm import fused_loglikes
    from khg_tpu_torch.recipes.yesno_wav import extract_features
    from khg_tpu_torch.utils.convert import batched_graphs_to_torch

    am, tm, tree = res.am, res.transition_model, res.tree
    id2pdf = tm.id2pdf_array()
    t0 = time.perf_counter()
    held = make_held_out(tmp / "held_out", corpus.word_seqs)
    synth_s = time.perf_counter() - t0
    refs, ids = held.word_seqs, held.utt_ids

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    feats = extract_features(held, cfg, device=DEVICE).feats
    fbank_s = time.perf_counter() - t0
    audio_sec = sum(f.shape[0] for f in feats) / 100.0
    t0 = time.perf_counter()
    decoder = build_decoder(lp, tm, tree)
    hclg_s = time.perf_counter() - t0
    hclg = decoder.fst
    in_degree = np.bincount([a.nextstate for arcs in hclg.arcs for a in arcs],
                            minlength=hclg.num_states)
    packed = pack_graph_batch([pack_graph(hclg, id2pdf)])
    _, S, M = packed.in_src.shape
    log(f"phase 8: {HELD_OUT} held-out WAVs ({audio_sec:.1f} audio-sec, seed "
        f"{HELD_OUT_SEED}, none in the training corpus) synthesised in {synth_s:.1f} s; "
        f"fbank {fbank_s:.2f} s")
    log(f"phase 8 HCLG: {hclg.num_states} states, {hclg.num_arcs} arcs, largest "
        f"in-degree {int(in_degree.max())}; packed for the dense decode: S={S}, "
        f"M={M} ({viterbi_plan(S, M)[0]} route of kernel G); built in {hclg_s:.3f} s")
    calls = {}
    with event_timed(fused_loglikes, ["loglikes_cuda"], calls,
                     describe=lambda g, m, v, x, *r: tuple(x.shape)):
        t0 = time.perf_counter()
        scores = score_held_out(am, feats, DEVICE)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
    wrapper_ms = [s.elapsed_time(e) for s, e, _ in calls["loglikes_cuda"]]
    # B's bound over phase 8's launches, real components only (as
    # check_loglikes counts it): rows in, the packed model, scores out
    K = am.pack(mix_pad_to=8).gconsts.shape[1]
    P, real, D = am.num_pdfs, am.num_gauss, am.dim
    score_bound_ms = sum(
        bound(N * D * 4 + P * K * (2 * D + 1) * 4 + N * P * 4,
              2 * N * real * 2 * D + 3 * N * real, FP32_OPS_PER_S)[0]
        for N in (r * t for (r, t, _d) in (c[2] for c in calls["loglikes_cuda"])))
    t0 = time.perf_counter()
    nbytes = sum(a.nbytes for a in stream_scores(scores))
    transfer_s = time.perf_counter() - t0
    out = decode_held_out(lp, tm, tree, scores, ids, refs, decoder=decoder)
    dense = []
    t0 = time.perf_counter()
    for u in range(DENSE_UTTS):
        dense.append(decode_dense(hclg, scores[u], id2pdf, acoustic_scale=2.0,
                                  device=DEVICE))
    dense_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    log(f"phase 8 HCLG build: {hclg_s:.3f} s")
    log(f"phase 8 score: {len(wrapper_ms)} launches of kernel B (P={P}, K={K}, {real} "
        f"real components, D={D}); the wrapper {sum(wrapper_ms):.3f} ms by CUDA "
        f"events around each call "
        f"({', '.join(f'{s}: {ms:.3f}' for (_, _, s), ms in zip(calls['loglikes_cuda'], wrapper_ms))}); "
        f"wall {score_s:.3f} s")
    log(f"phase 8 transfer: {nbytes / 1e6:.2f} MB of f32 scores streamed to the host "
        f"in {transfer_s:.3f} s")
    log(f"phase 8 decode: {out.decode_s:.3f} s wall (native, threaded, f32 fetch)")
    stage_s = hclg_s + score_s + out.decode_s
    log(f"phase 8 stage 3: {stage_s:.3f} s for {audio_sec:.1f} audio-sec "
        f"({audio_sec / stage_s:.0f} audio-sec/s); WER {out.wer:.2f}%")
    log(f"phase 8 dense decode: {DENSE_UTTS} utterances in {dense_s:.3f} s")
    log(f"phase 8 launches: B {launches['fused_loglikes']}, G {launches['viterbi']}; "
        f"all {launches}")
    log(out.report.splitlines()[0])

    if out.wer > MAX_WER:
        raise AssertionError(f"phase 8: WER {out.wer:.2f}% > {MAX_WER}%")
    if not all(d[0] for d in out.decoded):
        raise AssertionError("phase 8: an utterance failed to decode")
    for s, f in zip(scores, feats):
        if s.shape != (f.shape[0], am.num_pdfs) or not torch.isfinite(s).all():
            raise AssertionError(f"phase 8: bad scores {tuple(s.shape)}")
    for k in ("fused_loglikes", "viterbi"):
        if launches[k] <= 0:
            raise AssertionError(f"phase 8: kernel {k} never launched")

    with plain_scoring():
        plain = score_held_out(am, feats, DEVICE)
    diff = max(float((a - b).abs().max()) for a, b in zip(scores, plain))
    magnitude = max(float(b.abs().max()) for b in plain)
    limit = PLAIN_RTOL * magnitude
    terms_ratio = max(float(((a - b).abs() / t).max())
                      for a, b, t in zip(scores, plain, score_terms(am, feats)))
    out_plain = decode_held_out(lp, tm, tree, plain, ids, refs, decoder=decoder)
    same_plain = words_of(out_plain) == words_of(out)
    out16 = decode_held_out(lp, tm, tree, scores, ids, refs, decoder=decoder,
                            fetch_dtype="float16")
    same16 = words_of(out16) == words_of(out)
    log(f"phase 8 kernel B vs its plain version on the card: max |diff| of the "
        f"scores {diff:.3e} (limit {PLAIN_RTOL:g} x max |score| {magnitude:.1f} = "
        f"{limit:.3e}); at each (frame, pdf) at most {terms_ratio:.2e} of the "
        f"magnitude of the score's terms (limit {TERMS_RTOL:g}); words identical "
        f"for every utterance: {same_plain}")
    log(f"phase 8 float16 fetch: words identical for every utterance: {same16}")
    if not diff <= limit:
        raise AssertionError(f"phase 8: kernel B off its plain version by {diff} > {limit}")
    if not terms_ratio <= TERMS_RTOL:
        raise AssertionError(f"phase 8: kernel B off its plain version by {terms_ratio} "
                             f"of the score's terms > {TERMS_RTOL}")
    if not same_plain:
        raise AssertionError("phase 8: kernel- and plain-scored words differ")
    if not same16:
        raise AssertionError("phase 8: the float16 fetch changed words")
    worst = 0.0
    for u, d in enumerate(dense):
        ok, _tids, words, like = out.decoded[u]
        if d is None or d[1] != words:
            raise AssertionError(f"phase 8: decode_dense words differ on utterance {u}")
        worst = max(worst, abs(d[2] + like) / abs(like))
    log(f"phase 8 decode_dense vs the lattice best path: words equal on "
        f"{DENSE_UTTS} utterances; cost within {worst:.2e} relative")
    if worst > DENSE_RTOL:
        raise AssertionError(f"phase 8: decode_dense cost off by {worst} relative")

    # G at the HCLG's shape (B = 1), against its plain version, timed
    g = batched_graphs_to_torch(packed, DEVICE)
    ll = scores[0][None].contiguous()
    T, P = ll.shape[1], ll.shape[2]
    nf = torch.tensor([T], dtype=torch.int32, device=DEVICE)
    tk, ck = viterbi_cuda(g, ll, nf, 2.0)
    tp, cp = viterbi_plain(g, ll, nf, 2.0)
    torch.cuda.synchronize()
    if not (torch.equal(ck, cp) and torch.equal(tk, tp)):
        raise AssertionError("phase 8: kernel G at the HCLG shape differs from its plain version")
    ms = time_ms(lambda: viterbi_cuda(g, ll, nf, 2.0), reps=20)
    plain_ms = time_ms(lambda: viterbi_plain(g, ll, nf, 2.0), reps=2)
    serial_ms, chain = serial_bound(T, M, S)
    plan = viterbi_plan(S, M)
    results["viterbi"][f"hclg_s{S}_m{M}"] = dict(
        B=1, S=S, M=M, T=T, P=P, max_frames=T, plan=[plan[0], str(plan[1]), plan[2]],
        ms=ms, plain_ms=plain_ms, us_per_frame=ms / T * 1e3,
        serial_bound_ms=serial_ms, serial_chain=chain, phase8_launches=launches["viterbi"],
    )
    # B's own device time at phase 8's shapes, from a profiler trace of
    # whole scoring calls (the events above also hold the wrapper's
    # preparation launches and the host's gaps between them)
    trace = device_trace_ms(lambda: score_held_out(am, feats, DEVICE), 5)
    kernel_ms = sum(ms for k, ms in trace.items() if "fused_loglikes_kernel" in k) or None
    share = f"{score_bound_ms / kernel_ms:.1%} of bound" if kernel_ms else "not measured"
    top = sorted(trace.items(), key=lambda kv: -kv[1])[:6]
    log(f"phase 8 score, device trace of a scoring call: kernel B "
        f"{kernel_ms or float('nan'):.4f} ms for its {len(wrapper_ms)} launches (bound "
        f"{score_bound_ms:.4f} ms, {share}); every device op "
        f"{sum(trace.values()):.4f} ms; largest: "
        + "; ".join(f"{k[:60]} {ms:.4f}" for k, ms in top))
    b = results["fused_loglikes"]
    b["phase8"] = dict(launches=launches["fused_loglikes"], kernel_ms=kernel_ms,
                       wrapper_ms=wrapper_ms, device_ms_all=sum(trace.values()),
                       shapes=[list(s) for _, _, s in calls["loglikes_cuda"]],
                       P=P, K=K, real_components=real, bound_ms=score_bound_ms,
                       plain_max_abs_diff=diff, plain_max_abs_score=magnitude,
                       plain_limit=limit, plain_rtol=PLAIN_RTOL,
                       plain_terms_ratio=terms_ratio, plain_terms_rtol=TERMS_RTOL)
    log(f"kernel G viterbi at the HCLG: B=1 T={T} S={S} M={M} P={P} ({plan[0]}, "
        f"{plan[1]} backpointers): bit-equal; {ms:.3f} ms, {ms / T * 1e3:.3f} us per "
        f"frame (plain {plain_ms:.1f} ms, serial bound {serial_ms:.4f} ms: {chain})")
    return launches


# ------------------------------------------------------------------ phase 9

YESNO_MAX_WER = 25.0


@contextlib.contextmanager
def counted_alignments():
    """While inside, every EStepPipeline.align_and_accumulate call adds
    its failures and utterances to the yielded dict."""
    from khg_tpu_torch.recipes.pipeline import EStepPipeline

    seen = {"calls": 0, "utts": 0, "failed": 0}
    real = EStepPipeline.align_and_accumulate

    def spy(self, am, packed, feats, *a, **k):
        out = real(self, am, packed, feats, *a, **k)
        seen["calls"] += 1
        seen["utts"] += len(feats)
        seen["failed"] += out.num_error
        return out

    EStepPipeline.align_and_accumulate = spy
    try:
        yield seen
    finally:
        EStepPipeline.align_and_accumulate = real


def fbank_fused_plain(waves, cfg):
    """fbank_fused with kernel C's plain version, on the card."""
    import torch

    from khg_tpu_torch.features.fbank import num_frames
    from khg_tpu_torch.features.fbank_kernel import _padded_wave, fbank_plain

    T = num_frames(cfg, waves.shape[-1])
    feats, energy = fbank_plain(_padded_wave(waves, cfg, T), cfg, T)
    return torch.cat([energy[..., None], feats], -1) if cfg.use_energy else feats


def yesno_recipe(tmp: Path, results):
    """egs/yesno_wav/run.py's recipe on the card through the port's
    runner (khg_tpu_torch.egs.yesno_wav), in this process, at run.py's
    defaults: 60 synthesized WAVs (30/30 split), 23 mel bins, 300
    Gaussians, 30 passes on train_yesno's realign schedule; then again
    from the same WAVs with --speed-perturb (90 training utterances).
    Launch counts are set to 0 just before the first run and read just
    after the second.  Then: C on the speed-perturbed training waves
    against its plain version (1e-3; blocks with a third TF32 part take
    the sixth product), MFCC + deltas over the 60 WAVs on C against the
    plain version (C's 1e-3 carried through the lifted DCT and the delta
    taps), B's test-half scores against its plain version (phase 8's
    PLAIN_RTOL and TERMS_RTOL), one align_and_accumulate batch on G
    against G's plain version (tids equal, costs bit-equal)."""
    import numpy as np
    import torch

    from khg_tpu_torch import kernels
    from khg_tpu_torch.align import viterbi_kernel
    from khg_tpu_torch.data.wav import read_wav
    from khg_tpu_torch.egs import yesno_wav as runner
    from khg_tpu_torch.egs.audiomnist_10k import score_held_out
    from khg_tpu_torch.features import mfcc
    from khg_tpu_torch.features.delta import DeltaConfig, delta_scales
    from khg_tpu_torch.features.fbank import FbankConfig
    from khg_tpu_torch.features.fbank_kernel import FRAMES
    from khg_tpu_torch.features.mfcc import MfccConfig, lifted_dct_matrix
    from khg_tpu_torch.features.resample import speed_perturb_corpus
    from khg_tpu_torch.recipes.pipeline import EStepPipeline
    from khg_tpu_torch.recipes.yesno_wav import extract_features, load_yesno_corpus

    plain_dir, sp_dir = tmp / "yesno_wav", tmp / "yesno_wav_sp"
    kernels.reset_launch_counts()
    with counted_alignments() as seen:
        t0 = time.perf_counter()
        out = runner.main(["--exp-dir", str(plain_dir), "--device", DEVICE])
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_sp = runner.main(["--exp-dir", str(sp_dir), "--device", DEVICE,
                              "--waves-dir", str(plain_dir / "waves"),
                              "--speed-perturb"])
        sp_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name, o, wall in (("plain", out, plain_s), ("speed-perturbed", out_sp, sp_s)):
        ll = o["train"].avg_loglikes
        log(f"phase 9 yesno_wav {name}: {o['num_train']} training utterances, "
            f"{len(ll) - 1} passes, {o['train'].info['number_of_gaussians']} "
            f"Gaussians; avg log-like {ll[0]:.3f} -> {ll[-1]:.3f}; "
            f"{o['decode'].report.splitlines()[0]}; {wall:.2f} s wall; stages (s): "
            + ", ".join(f"{k} {v:.3f}" for k, v in o["timings"].items()))
    log(f"phase 9 realignments: {seen['calls']} align_and_accumulate calls over "
        f"{seen['utts']} utterances, {seen['failed']} failed")
    log(f"phase 9 launches: C {launches['fbank']}, G {launches['viterbi']}, "
        f"B {launches['fused_loglikes']}; all {launches}")
    for name, o in (("plain", out), ("speed-perturbed", out_sp)):
        ll = o["train"].avg_loglikes
        if not ll[-1] > ll[0] + 1.0 or not all(np.isfinite(ll)):
            raise AssertionError(f"phase 9 {name}: avg log-likelihood did not rise: {ll}")
        if o["decode"].wer > YESNO_MAX_WER:
            raise AssertionError(f"phase 9 {name}: test WER {o['decode'].wer:.2f}% > "
                                 f"{YESNO_MAX_WER}%")
    if out_sp["num_train"] != 90 or out["num_train"] != 30:
        raise AssertionError("phase 9: training sets are not 30 and 90 utterances")
    if seen["failed"] or not seen["calls"]:
        raise AssertionError(f"phase 9: {seen['failed']} alignment failures in "
                             f"{seen['calls']} realignments")
    for k in ("fbank", "viterbi", "fused_loglikes"):
        if launches[k] <= 0:
            raise AssertionError(f"phase 9: kernel {k} never launched")

    # C on the speed-perturbed training waves (non-integer samples), padded
    # to one length as extract_features pads a bucket
    cfg = FbankConfig(sample_rate=8000, num_mel_bins=23)
    corpus = load_yesno_corpus(plain_dir / "waves")
    train = [read_wav(p)[0] for p in corpus.wav_paths[:30]]
    sp_waves, _src = speed_perturb_corpus(train, 8000, device=DEVICE)
    n = max(map(len, sp_waves))
    rows = np.stack([np.pad(w, (0, n - len(w)), mode="symmetric")
                     for w in sp_waves]).astype(np.float32)
    padded, T, err, err_e, ms, plain_ms, lo_frames = fbank_case(rows, cfg, reps=10)
    lo_blocks = sixth_product(padded, cfg, T)[0]
    blocks = len(rows) * -(-T // FRAMES)
    b_ms, b_by = fbank_bound(cfg, len(rows), T, n, lo_frames)
    log(f"phase 9 kernel C on the speed-perturbed training waves: B={len(rows)} "
        f"T={T} ({lo_blocks} of {blocks} blocks, {lo_frames} of {len(rows) * T} "
        f"frames, take the sixth product): err "
        f"{err:.2e} (energy {err_e:.2e}), limit 1e-3; {ms:.4f} ms (plain "
        f"{plain_ms:.3f}, bound {b_ms:.4f} {b_by})")
    if lo_blocks <= 0:
        raise AssertionError("phase 9: no block of the perturbed waves took the sixth product")

    # MFCC + deltas over the 60 WAVs: C against its plain version
    mcfg = MfccConfig(fbank=cfg)
    dcfg = DeltaConfig(order=2)
    got = extract_features(load_yesno_corpus(plain_dir / "waves"), cfg,
                           feature_type="mfcc", delta_order=2, device=DEVICE).feats
    saved = mfcc.fbank_fused
    mfcc.fbank_fused = fbank_fused_plain
    try:
        ref = extract_features(load_yesno_corpus(plain_dir / "waves"), cfg,
                               feature_type="mfcc", delta_order=2, device=DEVICE).feats
    finally:
        mfcc.fbank_fused = saved
    dct_l1 = float(np.abs(lifted_dct_matrix(mcfg)).sum(0).max())
    taps_l1 = max(float(np.abs(t).sum()) for t in delta_scales(dcfg))
    mfcc_limit = 1e-3 * dct_l1 * taps_l1
    mfcc_err = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    log(f"phase 9 MFCC + deltas (39 dims) over {len(got)} WAVs on kernel C vs its "
        f"plain version: max |diff| {mfcc_err:.3e}, limit {mfcc_limit:.3e} (1e-3 x "
        f"lifted-DCT row L1 {dct_l1:.3f} x delta taps L1 {taps_l1:.3f})")
    if not mfcc_err <= mfcc_limit or any(a.shape != b.shape or a.shape[1] != 39
                                         for a, b in zip(got, ref)):
        raise AssertionError(f"phase 9: MFCC + deltas off by {mfcc_err} > {mfcc_limit}")

    # B on the test half, from the plain run's final model
    with open(plain_dir / "feats.pkl", "rb") as f:
        feats = pickle.load(f)["corpus"].feats
    test = [feats[i] for i in out["test_ids"]]
    am = out["train"].am
    scores = score_held_out(am, test, DEVICE)
    with plain_scoring():
        plain = score_held_out(am, test, DEVICE)
    diff = max(float((a - b).abs().max()) for a, b in zip(scores, plain))
    magnitude = max(float(b.abs().max()) for b in plain)
    terms_ratio = max(float(((a - b).abs() / t).max())
                      for a, b, t in zip(scores, plain, score_terms(am, test)))
    log(f"phase 9 kernel B vs its plain version on the test half: max |diff| "
        f"{diff:.3e} (limit {PLAIN_RTOL:g} x {magnitude:.1f}); at most "
        f"{terms_ratio:.2e} of the terms' magnitude (limit {TERMS_RTOL:g})")
    if not diff <= PLAIN_RTOL * magnitude or not terms_ratio <= TERMS_RTOL:
        raise AssertionError(f"phase 9: kernel B off its plain version ({diff}, "
                             f"{terms_ratio})")

    # one align_and_accumulate batch on G against G's plain version
    res = out["train"]
    pipe = EStepPipeline(res.transition_model, acoustic_scale=0.1,
                         self_loop_scale=0.1, device=DEVICE)
    packed = pipe.pack_graphs(res.graphs)
    train_feats = feats[:30]
    idx = sorted(range(30), key=lambda i: train_feats[i].shape[0])
    gconsts, miv, iv = pipe._pack_model(res.am)
    bfeats, lens, _bt = pipe._batch_feats(idx, train_feats)
    graphs, banded, _sp = pipe._batch_graphs(idx, packed)
    kernel_res, _, _ = pipe._align_batch(gconsts, miv, iv, bfeats, lens, graphs, banded)
    saved = viterbi_kernel.viterbi_cuda
    viterbi_kernel.viterbi_cuda = viterbi_kernel.viterbi_plain
    try:
        plain_res, _, _ = pipe._align_batch(gconsts, miv, iv, bfeats, lens, graphs,
                                            banded)
    finally:
        viterbi_kernel.viterbi_cuda = saved
    torch.cuda.synchronize()
    tids_equal = torch.equal(kernel_res.tids, plain_res.tids)
    cost_equal = torch.equal(kernel_res.total_cost, plain_res.total_cost)
    B, S, M = graphs.in_src.shape
    log(f"phase 9 kernel G on one align_and_accumulate batch (B={B}, T="
        f"{bfeats.shape[1]}, S={S}, M={M}, {viterbi_kernel.viterbi_plan(S, M)[0]} "
        f"route) vs its plain version: tids equal {tids_equal}, costs bit-equal "
        f"{cost_equal}")
    if not (tids_equal and cost_equal):
        raise AssertionError("phase 9: kernel G differs from its plain version")

    results["fbank"]["phase9"] = dict(
        launches=launches["fbank"], speed_perturbed=dict(
            B=len(rows), T=T, max_abs_err=err, energy_max_abs_err=err_e, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            lo_product_blocks=lo_blocks, blocks=blocks, lo_product_frames=lo_frames),
        mfcc_deltas=dict(max_abs_err=mfcc_err, limit=mfcc_limit))
    results["viterbi"]["phase9"] = dict(launches=launches["viterbi"], B=B, S=S, M=M,
                                        bit_equal=True)
    results["fused_loglikes"]["phase9"] = dict(
        launches=launches["fused_loglikes"], plain_max_abs_diff=diff,
        plain_terms_ratio=terms_ratio)
    return launches


# ----------------------------------------------------------------- phase 10

CTC_PASSES = 8
CTC_MIXUP = 1000
CTC_MIXUP_PASS = 4


@contextlib.contextmanager
def ctc_records():
    """While inside, collects the CTC trainer's per-pass log records
    ((pass, avg loglike, frames, seconds)) and alignment failures, and
    keeps the last Viterbi batch (graphs, loglikes, num_frames)."""
    import logging

    from khg_tpu_torch.recipes import ctc_train

    seen = {"passes": [], "failed": 0, "batch": None}

    class Handler(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("CTC EM pass"):
                seen["passes"].append(record.args)
            elif "failed to align" in record.msg:
                seen["failed"] += record.args[1]

    real = ctc_train.viterbi_align_batch

    def spy(graphs, ll, lens, *a, **k):
        seen["batch"] = (graphs, ll, lens)
        return real(graphs, ll, lens, *a, **k)

    logger = logging.getLogger(ctc_train.__name__)
    handler, level = Handler(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    ctc_train.viterbi_align_batch = spy
    try:
        yield seen
    finally:
        ctc_train.viterbi_align_batch = real
        logger.removeHandler(handler)
        logger.setLevel(level)


def ctc_phase(tmp: Path, corpus, feats):
    """Phase 10: (a) the port's CTC runner at tests/test_ctc_train.py's
    arguments, then stage 2 again from its artifacts; (b) CTC training
    at full width (BASELINE config #4) on phase 4's 1,024 fbank
    utterances: each utterance's tokens are the letter-phones of its
    digit words under the digit lexicon (1..V-1, blank 0), 8 passes,
    mix-up toward 1,000 Gaussians at pass 4, all utterances in one
    batch.  Launch counts are set to 0 just before each and read just
    after.  Returns (a)'s and (b)'s launch counts."""
    import numpy as np
    import torch

    from khg_tpu_torch import kernels
    from khg_tpu_torch.align.viterbi_kernel import viterbi_cuda, viterbi_plain
    from khg_tpu_torch.egs import ctc_synth
    from khg_tpu_torch.recipes.audiomnist import digits_lexicon
    from khg_tpu_torch.recipes.ctc_train import train_ctc_gmm

    args = ["--exp-dir", str(tmp / "ctc_synth"), "--num-train", "24",
            "--num-test", "6", "--num-passes", "8", "--device", DEVICE]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = ctc_synth.main(args)
    again = ctc_synth.main(args + ["--stage", "2"])
    runner_s = time.perf_counter() - t0
    runner_launches = dict(kernels.LAUNCHES)
    log(f"phase 10 ctc_synth runner: WER {out['wer']:.2f}%, stage-2 re-entry WER "
        f"{again['wer']:.2f}%, {runner_s:.2f} s; avg log-likes "
        f"{[round(x, 4) for x in out['history']]}; launches G "
        f"{runner_launches['viterbi']}, B {runner_launches['fused_loglikes']}")
    if out["wer"] != 0.0 or again["wer"] != out["wer"]:
        raise AssertionError(f"phase 10: runner WER {out['wer']} / re-entry {again['wer']}")

    lexicon = digits_lexicon()
    phones = [[p for w in words for p in lexicon[w][0].split()]
              for words in corpus.word_seqs]
    symbols = sorted({p for seq in phones for p in seq})
    vocab = len(symbols) + 1
    token = {p: i + 1 for i, p in enumerate(symbols)}
    tokens = [[token[p] for p in seq] for seq in phones]
    frames = sum(f.shape[0] for f in feats)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with ctc_records() as seen:
        t0 = time.perf_counter()
        am, history, hyps = train_ctc_gmm(
            feats, tokens, vocab, num_passes=CTC_PASSES, mixup=CTC_MIXUP,
            mixup_pass=CTC_MIXUP_PASS, seed=SEED, device=DEVICE,
        )
        train_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    pass_s = [round(float(r[3]), 3) for r in seen["passes"]]
    recovered = sum(h == t for h, t in zip(hyps, tokens)) / len(tokens)
    log(f"phase 10 full-width CTC: {len(feats)} utterances, {frames} frames, V={vocab} "
        f"(blank + {len(symbols)} letter-phones), up to {max(map(len, tokens))} tokens; "
        f"{CTC_PASSES} passes in {train_s:.2f} s, per pass {pass_s} s; "
        f"{am.num_gauss} Gaussians; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"phase 10 avg log-likes: {[round(x, 5) for x in history]}; alignment failures "
        f"after pass 0: {seen['failed']}; collapsed final alignment = tokens for "
        f"{recovered:.2%} of utterances; launches G {launches['viterbi']}, B "
        f"{launches['fused_loglikes']}")
    drops = [b - a for a, b in zip(history, history[1:])]
    if min(drops) < -1e-3 or not history[-1] > history[0]:
        raise AssertionError(f"phase 10: CTC history not monotone: {history}")
    if seen["failed"]:
        raise AssertionError(f"phase 10: {seen['failed']} alignment failures")
    if launches["viterbi"] != CTC_PASSES - 1:
        raise AssertionError(f"phase 10: G launched {launches['viterbi']} times, "
                             f"not once a pass after pass 0")
    graphs, ll, lens = seen["batch"]
    tids, cost = viterbi_cuda(graphs, ll, lens.to(torch.int32), 1.0)
    ptids, pcost = viterbi_plain(graphs, ll, lens, 1.0)
    cost_equal = bool(torch.equal(cost, pcost))
    log(f"phase 10 kernel G on the last pass's batch (B={ll.shape[0]}, T={ll.shape[1]}, "
        f"S={graphs.in_src.shape[1]}, M={graphs.in_src.shape[2]}): costs bit-equal to its "
        f"plain version {cost_equal}; tids equal {bool(torch.equal(tids, ptids))}")
    if not cost_equal:
        raise AssertionError("phase 10: kernel G's costs differ from its plain version")
    return runner_launches, launches


# ----------------------------------------------------------------- phase 11

DP_PASSES = 2
DP_RTOL = 1e-5


def dp_pipeline(tm, self_loop_scale=0.1, device=None):
    """Phase 5's pipeline (phase 6's with self_loop_scale=1.0) on
    ``device`` (None: DEVICE)."""
    from khg_tpu_torch.recipes.pipeline import EStepPipeline

    return EStepPipeline(
        copy.deepcopy(tm), acoustic_scale=0.1, self_loop_scale=self_loop_scale,
        batch_size=256, mix_pad_multiple=8, states_pad_multiple=256,
        frames_pad_multiple=256, align_backend="banded", device=device or DEVICE,
    )


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dp_loop_passes(mesh, pipe, model, batches, passes, fb=False):
    """``passes`` fold/finish rounds of the sharded resident loop over
    ``batches`` (this rank's share of pipe.device_batches): returns
    (model, logp, packets, reduction seconds per pass).  The reduction
    is timed on one extra call of the loops' reduction (one all-reduce
    of the pass's carry and compensation, then carry - comp), outside
    finish (which makes its own)."""
    import numpy as np
    import torch

    from khg_tpu_torch.est.mle import MleDiagGmmOptions
    from khg_tpu_torch.model.transition_device import build_transition_struct
    from khg_tpu_torch.parallel import mesh as M

    P, K = model[0].shape
    struct = build_transition_struct(pipe.tm)
    make = M.sharded_resident_fb_em_loop if fb else M.sharded_resident_em_loop
    loop = make(mesh, P, K, model[1].shape[-1], struct.num_tids, struct,
                acoustic_scale=pipe.acoustic_scale,
                transition_scale=pipe.transition_scale,
                self_loop_scale=pipe.self_loop_scale, uniform_dest_pdf=fb,
                mle_config=MleDiagGmmOptions())
    logp = torch.as_tensor(np.asarray(pipe.tm.log_probs, np.float32), device=mesh.device)
    delta = loop.delta(logp)
    packets, reduce_s = [], []
    for _ in range(passes):
        carry, comp = loop.make_carry()
        for bfeats, lens, graphs, banded, state_pdf in batches:
            if fb and banded is None and state_pdf is None:
                raise AssertionError("phase 11: a dense FB batch is not destination-uniform")
            tables, offsets = banded if banded is not None else (graphs, None)
            args = (bfeats, lens) if fb else (bfeats, lens, pipe._id2pdf_t)
            carry, comp = loop.fold(model, delta, carry, comp, tables, *args,
                                    offsets=offsets)
        _sync(mesh.device)
        t0 = time.perf_counter()
        total = M._reduce_carry(mesh, carry, comp)
        _sync(mesh.device)
        reduce_s.append(time.perf_counter() - t0)
        del total
        model, logp, delta, packet = loop.finish(model, carry, comp, logp)
        packets.append(packet.cpu().numpy().astype(np.float64))
    return model, logp, np.stack(packets), reduce_s


def _dp_rank(rank, world, store, data_path, out_dir, device):
    """One rank of phase 11(b): joins the gloo group, folds its share of
    the batches (every world-th, from its rank) for DP_PASSES passes
    and writes the packets and the final model."""
    import numpy as np

    sys.path.insert(0, str(ROOT))
    from khg_tpu_torch.parallel import multihost

    from khg_tpu_torch import kernels

    multihost.initialize(f"file://{store}", world, rank, backend="gloo")
    with open(data_path, "rb") as f:
        tm, am, base, feats = pickle.load(f)
    mesh = multihost.global_data_mesh(devices=[device] * world)
    pipe = dp_pipeline(tm, device=device)
    batches = pipe.device_batches(base, feats)[rank::world]
    model = pipe.pack_model_device(am)
    kernels.reset_launch_counts()
    model, logp, packets, reduce_s = dp_loop_passes(mesh, pipe, model, batches,
                                                    DP_PASSES)
    np.savez(Path(out_dir) / f"rank{rank}.npz", packets=packets,
             launches=json.dumps(dict(kernels.LAUNCHES)),
             logp=logp.cpu().numpy(), reduce_s=np.array(reduce_s),
             **{f"m{i}": x.cpu().numpy() for i, x in enumerate(model)})
    import torch.distributed as dist

    dist.destroy_process_group()


def _close(a, b, rtol=DP_RTOL, atol=DP_RTOL):
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return bool(np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
                and (np.isinf(a) == np.isinf(b)).all())


def data_parallel(tmp: Path, res, graphs, feats, tri):
    """Phase 11: data-parallel EM on phase 4's corpus and model at the
    audiomnist_10k widths (batches of 256).

    (a) World size 1 on NCCL, in this process: the sharded resident loop
    (2 passes, banded route) against em_passes_resident from the same
    state (model within 1e-5, per-frame log-likelihood within 1e-5);
    the sharded Baum-Welch loop (1 pass) against fb_em_passes_resident
    (phase 6's 1e-4 per frame); sharded_em_step with per_state=True on
    phase 7's first wide batch against the pipeline's step on it.
    (b) Two ranks on the one card, spawned with torch.multiprocessing,
    each folding half of the batches: the reduced packets and the new
    model equal (a)'s within 1e-5, and the model is bit-identical on
    both ranks.  They use gloo (CUDA tensors, a FileStore in the
    temporary directory) by choice: NCCL refuses two ranks on one GPU.
    (c) weak_scaling_curve at world size 1 (the mesh sizes this launch
    has), through the dense route (kernel G).
    Launch counts are set to 0 just before each sharded call (the hard
    loop, the Baum-Welch loop, the per-state step, the scaling curve,
    each rank's loop) and read just after; the reference runs lie
    outside those windows.  Returns ({path: counts}, reduction times)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from khg_tpu_torch import kernels
    from khg_tpu_torch.align.packed import pack_graph_batch
    from khg_tpu_torch.est.mle import MleDiagGmmOptions
    from khg_tpu_torch.model.transition_device import build_transition_struct
    from khg_tpu_torch.model.transition_model import MleTransitionUpdateConfig
    from khg_tpu_torch.parallel import mesh as M
    from khg_tpu_torch.parallel.scaling import weak_scaling_curve
    from khg_tpu_torch.recipes.pipeline import _carry_width, _split_carry, finish_pass

    frames = sum(f.shape[0] for f in feats)
    opts, tcfg = MleDiagGmmOptions(), MleTransitionUpdateConfig()
    path_launches = {}

    def counted(path, fn, *args, **kw):
        """fn(*args, **kw), its kernel launches kept under ``path``."""
        kernels.reset_launch_counts()
        out = fn(*args, **kw)
        path_launches[path] = dict(kernels.LAUNCHES)
        return out

    def launched(path, *names):
        for k in names:
            if path_launches[path][k] <= 0:
                raise AssertionError(f"phase 11 {path}: kernel {k} never launched")

    dist.init_process_group("nccl", init_method=f"file://{tmp / 'nccl_store'}",
                            world_size=1, rank=0)
    try:
        mesh = M.make_data_mesh(devices=[DEVICE])
        # (a) the hard loop against em_passes_resident
        ref = dp_pipeline(res.transition_model)
        base = ref.pack_graphs_base(graphs)
        t0 = time.perf_counter()
        m_ref, rec = ref.em_passes_resident(ref.pack_model_device(res.am), base, feats,
                                            DP_PASSES, mle_config=opts, transition_cfg=tcfg)
        ref_s = time.perf_counter() - t0
        pipe = dp_pipeline(res.transition_model)
        t0 = time.perf_counter()
        batches = pipe.device_batches(base, feats)
        model1, logp1, packets1, reduce1 = counted(
            "hard_loop", dp_loop_passes, mesh, pipe, pipe.pack_model_device(res.am),
            batches, DP_PASSES)
        dp_s = time.perf_counter() - t0
        ll_gap = np.abs(packets1[:, 0] / packets1[:, 1] - rec[:, 0] / rec[:, 1])
        model_ok = all(_close(a.cpu(), b.cpu()) for a, b in zip(model1, m_ref))
        bit = all(torch.equal(a, b) for a, b in zip(model1, m_ref))
        logp_gap = float(np.abs(logp1.cpu().numpy()[1:] - ref.tm.log_probs[1:]).max())
        n = packets1.shape[1]
        tail = packets1[:, n - 4:]
        log(f"phase 11(a) sharded_resident_em_loop, world 1 (NCCL), {len(batches)} batches "
            f"({sum(b[3] is not None for b in batches)} banded), {DP_PASSES} passes in "
            f"{dp_s:.2f} s (em_passes_resident {ref_s:.2f} s); per-frame ll gap "
            f"{ll_gap.tolist()}; model within {DP_RTOL}: {model_ok} (bit-equal {bit}); "
            f"transition log-probs max gap {logp_gap}; reduction per pass "
            f"{[round(s * 1e3, 3) for s in reduce1]} ms")
        if ll_gap.max() > DP_RTOL or not model_ok or logp_gap > 1e-5:
            raise AssertionError("phase 11(a): the sharded loop differs from "
                                 "em_passes_resident")
        if (tail[:, [1, 2, 3]] != rec[:, [3, 4, 5]]).any() or rec[:, 4].any():
            raise AssertionError("phase 11(a): utterance or frame counts differ, or "
                                 "alignments failed")
        launched("hard_loop", "banded_viterbi")
        if any(b[3] is None for b in batches):
            launched("hard_loop", "viterbi")

        # (a) the Baum-Welch loop against fb_em_passes_resident
        fb_ref = dp_pipeline(res.transition_model, self_loop_scale=1.0)
        _m, fb_rec = fb_ref.fb_em_passes_resident(
            fb_ref.pack_model_device(res.am), base, feats, 1, mle_config=opts,
            transition_cfg=tcfg)
        fb_pipe = dp_pipeline(res.transition_model, self_loop_scale=1.0)
        fb_batches = fb_pipe.device_batches(base, feats, fb=True)
        _m, _lp, fb_packets, fb_reduce = counted(
            "fb_loop", dp_loop_passes, mesh, fb_pipe,
            fb_pipe.pack_model_device(res.am), fb_batches, 1, fb=True)
        fb_gap = np.abs(fb_packets[:, [0, 1, n - 4]] - fb_rec[:, [0, 1, 2]]) / frames
        log(f"phase 11(a) sharded_resident_fb_em_loop, 1 pass, {len(fb_batches)} batches "
            f"({sum(b[3] is not None for b in fb_batches)} banded): per-frame gap "
            f"(tot_log_like, tot_frames, log Z) {fb_gap.tolist()}; reduction "
            f"{[round(s * 1e3, 3) for s in fb_reduce]} ms")
        if fb_gap.max() > 1e-4 or fb_rec[:, 4].any() or fb_packets[:, n - 2].any():
            raise AssertionError("phase 11(a): the sharded Baum-Welch loop differs from "
                                 "fb_em_passes_resident, or failed")
        launched("fb_loop", "banded_fb_fwd", "banded_fb_bwd")

        # (a) the per-state step on phase 7's first wide batch
        tm_w, am_w, graphs_w, feats_w = tri
        wpipe = tri_pipeline(tm_w, align_backend="banded")
        wbase = tri_packed(wpipe, graphs_w)
        wmodel = wpipe.pack_model_device(am_w)
        idx = list(range(TRI_BATCH))
        bfeats, lens, _bt = wpipe._batch_feats(idx, feats_w)
        wgraphs, banded, _sp = wpipe._batch_graphs(idx, wbase)
        tables, offsets = banded
        delta = torch.as_tensor(wpipe.transition_cost_deltas(), device=DEVICE)
        P_w, K_w, D_w = wmodel[1].shape
        carry = torch.zeros(_carry_width(P_w, K_w, D_w, tm_w.num_transition_ids),
                            device=DEVICE)
        wres, _scores, _fp = wpipe._align_batch(*wmodel[:3], bfeats, lens, wgraphs,
                                                banded, delta)
        c, _k = wpipe._estep_batch(*wmodel[:3], bfeats, lens, wgraphs, banded, None,
                                   delta, carry, torch.zeros_like(carry))
        step = M.sharded_em_step(mesh, acoustic_scale=0.1, banded_offsets=offsets,
                                 mle_config=opts, per_state=True)
        sres = counted("per_state_step", step, wmodel, tables._replace(
            plane_cost=tables.plane_cost + delta[tables.plane_tid.long()]),
            bfeats, lens, wpipe._id2pdf_t)
        occ, mean_acc, var_acc, scalars, counts, _tail = _split_carry(
            c, P_w, K_w, D_w, tm_w.num_transition_ids)
        w_model = finish_pass(
            wmodel, c, torch.as_tensor(np.asarray(wpipe.tm.log_probs, np.float32),
                                       device=DEVICE),
            build_transition_struct(wpipe.tm), M._mstep_kwargs(opts), tcfg, 1.0, 0.1,
        )[0]
        tids_equal = bool(torch.equal(sres.tids, wres.tids))
        stats_ok = all(_close(a.cpu(), b.cpu()) for a, b in (
            (sres.occ, occ), (sres.mean_acc, mean_acc), (sres.var_acc, var_acc),
            (sres.tid_counts, counts), (sres.tot_log_like, scalars[0])))
        wmodel_ok = all(_close(a.cpu(), b.cpu()) for a, b in zip(sres[8:], w_model))
        log(f"phase 11(a) sharded_em_step per_state on phase 7's first wide batch (B="
            f"{bfeats.shape[0]}, S={tables.plane_cost.shape[2]}, P={wmodel[0].shape[0]}): "
            f"tids equal to the pipeline's {tids_equal}; stats within {DP_RTOL} "
            f"{stats_ok}; new model within {DP_RTOL} {wmodel_ok}")
        if not (tids_equal and stats_ok and wmodel_ok) or bool(sres.total_cost.ge(1e29).any()):
            raise AssertionError("phase 11(a): the per-state step differs from the "
                                 "pipeline's wide batch")
        launched("per_state_step", "banded_viterbi_sac", "stats_fold")

        # (c) weak scaling at the sizes this launch has
        order = sorted(range(len(feats)), key=lambda i: feats[i].shape[0])
        sc_pipe = dp_pipeline(res.transition_model)
        sc_model = sc_pipe.pack_model_device(res.am)

        def problem(num_utts):
            idx = order[:num_utts]
            sub = [feats[i] for i in idx]
            T = max(f.shape[0] for f in sub)
            x = np.zeros((num_utts, T, sub[0].shape[1]), np.float32)
            for j, f in enumerate(sub):
                x[j, : f.shape[0]] = f
            g = pack_graph_batch(sc_pipe.pack_graphs([graphs[i] for i in idx]),
                                 states_pad_to=256, indeg_pad_to=2)
            lens = np.array([f.shape[0] for f in sub], np.int32)
            return sc_model[:3], sc_model[3], g, x, lens, sc_pipe._id2pdf_t

        t0 = time.perf_counter()
        curve = counted("weak_scaling", weak_scaling_curve, problem, [1, 2, 4],
                        per_device_batch=min(256, len(feats)), iters=3,
                        devices=[DEVICE], acoustic_scale=0.1)
        log(f"phase 11(c) weak scaling, world 1 (sizes 2 and 4 skipped: one card), "
            f"{time.perf_counter() - t0:.2f} s: {json.dumps(curve)}; {card_line()}")
        if [r["n_devices"] for r in curve] != [1]:
            raise AssertionError(f"phase 11(c): curve {curve}")
        launched("weak_scaling", "viterbi")
    finally:
        dist.destroy_process_group()

    # (b) two ranks on the one card
    data = tmp / "dp_data.pkl"
    with open(data, "wb") as f:
        pickle.dump((res.transition_model, res.am, base, feats), f)
    out_dir = tmp / "dp_out"
    out_dir.mkdir()
    t0 = time.perf_counter()
    ctx = mp.start_processes(_dp_rank, args=(2, str(tmp / "gloo_store"), str(data),
                                             str(out_dir), DEVICE),
                             nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(1.0, 600 - (time.perf_counter() - t0))):
            if time.perf_counter() - t0 > 600:
                raise AssertionError("phase 11(b): the ranks did not finish in 600 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    two_s = time.perf_counter() - t0
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(2)]
    same = all(np.array_equal(ranks[0][k], ranks[1][k], equal_nan=True)
               for k in ("m0", "m1", "m2", "m3", "logp", "packets"))
    packets_ok = _close(ranks[0]["packets"], packets1, atol=0)
    model_ok = all(_close(ranks[0][f"m{i}"], model1[i].cpu()) for i in range(4))
    counts_gap = float(np.abs(ranks[0]["packets"][:, 2:n - 4] - packets1[:, 2:n - 4]).max())
    model_gap = []
    for i in range(4):
        a, b = ranks[0][f"m{i}"], model1[i].cpu().numpy()
        fin = np.isfinite(a) & np.isfinite(b)
        model_gap.append(float(np.abs(a - b)[fin].max()) if fin.any() else 0.0)
    for r in range(2):
        path_launches[f"rank{r}_loop"] = json.loads(str(ranks[r]["launches"]))
    log(f"phase 11(b) two ranks on one card (gloo), {DP_PASSES} passes, {two_s:.2f} s with "
        f"start-up: ranks bit-identical {same}; packets within {DP_RTOL} of world 1 "
        f"{packets_ok} (tid counts max gap {counts_gap}); model within {DP_RTOL} "
        f"{model_ok} (max abs gaps {model_gap}); reduction per pass (gloo, rank 0) "
        f"{[round(float(s) * 1e3, 3) for s in ranks[0]['reduce_s']]} ms")
    if not (same and packets_ok and model_ok):
        raise AssertionError("phase 11(b): two ranks differ from each other or from world 1")
    for r in range(2):
        launched(f"rank{r}_loop", "banded_viterbi")
    log("phase 11 launches by path: " + json.dumps(
        {path: {k: n for k, n in c.items() if n} for path, c in path_launches.items()}))
    return path_launches, dict(world1_reduce_ms=[s * 1e3 for s in reduce1],
                          gloo2_reduce_ms=(ranks[0]["reduce_s"] * 1e3).tolist())


# ----------------------------------------------------------------- phase 12

PARITY_UTTS = 64
DITHER = 1.0
# bf16 per-state scores against f32: each score within BF16_REL (+ the
# f32 sums' 1e-5) of the magnitude of the terms it adds, since both
# operands of each product are rounded to bf16 (8 significant bits:
# (1 + 2^-8)^2 - 1), as tests/test_torch_per_state.py holds them
BF16_REL = 2.0 ** -7 + 2.0 ** -16


def parity_leftovers(res, graphs, feats, waves, cfg, results):
    """Phase 12: the options that close the port's parity with khg_tpu,
    on phase 4's corpus and model.  (a) Dither with a CUDA generator on
    the first PARITY_UTTS WAVs: fbank (plain path) and MFCC (kernel C)
    reproducible from a seed, bit-equal to the undithered path on
    dither_waves' noise from the same seed, another seed different, no
    generator adding nothing, and the noise's moments within 5 sigma.
    (b) Careful alignment of the first PARITY_UTTS utterances:
    pack_graphs(careful=True) and align_and_accumulate with
    align_backend="xla" (kernel G; launches counted around this call
    alone), with no failure and the plain graphs' alignments and
    likelihood; one careful batch on G against G's plain version (costs
    bit-equal, tids equal).  (c) bf16 per-state scores against f32 on
    that batch's plain graphs, within BF16_REL of each score's terms.
    (d) accumulate_am_stats_local on precomputed f32 state_scores
    bit-equal to the fold that scores itself.  Returns (the launches of
    (a), the launches of (b), the phase's seconds)."""
    import dataclasses

    import numpy as np
    import torch

    from khg_tpu_torch import kernels
    from khg_tpu_torch.align.viterbi_kernel import viterbi_cuda, viterbi_plain, viterbi_plan
    from khg_tpu_torch.features.fbank import compute_fbank_batch, dither_waves
    from khg_tpu_torch.features.mfcc import MfccConfig, compute_mfcc_batch
    from khg_tpu_torch.gmm.likelihoods import (
        component_scores_per_state,
        expand_feats,
        stack_model,
    )
    from khg_tpu_torch.recipes.pipeline import EStepPipeline, score_batch
    from khg_tpu_torch.stats.accum import accumulate_am_stats_local

    t_phase = time.perf_counter()
    n = PARITY_UTTS

    def gen(seed):
        return torch.Generator(device=DEVICE).manual_seed(seed)

    # (a) dither: an equal-length batch of the first n waves, cut to the
    # shortest
    cut = min(len(w) for w in waves[:n])
    x = torch.as_tensor(np.stack([w[:cut] for w in waves[:n]]).astype(np.float32),
                        device=DEVICE)
    dcfg = dataclasses.replace(cfg, dither=DITHER)
    mcfg0 = MfccConfig(fbank=cfg)
    mcfg = MfccConfig(fbank=dcfg)
    kernels.reset_launch_counts()
    fb1 = compute_fbank_batch(x, dcfg, gen(1))
    mf1 = compute_mfcc_batch(x, mcfg, gen(1))
    dither_launches = dict(kernels.LAUNCHES)
    fb1b = compute_fbank_batch(x, dcfg, gen(1))
    mf1b = compute_mfcc_batch(x, mcfg, gen(1))
    fb2 = compute_fbank_batch(x, dcfg, gen(2))
    noisy = dither_waves(x, DITHER, gen(1))
    fb_explicit = compute_fbank_batch(noisy, cfg)
    mf_explicit = compute_mfcc_batch(noisy, mcfg0)
    none_fb = compute_fbank_batch(x, dcfg)
    none_mf = compute_mfcc_batch(x, mcfg)
    plain_fb = compute_fbank_batch(x, cfg)
    plain_mf = compute_mfcc_batch(x, mcfg0)
    noise = (noisy - x).double()
    samples = noise.numel()
    mean, std = float(noise.mean()), float(noise.std())
    mean_lim, std_lim = 5 * DITHER / math.sqrt(samples), 5 * DITHER / math.sqrt(2 * samples)
    dither_checks = {
        "same seed, same fbank": torch.equal(fb1, fb1b),
        "same seed, same MFCC": torch.equal(mf1, mf1b),
        "another seed, other fbank": not torch.equal(fb1, fb2),
        "fbank bit-equal to explicit noise": torch.equal(fb1, fb_explicit),
        "MFCC bit-equal to explicit noise": torch.equal(mf1, mf_explicit),
        "no generator adds nothing": (torch.equal(none_fb, plain_fb)
                                      and torch.equal(none_mf, plain_mf)),
        "noise moved the features": not torch.equal(fb1, plain_fb),
        "mean within 5 sigma": abs(mean) <= mean_lim,
        "std within 5 sigma": abs(std - DITHER) <= std_lim,
        "features finite": bool(torch.isfinite(fb1).all() and torch.isfinite(mf1).all()),
    }
    log(f"phase 12(a) dither {DITHER} with a CUDA generator, {n} waves x {cut} samples: "
        f"noise mean {mean:.3e} (limit {mean_lim:.3e}), std {std:.6f} (1 +- "
        f"{std_lim:.3e}) over {samples} samples; fbank {tuple(fb1.shape)}, MFCC "
        f"{tuple(mf1.shape)}; {json.dumps(dither_checks)}; launches "
        f"{ {k: v for k, v in dither_launches.items() if v} }")
    if not all(dither_checks.values()):
        raise AssertionError(f"phase 12(a): dither checks failed: {dither_checks}")
    if dither_launches["fbank"] <= 0:
        raise AssertionError("phase 12(a): kernel C did not launch for the dithered MFCC")

    # (b) careful alignment through kernel G
    sub_graphs, sub_feats = graphs[:n], feats[:n]
    pipe = EStepPipeline(copy.deepcopy(res.transition_model), acoustic_scale=0.1,
                         self_loop_scale=0.1, batch_size=n, align_backend="xla",
                         device=DEVICE)
    careful = pipe.pack_graphs(sub_graphs, careful=True)
    plain = pipe.pack_graphs(sub_graphs)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ali_c = pipe.align_and_accumulate(res.am, careful, sub_feats, accumulate=False)
    torch.cuda.synchronize()
    careful_s = time.perf_counter() - t0
    careful_launches = dict(kernels.LAUNCHES)
    ali_p = pipe.align_and_accumulate(res.am, plain, sub_feats, accumulate=False)
    same_alignments = ali_c.alignments == ali_p.alignments
    log(f"phase 12(b) careful alignment of {n} utterances (align_backend='xla'): "
        f"{careful_s:.3f} s, failures {ali_c.num_error} (plain graphs "
        f"{ali_p.num_error}), tot_like {ali_c.tot_like!r} (plain graphs "
        f"{ali_p.tot_like!r}), alignments equal {same_alignments}; launches "
        f"{ {k: v for k, v in careful_launches.items() if v} }")
    if ali_c.num_error or ali_p.num_error or not same_alignments \
            or ali_c.tot_like != ali_p.tot_like:
        raise AssertionError("phase 12(b): careful alignment failed or differs from "
                             "the plain graphs'")
    if careful_launches["viterbi"] <= 0:
        raise AssertionError("phase 12(b): kernel G never launched for careful graphs")

    idx = sorted(range(n), key=lambda i: sub_feats[i].shape[0])
    gconsts, miv, iv = pipe._pack_model(res.am)
    bfeats, lens, _bt = pipe._batch_feats(idx, sub_feats)
    g, _banded, _sp = pipe._batch_graphs(idx, careful)
    ll, _scores = score_batch(gconsts, miv, iv, bfeats)
    nf = lens.to(torch.int32).contiguous()
    tk, ck = viterbi_cuda(g, ll, nf, 0.1)
    tp, cp = viterbi_plain(g, ll, nf, 0.1)
    torch.cuda.synchronize()
    B, S, M = g.in_src.shape
    plan = viterbi_plan(S, M)
    g_equal = torch.equal(ck, cp) and torch.equal(tk, tp)
    ms = time_ms(lambda: viterbi_cuda(g, ll, nf, 0.1), reps=5)
    plain_ms = time_ms(lambda: viterbi_plain(g, ll, nf, 0.1), reps=1)
    log(f"phase 12(b) kernel G on the careful batch (B={B}, T={ll.shape[1]}, S={S}, "
        f"M={M}, {plan[0]} route): costs bit-equal and tids equal to its plain "
        f"version: {g_equal}; {ms:.3f} ms (plain {plain_ms:.1f} ms)")
    if not g_equal:
        raise AssertionError("phase 12(b): kernel G differs from its plain version "
                             "on careful graphs")

    # (c) bf16 per-state scores against f32, on the plain graphs' states
    _g, _banded, sp = pipe._batch_graphs(idx, plain)
    if sp is None:
        raise AssertionError("phase 12(c): the plain graphs are not destination-uniform")
    f32 = component_scores_per_state(gconsts, miv, iv, sp, bfeats)
    bf16 = component_scores_per_state(gconsts, miv, iv, sp, bfeats,
                                      compute_dtype="bfloat16")
    P, K, D = miv.shape
    A, _gc = stack_model(gconsts, miv, iv)
    terms = torch.einsum("btd,bskd->btsk", expand_feats(bfeats).abs(),
                         A.reshape(P, K, 2 * D)[sp.long()].abs())
    fin = torch.isfinite(f32)
    gap = (bf16 - f32)[fin].abs()
    ratio = float((gap / ((BF16_REL + 1e-5) * terms[fin] + 1e-6)).max())
    bf16_ok = torch.equal(fin, torch.isfinite(bf16)) and ratio <= 1.0
    log(f"phase 12(c) bf16 per-state scores (B={B}, T={bfeats.shape[1]}, S="
        f"{sp.shape[1]}, K={K}, D={D}) against f32: max |diff| {float(gap.max()):.3e}, "
        f"at most {ratio:.3f} of the limit ({BF16_REL:.6f} + 1e-5 of each score's "
        f"terms); finite entries equal {bool(torch.equal(fin, torch.isfinite(bf16)))}")
    if not bf16_ok:
        raise AssertionError("phase 12(c): bf16 per-state scores off their bound")
    del f32, bf16, terms, gap

    # (d) the local fold on precomputed state scores
    id2pdf = pipe.tm.id2pdf_array()
    pdf_np = np.zeros(tuple(bfeats.shape[:2]), np.int64)
    w_np = np.zeros(tuple(bfeats.shape[:2]), np.float32)
    for j, i in enumerate(idx):
        tids = np.asarray(ali_p.alignments[i])
        pdf_np[j, : len(tids)] = id2pdf[tids]
        w_np[j, : len(tids)] = 1.0
    pdf_ids = torch.as_tensor(pdf_np, device=DEVICE)
    weights = torch.as_tensor(w_np, device=DEVICE)
    own = accumulate_am_stats_local(gconsts, miv, iv, bfeats, pdf_ids, weights, sp)
    given = accumulate_am_stats_local(
        gconsts, miv, iv, bfeats, pdf_ids, weights, sp,
        state_scores=component_scores_per_state(gconsts, miv, iv, sp, bfeats))
    torch.cuda.synchronize()
    scores_equal = all(torch.equal(a, b) for a, b in zip(own, given))
    log(f"phase 12(d) accumulate_am_stats_local with state_scores bit-equal to "
        f"without: {scores_equal} (tot_frames {float(own.tot_frames)}, "
        f"tot_log_like {float(own.tot_log_like)!r})")
    if not scores_equal or float(own.tot_frames) != float(w_np.sum()):
        raise AssertionError("phase 12(d): the fold on given state scores differs")

    phase_s = time.perf_counter() - t_phase
    log(f"phase 12: {phase_s:.1f} s; {card_line()}")
    results["viterbi"]["phase12"] = dict(
        launches=careful_launches["viterbi"], B=B, S=S, M=M, plan=plan[0],
        bit_equal=True, ms=ms, plain_ms=plain_ms)
    results["fbank"]["phase12"] = dict(launches=dither_launches["fbank"])
    return dither_launches, careful_launches, phase_s


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (ROOT / "khg_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: khg_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import khg_tpu_torch  # noqa: F401  (sets fp32 matmul flags)
    from khg_tpu_torch.data.wav import read_wav
    from khg_tpu_torch.features.fbank import FbankConfig
    from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
    from khg_tpu_torch.lang.topo import generate_hmm_topo
    from khg_tpu_torch.recipes.audiomnist import digits_lexicon
    from khg_tpu_torch.recipes.corpus_train import compile_training_graphs
    from khg_tpu_torch.recipes.steps import gmm_init_mono
    from khg_tpu_torch.recipes.synth import SAMPLE_RATE

    t_start = time.perf_counter()
    card = phase_toolchain()
    phase_build()

    results = {}
    with tempfile.TemporaryDirectory(prefix="khg_chip_smoke_") as tmp:
        t0 = time.perf_counter()
        corpus = make_corpus(Path(tmp))
        synth_s = time.perf_counter() - t0
        waves = [read_wav(p)[0] for p in corpus.wav_paths]
        log(f"synth: {len(waves)} WAVs, "
            f"{sum(map(len, waves)) / SAMPLE_RATE:.1f} audio-sec in {synth_s:.1f} s")
        cfg = FbankConfig(sample_rate=SAMPLE_RATE, num_mel_bins=23)
        lp = Lexiconp.from_lexicon(
            Lexicon(word2phones=digits_lexicon())
        ).add_lex_disambig()
        topo = generate_hmm_topo(
            non_sil_phones=lp.get_non_sil_phone_ids(),
            sil_phone=lp.get_sil_phone_id(),
        )
        # the tree and pristine transition model depend only on the
        # topology: the graphs compiled here are the ones train_corpus
        # would compile itself
        tm0, tree, am0 = gmm_init_mono(
            topo, [np.random.default_rng(0).standard_normal((64, 23)).astype(np.float32)]
        )
        t0 = time.perf_counter()
        graphs = compile_training_graphs(lp, tm0, tree, corpus.word_seqs)
        log(f"graph compile: {len(graphs)} graphs in {time.perf_counter() - t0:.1f} s")

        setup = (lp, tm0, tree, graphs, list(map(len, waves)), cfg)
        check_banded(setup, results)
        check_banded_fb(setup, results)
        check_loglikes(am0.num_pdfs, results)
        check_fbank(waves, cfg, results)
        check_viterbi(setup, results)
        t0 = time.perf_counter()
        tri = triphone_system()
        log(f"triphone-bench system: {tri[1].num_pdfs} pdfs x {TRI_MIX} "
            f"Gaussians, D={TRI_DIM}, {len(tri[3])} utterances in "
            f"{time.perf_counter() - t0:.1f} s")
        batch = tri_batch(tri)
        check_fold(batch, results)
        check_banded_sac(batch, results)
        check_loglikes_wide(batch, results)
        del batch
        if KERNELS_ONLY:
            return 1

        res, feats, launches = main_path(corpus, lp, graphs, cfg)
        b_launches, g_launches = pallas_backend(res, graphs, feats)
        fb_launches = soft_em(res, graphs, feats)
        w_launches = wide_em(tri)
        held_out_decode(res, lp, cfg, corpus, Path(tmp), results)
        t0 = time.perf_counter()
        yesno_recipe(Path(tmp), results)
        log(f"phase 9: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ctc_runner, ctc_launches = ctc_phase(Path(tmp), corpus, feats)
        log(f"phase 10: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dp_launches, dp_times = data_parallel(Path(tmp), res, graphs, feats, tri)
        log(f"phase 11: {time.perf_counter() - t0:.1f} s")
        parity_leftovers(res, graphs, feats, waves, cfg, results)

    results["banded_viterbi"]["launches"] = launches["banded_viterbi"]
    results["fbank"]["launches"] = launches["fbank"]
    results["fused_loglikes"]["launches"] = b_launches["fused_loglikes"]
    for k in ("banded_fb_fwd", "banded_fb_bwd"):
        results[k]["launches"] = fb_launches[k]
    results["viterbi"]["launches"] = g_launches["viterbi"]
    for k in ("stats_fold", "banded_viterbi_sac"):
        results[k]["launches"] = w_launches[k]
    results["viterbi"]["phase10"] = dict(runner_launches=ctc_runner["viterbi"],
                                         full_width_launches=ctc_launches["viterbi"])
    results["fused_loglikes"]["phase10"] = dict(runner_launches=ctc_runner["fused_loglikes"])
    for k in ("banded_viterbi", "banded_viterbi_sac", "banded_fb_fwd", "banded_fb_bwd",
              "stats_fold", "viterbi"):
        results[k]["phase11"] = dict(launches={
            path: c[k] for path, c in dp_launches.items() if c[k]})
    log(f"phase 11 reductions (ms per pass): {json.dumps(dp_times)}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [results[k] for k in (
        "banded_viterbi", "fused_loglikes", "fbank", "banded_fb_fwd",
        "banded_fb_bwd", "stats_fold", "viterbi", "banded_viterbi_sac")]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
