#!/usr/bin/env python3
"""Split the card time of the banded Viterbi kernel (A), of the banded
forward-backward kernels (D forward, E backward), of the stats fold (F)
and of the fbank kernel (C) into their parts, and time the non-banded
Viterbi kernel's (G) two kernels on one batch.

    python3 tools/kernel_split.py [--src DIR] [--design parent|compiled] [--kernels A,C,D,E,F,G]
                                  [--out FILE]

DIR holds the ``banded_viterbi.cu`` and ``banded_fb.cu`` to split
(default khg_tpu_torch/csrc; for the first port's kernels unpack the
parent of their redesign with ``git archive`` and pass its
``khg_tpu_torch/csrc`` with ``--design parent``).  Each variant is
one of those files with parts cut out by a text patch (a patch that
does not apply is an error).  The variants are built with nvcc for
sm_90a into ``build/split/`` and timed with CUDA events on
chip_smoke.py's kernel-check batches (the 256 shortest of its 1,024
synthetic utterances, B=256, T=512, S=256, DK=20), in turns: every
variant in order, then in reverse.  The parts are differences of
variants:

--design parent (the first port's kernels):
A: frames = the frame loop alone; of it, the acoustic gather = frames
   less frames with a constant acoustic term; argmin = frames and
   argmin less frames; backtrace = whole less frames and argmin.
E: each of the alpha load, the acoustic load and the read-modify-write
   of the plane posteriors in global memory = whole less whole without
   it; plane loops = the kernel with all three cut out.
D: frames = the frame loop alone (no log Z); the acoustic loads =
   frames less frames with a constant acoustic term; log Z = whole less
   frames.
--design compiled (the default: the compiled paths of the redesign,
   timed also on chip_smoke.py's first triphone batch in sac mode):
A: frames, argmin and backtrace as above; of the frames, the acoustic
   loads and the backpointer stores (with the argmin index they need)
   each = frames less frames without it.
D: frames, acoustic loads and log Z as for the parent.
E: each of the posterior expfs, the beta sum and the alpha-row copies
   = whole less whole without it.
F (compiled design only): the device time of each of its five launches
   (match, group, place, score, fold) from a torch.profiler trace of 10
   calls on chip_smoke.py's first triphone batch, the grouping, scoring
   and fold stages from CUDA events, the heaviest pdf's frames, and the
   score and fold launches of stats_fold.cu variants timed alone: the
   dots, the model rows' loads, the per-frame sums, the posterior and
   row writes, the segment sums, the zero rows and the fold's frame
   loop, each = the launch less the launch without it.
G (compiled design only): the compiled kernel and the generic one (the
   same source with the launcher's choice patched to the generic
   kernel) on chip_smoke.py's kernel G check batch (B=256, T=512,
   S=256, M=4), costs and tids compared to the bit, timed in turns,
   beside the batch's serial frame chain (chip_smoke.serial_bound).
C (compiled design only): fbank.cu variants on check_fbank's rows (256
   x 4.2 s at 8 kHz, the WAVs' integer samples) and on 64 of them
   upsampled to 48 kHz (as check_fbank), timed in turns: the
   products = whole less without mma; the five correction products =
   whole less hi x hi only; the mel sums = whole less without them; the
   table's ring = whole less without its copies.

Prints one JSON object (and writes it to FILE, default
chiprun_out/kernel_split.json).  Needs one NVIDIA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# {design: {variant: [(old, new), ...]}}: the parent's kernels (PR 3's
# design) and the compiled paths of the redesign
_A_FRAMES_ONLY = ("    // first-match argmin of alpha + final over s",
                  "    if (nf >= 0) return;\n    // first-match argmin of alpha + final over s")
_A_NO_LL = ("const float ac = llt[spdf[s]];", "const float ac = (float)(t & 1);")
_E_NO_APOST = ("*cell = __fadd_rn(*cell, p);", "(void)cell;")
_E_NO_ALPHA = ("al[s] = ab[(size_t)t * S + s];", "al[s] = (float)(t & 1);")
_E_NO_LL = ("bplus = __fadd_rn(beta, __fmul_rn(scale, llb[(size_t)t * P + pdf]));",
            "bplus = __fadd_rn(beta, __fmul_rn(scale, (float)(t & 1)));")
_AC_FRAMES_ONLY = ("    const float* last = (nf & 1) ? alpha1 : alpha0;",
                   "    if (nf >= 0) return;\n    const float* last = (nf & 1) ? alpha1 : alpha0;")
_AC_NO_LL = ("        if (live && t + 2 < nf) acr = llb[(size_t)(t + 2) * P];\n", "")
_E_BETA_SUM = ("if (__any_sync(0xffffffffu, m > KHG_HALF_NEG_BIG)) {\n#pragma unroll\n"
               "            for (int d = 0; d < DK; ++d) sum = __fadd_rn(sum, expf(__fsub_rn(c[d], ms)));\n"
               "        }\n        beta = lse_finish")
_D_PARENT_FRAMES = ("    // log Z = lse_s(alpha + final), summed over the states in order; the",
                    "    if (nf >= 0) return;\n    // log Z = lse_s(alpha + final), summed over the states in order; the")
_D_PARENT_NO_LL = ("const float sac = __fmul_rn(scale, llb[(size_t)t * P + pdf]);",
                   "const float sac = __fmul_rn(scale, (float)(t & 1));")
_D_FRAMES = ("    // log Z = lse_s(alpha + final): the max over the block, then each",
             "    if (nf >= 0) return;\n    // log Z = lse_s(alpha + final): the max over the block, then each")
_D_NO_LL = ("        if (live && t + 2 < nf) ac1 = llb[(size_t)(t + 2) * P];\n", "")
VARIANTS = {
    "parent": {
        "A": {
            "whole": [],
            "frames_argmin": [("for (int t = nf - 1; t >= 0; --t) {\n        const int p = bpb",
                               "for (int t = -1; t >= 0; --t) {\n        const int p = bpb")],
            "frames": [_A_FRAMES_ONLY],
            "frames_no_ll": [_A_FRAMES_ONLY, _A_NO_LL],
        },
        "D": {
            "whole": [],
            "frames": [_D_PARENT_FRAMES],
            "frames_no_ll": [_D_PARENT_FRAMES, _D_PARENT_NO_LL],
        },
        "E": {
            "whole": [],
            "no_apost_rmw": [_E_NO_APOST],
            "no_alpha_load": [_E_NO_ALPHA],
            "no_ll_load": [_E_NO_LL],
            "plane_loops": [_E_NO_APOST, _E_NO_ALPHA, _E_NO_LL],
        },
    },
    "compiled": {
        "A": {
            "whole": [],
            "frames_argmin": [("        bi, nf, stage, gbp, Sp, path, tb,",
                               "        bi, 0, stage, gbp, Sp, path, tb,")],
            "frames": [_AC_FRAMES_ONLY],
            "frames_no_ll": [_AC_FRAMES_ONLY, _AC_NO_LL],
            "frames_no_bp": [_AC_FRAMES_ONLY, ("stage[(t & (2 * CH - 1)) * Sp + s] = (int8_t)arg;",
                                               "(void)arg;")],
        },
        "D": {
            "whole": [],
            "frames": [_D_FRAMES],
            "frames_no_ll": [_D_FRAMES, _D_NO_LL],
        },
        "E": {
            "whole": [],
            "no_posterior_exp": [("if (__any_sync(0xffffffffu, !(xm < EXP_ZERO))) {", "if (xm > 1.f) {")],
            "no_beta_sum": [(_E_BETA_SUM, _E_BETA_SUM.replace(
                "if (__any_sync(0xffffffffu, m > KHG_HALF_NEG_BIG)) {", "if (m > 1e38f) {"))],
            "no_alpha_copies": [("        if (t >= 0) {\n            float* a = aring",
                                 "        if (t >= nf) {\n            float* a = aring")],
        },
    },
}


def build_variants(src: Path, out_dir: Path, variants, tag: str):
    """Patch ``src`` per variant, compile each into a shared library in
    parallel; returns {variant: loaded CDLL}."""
    from khg_tpu_torch import kernels

    text = src.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, patches in variants.items():
        body = text
        for old, new in patches:
            if body.count(old) != 1:
                raise RuntimeError(f"{src.name}: patch for {name} does not apply: {old!r}")
            body = body.replace(old, new)
        cu = out_dir / f"{tag}_{name}.cu"
        cu.write_text(body)
        jobs[name] = (cu, out_dir / f"{tag}_{name}.so")
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]

    def nvcc(job):
        cu, so = job
        proc = subprocess.run([kernels._nvcc(), *flags, "-I", str(src.parent), "-shared",
                               "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cu.name}:\n{proc.stdout}{proc.stderr}")
        return so

    with ThreadPoolExecutor(len(jobs)) as pool:
        sos = dict(zip(jobs, pool.map(nvcc, jobs.values())))
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def timed_in_turns(calls, reps: int = 10):
    """{name: mean ms}: each call timed in order, then in reverse."""
    import chip_smoke

    out = {k: [] for k in calls}
    for order in (list(calls), list(reversed(list(calls)))):
        for name in order:
            out[name].append(chip_smoke.time_ms(calls[name], reps=reps))
    return {k: sum(v) / len(v) for k, v in out.items()}


# F's variants (compiled design): score and fold each timed alone
_F_VARIANTS = {
    "whole": [],
    "no_dots": [("    score_dots<false>(dot, xr, mr, D);\n                score_dots<true>(dot, xr, mr + D, D);",
                 "")],
    "no_model": [("    stage_model(m_s, gconsts, miv, iv, pdf_s[0], 0, min(kc, K), K, D);", ""),
                 ("                stage_model(m_s, gconsts, miv, iv, pdf, k0, nk, K, D);", "")],
    "no_z_loop": [("for (int k = 0; k < K; ++k) z += expf(r[k] - mx);", "z = (float)K;")],
    "no_writes": [("for (int j = wid; j < nc; j += NW) {\n        float* pr = f.post",
                   "for (int j = wid; j < (nc & 0); j += NW) {\n        float* pr = f.post")],
    "no_seg_items": [("const int nseg_items = nfold + w.hdr[2];", "const int nseg_items = nfold;")],
    "no_zero_rows": [("const int nitems = nseg_items + (P + ZERO_PDFS - 1) / ZERO_PDFS;",
                      "const int nitems = nseg_items;")],
    "no_frame_loop": [("for (int j = 0; j < nc;) {\n                if ((starts >> j) & 1u) {",
                       "for (int j = 0; j < (nc & 0);) {\n                if ((starts >> j) & 1u) {")],
}


# G's variants: the launcher's choice of kernel
_G_VARIANTS = {
    "compiled": [],
    "generic": [("    if (S <= FAST_S && M <= MAX_M) {", "    if (false) {")],
}


_C_MMA = ("    wgmma_tf32(acc, ah, dh);\n",
          "    wgmma_tf32(cor, ah, dl);\n"
          "    wgmma_tf32(cor, am, dm);\n"
          "    wgmma_tf32(cor, ah, dm);\n"
          "    wgmma_tf32(cor, am, dh);\n"
          "    if (LO) wgmma_tf32(cor, al, dh);\n")
_C_VARIANTS = {
    "whole": [],
    "hi_only": [(_C_MMA[1], "")],
    "no_mma": [(_C_MMA[0] + _C_MMA[1], "")],
    "no_mel": [("for (int k = max(r.x, q0); k < hi; ++k)",
                "for (int k = max(r.x, q0); k < (hi & 0); ++k)")],
    "no_table": [("for (int i = tid; i < STAGE_FLOATS / 4; i += THREADS) {",
                  "for (int i = tid; i < 0; i += THREADS) {")],
}


def fbank_split(chip_smoke, waves, src: Path, build: Path):
    """Kernel C's parts on check_fbank's rows (8 kHz) and on 64 of them
    upsampled to 48 kHz, from fbank.cu variants timed in turns."""
    import math

    import numpy as np
    import torch
    from scipy.signal import resample_poly

    from khg_tpu_torch.features.fbank import FbankConfig, num_frames
    from khg_tpu_torch.features.fbank_kernel import (
        FRAMES,
        _kernel_tables_on,
        _padded_wave,
        fbank_cuda,
        fbank_plan,
    )
    from khg_tpu_torch.recipes.synth import SAMPLE_RATE

    cfg = FbankConfig(sample_rate=SAMPLE_RATE, num_mel_bins=23)
    n = int(4.2 * cfg.sample_rate)
    rows = np.stack([np.pad(w, (0, max(0, n - len(w))), mode="symmetric")[:n]
                     for w in waves[:256]]).astype(np.float32)
    up = 48000 // math.gcd(48000, cfg.sample_rate)
    down = cfg.sample_rate // math.gcd(48000, cfg.sample_rate)
    rows48 = np.clip(np.round(resample_poly(rows[:64].astype(np.float64), up, down, axis=1)),
                     -32768, 32767).astype(np.float32)
    libs = build_variants(src / "fbank.cu", build, _C_VARIANTS, "C")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    out = {}
    for name, r, c in (("8k", rows, cfg), ("48k", rows48, FbankConfig(sample_rate=48000,
                                                                        num_mel_bins=23))):
        T = num_frames(c, r.shape[1])
        padded = _padded_wave(torch.as_tensor(r, device="cuda"), c, T)
        plan = fbank_plan(c)
        table, mel, rng, chunks = _kernel_tables_on(c, "cuda")
        B, L = padded.shape
        M, nbins = mel.shape
        feats = torch.empty((B, T, M), device="cuda")
        energy = torch.empty((B, T), device="cuda")

        def call(lib, padded=padded, c=c, T=T, plan=plan, table=table, mel=mel, rng=rng,
                 chunks=chunks, feats=feats, energy=energy, B=B, L=L, M=M, nbins=nbins):
            def run():
                err = lib.launch_fbank(
                    padded.data_ptr(), table.data_ptr(), mel.data_ptr(), rng.data_ptr(),
                    chunks.data_ptr(), feats.data_ptr(), energy.data_ptr(), B, L, T,
                    c.frame_shift, c.frame_length, plan.kp, plan.stride, table.shape[2] * 8,
                    nbins, M, 1, 1, 1, ctypes.c_float(-math.inf), stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            return run

        fk, _ek = fbank_cuda(padded, c, T)
        call(libs["whole"])()
        torch.cuda.synchronize()
        if not torch.equal(fk, feats):
            raise AssertionError("kernel C: the whole variant differs from the library's kernel")
        ms = timed_in_turns({k: call(v) for k, v in libs.items()})
        split = dict(products=ms["whole"] - ms["no_mma"],
                     corrections=ms["whole"] - ms["hi_only"],
                     mel_sums=ms["whole"] - ms["no_mel"],
                     table_ring=ms["whole"] - ms["no_table"])
        # blocks an SM holds: 228 KB of shared memory an SM, 1 KB of it
        # reserved a block, at most 3 (the kernel's launch bounds)
        out[name] = dict(shape=dict(B=B, T=T, frame_len=c.frame_length, N=c.fft_size, M=M,
                                    ncols=table.shape[2] * 8, blocks=B * -(-T // FRAMES),
                                    blocks_per_sm=min(3, 233472 // (plan.smem + 1024)),
                                    table_bytes_per_block=table.numel() * 4,
                                    plan=plan._asdict()),
                         variant_ms=ms, split_ms=split)
    return out


def viterbi_kernels(chip_smoke, setup, src: Path, build: Path):
    """G's compiled and generic kernels on chip_smoke.py's check batch:
    bit-equal outputs, times in turns, the serial bound."""
    import torch

    from khg_tpu_torch import kernels

    libs = build_variants(src / "viterbi.cu", build, _G_VARIANTS, "compiled_G")
    g, ll, nf, T, P = chip_smoke.viterbi_batch(setup)
    B, S, M = g.in_src.shape
    stream = kernels.stream_handle(ll.device)
    outs = {}

    def call(name, lib):
        bp = torch.empty((B, T, -(-S // 16) * 16), dtype=torch.int8, device="cuda")
        tids = torch.empty((B, T), dtype=torch.int32, device="cuda")
        cost = torch.empty((B,), dtype=torch.float32, device="cuda")
        outs[name] = (tids, cost)

        def run():
            err = lib.launch_viterbi(
                g.in_src.data_ptr(), g.in_pdf.data_ptr(), g.in_cost.data_ptr(),
                g.in_tid.data_ptr(), g.init_cost.data_ptr(), g.final_cost.data_ptr(),
                ll.data_ptr(), nf.data_ptr(), bp.data_ptr(), None, tids.data_ptr(),
                cost.data_ptr(), B, S, M, T, P, 0.1, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        return run

    calls = {k: call(k, v) for k, v in libs.items()}
    for run in calls.values():
        run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(outs["compiled"], outs["generic"])):
        raise RuntimeError("G: the generic kernel's costs or tids differ from the compiled one's")
    ms = timed_in_turns(calls)
    mf = int(nf.max())
    serial_ms, chain = chip_smoke.serial_bound(mf, M, S)
    return dict(shape=dict(B=B, T=T, S=S, M=M, P=P, frames=int(nf.sum()), max_frames=mf),
                bit_equal=True, variant_ms=ms,
                us_per_frame={k: v / mf * 1e3 for k, v in ms.items()},
                serial_bound_ms=serial_ms, serial_chain=chain)


def fold_split(chip_smoke, src: Path, build: Path):
    """F on chip_smoke.py's first triphone batch: each launch's device
    time (profiler), the stages by CUDA events, the heaviest pdf, and
    the score and fold launches of patched variants timed alone (in
    turns): each of the dots, the model rows' loads, the per-frame sums
    (z loop) and the posterior and row writes = score less score without
    it; the segment sums, the zero rows and the frame loop = fold less
    fold without it."""
    import torch

    from khg_tpu_torch import kernels
    from khg_tpu_torch.stats import fold_kernel as fk

    batch = chip_smoke.tri_batch(chip_smoke.triphone_system())
    (g, miv, iv, _w), _t, _o, x, _l, _s, pid, fw, sp = batch
    args = (g, miv, iv, x, pid, fw, sp)
    whole = chip_smoke.time_ms(lambda: fk.fold_cuda(*args), reps=10)
    stages = {"grouping": 0.0, "scoring": 0.0, "fold": 0.0}
    for _ in range(10):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        fk.fold_cuda(*args, events=ev)
        torch.cuda.synchronize()
        for i, k in enumerate(stages):
            stages[k] += ev[i].elapsed_time(ev[i + 1]) / 10
    hit = (pid[:, :, None] == sp[:, None, :]).any(-1) & (fw > 0)

    libs = build_variants(src / "stats_fold.cu", build, _F_VARIANTS, "compiled_F")
    P, K, D = miv.shape
    B, T, _ = x.shape
    S = sp.shape[1]
    stream = kernels.stream_handle(x.device)
    iws = torch.empty(fk.fold_workspace_ints(B, S, T, P), dtype=torch.int32, device="cuda")
    fws = torch.empty(fk.fold_workspace_floats(B, T, K, D), dtype=torch.float32, device="cuda")
    out = torch.empty((P, K, 2 * D + 1), dtype=torch.float32, device="cuda")
    ll, frames = torch.empty((2, B, S), dtype=torch.float32, device="cuda")

    def score(lib):
        return lambda: lib.launch_stats_fold_score(
            g.data_ptr(), miv.data_ptr(), iv.data_ptr(), x.data_ptr(), pid.data_ptr(),
            fw.data_ptr(), iws.data_ptr(), fws.data_ptr(), B, S, T, P, K, D, stream)

    def fold(lib):
        return lambda: lib.launch_stats_fold_fold(
            iws.data_ptr(), fws.data_ptr(), out.data_ptr(), ll.data_ptr(),
            frames.data_ptr(), B, S, T, P, K, D, stream)

    lib = libs["whole"]
    if lib.launch_stats_fold_group(pid.data_ptr(), fw.data_ptr(), sp.data_ptr(),
                                   iws.data_ptr(), ll.data_ptr(), frames.data_ptr(),
                                   B, S, T, P, stream) or score(lib)():
        raise RuntimeError("F variants: launch failed")
    score_ms = timed_in_turns({k: score(v) for k, v in libs.items()})
    fold_ms = timed_in_turns({k: fold(v) for k, v in libs.items()})
    return dict(
        shape=dict(zip("BTD", x.shape), K=K, P=P, S=S, frames=int(hit.sum())),
        ms=whole, stages_ms=stages,
        device_ms=chip_smoke.kernel_device_ms(lambda: fk.fold_cuda(*args), 10, "fold_"),
        heaviest_pdf_frames=int(torch.bincount(pid[hit].long()).max()),
        score_variant_ms=score_ms, fold_variant_ms=fold_ms,
        split_ms=dict(dots=score_ms["whole"] - score_ms["no_dots"],
                      model_rows=score_ms["whole"] - score_ms["no_model"],
                      z_loop=score_ms["whole"] - score_ms["no_z_loop"],
                      posterior_and_row_writes=score_ms["whole"] - score_ms["no_writes"],
                      segment_sums=fold_ms["whole"] - fold_ms["no_seg_items"],
                      zero_rows=fold_ms["whole"] - fold_ms["no_zero_rows"],
                      fold_frame_loop=fold_ms["whole"] - fold_ms["no_frame_loop"]),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "khg_tpu_torch" / "csrc",
                    help="directory with the banded_viterbi.cu and banded_fb.cu to split")
    ap.add_argument("--design", choices=sorted(VARIANTS), default="compiled",
                    help="which kernels the sources hold: the parent's or the compiled paths")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "kernel_split.json")
    ap.add_argument("--kernels", default="A,D,E,F",
                    help="which kernels to split (C, F and G only with --design compiled)")
    args = ap.parse_args()
    want = set(args.kernels.split(","))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_split: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke
    from khg_tpu_torch import kernels
    from khg_tpu_torch.align.banded_fb import banded_fb_fwd_cuda
    from khg_tpu_torch.features.fbank import FbankConfig
    from khg_tpu_torch.lang.lexicon import Lexicon, Lexiconp
    from khg_tpu_torch.lang.topo import generate_hmm_topo
    from khg_tpu_torch.recipes.audiomnist import digits_lexicon
    from khg_tpu_torch.recipes.corpus_train import compile_training_graphs
    from khg_tpu_torch.recipes.steps import gmm_init_mono
    from khg_tpu_torch.recipes.synth import SAMPLE_RATE

    build = ROOT / "build" / "split"
    sources = {"A": "banded_viterbi.cu", "D": "banded_fb.cu", "E": "banded_fb.cu"}
    with ThreadPoolExecutor(3) as pool:
        futures = {k: pool.submit(build_variants, args.src / src, build,
                                  VARIANTS[args.design][k], f"{args.design}_{k}")
                   for k, src in sources.items() if k in want}
        libs = {k: f.result() for k, f in futures.items()}
    with tempfile.TemporaryDirectory(prefix="khg_split_") as tmp:
        corpus = chip_smoke.make_corpus(Path(tmp))
        from khg_tpu_torch.data.wav import read_wav

        waves = [read_wav(p)[0] for p in corpus.wav_paths]
        lens = [len(w) for w in waves]
    cfg = FbankConfig(sample_rate=SAMPLE_RATE, num_mel_bins=23)
    lp = Lexiconp.from_lexicon(Lexicon(word2phones=digits_lexicon())).add_lex_disambig()
    topo = generate_hmm_topo(non_sil_phones=lp.get_non_sil_phone_ids(),
                             sil_phone=lp.get_sil_phone_id())
    tm0, tree, _am = gmm_init_mono(
        topo, [np.random.default_rng(0).standard_normal((64, 23)).astype(np.float32)])
    graphs = compile_training_graphs(lp, tm0, tree, corpus.word_seqs)
    setup = (lp, tm0, tree, graphs, lens, cfg)
    stream = kernels.stream_handle(torch.device("cuda"))
    result = {"card": chip_smoke.card_line()}

    def call_a(lib, tables, offsets, ll, nf):
        B, DK, S = tables.plane_cost.shape
        T, P = ll.shape[1:]
        offs = torch.as_tensor(offsets, dtype=torch.int32, device="cuda")
        bp = torch.zeros((B, T, -(-S // 16) * 16), dtype=torch.int8, device="cuda")
        tids = torch.empty((B, T), dtype=torch.int32, device="cuda")
        cost = torch.empty((B,), dtype=torch.float32, device="cuda")

        def run():
            err = lib.launch_banded_viterbi(
                tables.plane_cost.data_ptr(), tables.plane_tid.data_ptr(),
                tables.state_pdf.data_ptr(), tables.init_cost.data_ptr(),
                tables.final_cost.data_ptr(), ll.data_ptr(), nf.data_ptr(),
                offs.data_ptr(), bp.data_ptr(), tids.data_ptr(), cost.data_ptr(),
                B, DK, S, T, P, 0.1, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        return run

    def shape_of(tables, ll, nf):
        B, DK, S = tables.plane_cost.shape
        return dict(B=B, T=ll.shape[1], S=S, DK=DK, P=ll.shape[2],
                    frames=int(nf.sum()), max_frames=int(nf.max()))

    def a_split(ms):
        if args.design == "parent":
            return dict(frame_loop=ms["frames"],
                        acoustic_gather=ms["frames"] - ms["frames_no_ll"],
                        argmin=ms["frames_argmin"] - ms["frames"],
                        backtrace=ms["whole"] - ms["frames_argmin"])
        return dict(frame_loop=ms["frames"],
                    acoustic_loads=ms["frames"] - ms["frames_no_ll"],
                    backpointers=ms["frames"] - ms["frames_no_bp"],
                    argmin=ms["frames_argmin"] - ms["frames"],
                    backtrace=ms["whole"] - ms["frames_argmin"])

    batches = {"A": chip_smoke.banded_batch(setup, fb=False)[1:5]} if "A" in want else {}
    if args.design == "compiled" and "A" in want:
        from khg_tpu_torch.align.banded_kernel import sac_tables

        tri = chip_smoke.tri_batch(chip_smoke.triphone_system())
        _m, tables, offsets, _x, lens, sac, *_rest = tri
        batches["A_sac"] = (sac_tables(tables), offsets, sac, lens)
    for name, (tables, offsets, ll, nf) in batches.items():
        ms = timed_in_turns({k: call_a(v, tables, offsets, ll, nf)
                             for k, v in libs["A"].items()})
        mf = int(nf.max())
        result[name] = dict(shape=shape_of(tables, ll, nf), variant_ms=ms,
                            split_ms=a_split(ms),
                            us_per_frame={k: v / mf * 1e3 for k, v in a_split(ms).items()})

    _p, tables, offsets, ll, nf, T, P = chip_smoke.banded_batch(setup, fb=True)
    B, DK, S = tables.plane_cost.shape
    offs = torch.as_tensor(offsets, dtype=torch.int32, device="cuda")
    alphas, log_z = banded_fb_fwd_cuda(tables, offsets, ll, nf, 0.1)
    alphas_d = torch.empty_like(alphas)
    log_z_d = torch.empty_like(log_z)

    def call_d(lib):
        def run():
            err = lib.launch_banded_fb_fwd(
                tables.plane_cost.data_ptr(), tables.state_pdf.data_ptr(),
                tables.init_cost.data_ptr(), tables.final_cost.data_ptr(),
                ll.data_ptr(), nf.data_ptr(), offs.data_ptr(), alphas_d.data_ptr(),
                log_z_d.data_ptr(), B, DK, S, T, P, 0.1, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        return run

    if "D" in want:
        ms = timed_in_turns({k: call_d(v) for k, v in libs["D"].items()})
        mf = int(nf.max())
        split = dict(frame_loop=ms["frames"], acoustic_loads=ms["frames"] - ms["frames_no_ll"],
                     log_z=ms["whole"] - ms["frames"])
        result["D"] = dict(shape=shape_of(tables, ll, nf), variant_ms=ms, split_ms=split,
                           us_per_frame=ms["whole"] / mf * 1e3,
                           frame_loop_us_per_frame=ms["frames"] / mf * 1e3)
    spost = torch.empty((B, T, S), dtype=torch.float32, device="cuda")
    apost = torch.empty((B, DK, S), dtype=torch.float32, device="cuda")

    def call_e(lib):
        def run():
            err = lib.launch_banded_fb_bwd(
                tables.plane_cost.data_ptr(), tables.state_pdf.data_ptr(),
                tables.final_cost.data_ptr(), ll.data_ptr(), nf.data_ptr(),
                offs.data_ptr(), alphas.data_ptr(), log_z.data_ptr(),
                spost.data_ptr(), apost.data_ptr(), B, DK, S, T, P, 0.1, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        return run

    if "E" in want:
        ms = timed_in_turns({k: call_e(v) for k, v in libs["E"].items()})
        if args.design == "parent":
            split = dict(alpha_load=ms["whole"] - ms["no_alpha_load"],
                         acoustic_load=ms["whole"] - ms["no_ll_load"],
                         apost_rmw=ms["whole"] - ms["no_apost_rmw"],
                         plane_loops=ms["plane_loops"])
        else:
            split = dict(posterior_exp=ms["whole"] - ms["no_posterior_exp"],
                         beta_sum=ms["whole"] - ms["no_beta_sum"],
                         alpha_copies=ms["whole"] - ms["no_alpha_copies"])
        result["E"] = dict(shape=shape_of(tables, ll, nf), variant_ms=ms, split_ms=split,
                           us_per_frame=ms["whole"] / int(nf.max()) * 1e3)
    if args.design == "compiled" and "F" in want:
        result["F"] = fold_split(chip_smoke, args.src, build)
    if args.design == "compiled" and "C" in want:
        result["C"] = fbank_split(chip_smoke, waves, args.src, build)
    if args.design == "compiled" and "G" in want:
        result["G"] = viterbi_kernels(chip_smoke, setup, args.src, build)
    result["latency_ns"] = chip_smoke.step_latencies()
    line = json.dumps(result)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
