#!/usr/bin/env python3
"""Data-parallel EM across the cards of one host (parallel/mesh.py over
torch.distributed), one process per card:

    python -m torch.distributed.run --standalone --nproc-per-node=<cards> \
        tools/dp_cards.py [--utts-per-rank 256] [--batch-size 256] \
        [--out FILE] [--device cpu]

Every rank builds the same seeded problem: a synthetic digits corpus
(recipes/audiomnist.make_synthetic_digits_corpus, 23 dims, utts-per-rank
x world utterances), a flat-start monophone model split to 8 Gaussians a
pdf, graphs without transition probs, and the resident pass's batches
(EStepPipeline.device_batches, banded route).  Then:

1. ``weak_scaling_curve`` at 1, 2, 4, ... ranks up to the world,
   utts-per-rank utterances a rank, shards of equal length mix (the
   dense route, kernel G);
2. the sharded resident loop for 2 passes at the full world, each rank
   folding every world-th batch, timed per pass with its reduction
   (the reduction's wall includes waiting for the slowest rank);
   rank 0 then runs ``em_passes_resident`` over all batches in one
   process, and the two must give the same model and records to the
   bit (resident carries are f64, so the reduced sum does not depend on
   the grouping).

Rank 0 prints the card's nvidia-smi line and one JSON line of records,
and writes it to --out.  NCCL for CUDA (the default), gloo for
``--device cpu`` (a rehearsal without cards: the plain versions).  Every
collective has a 300 s timeout.
"""

from __future__ import annotations

import argparse
import datetime
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PASSES = 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_problem(num_utts: int, batch_size: int, device: str):
    """(pipeline, base packed graphs, feats, host model)."""
    from khg_tpu_torch.lang.topo import generate_hmm_topo
    from khg_tpu_torch.recipes.audiomnist import make_synthetic_digits_corpus
    from khg_tpu_torch.recipes.corpus_train import compile_training_graphs
    from khg_tpu_torch.recipes.pipeline import EStepPipeline
    from khg_tpu_torch.recipes.steps import gmm_init_mono

    rng = np.random.default_rng(11)
    lp, corpus = make_synthetic_digits_corpus(num_utts=num_utts, dim=23, rng=rng)
    topo = generate_hmm_topo(non_sil_phones=lp.get_non_sil_phone_ids(),
                             sil_phone=lp.get_sil_phone_id())
    tm, tree, am = gmm_init_mono(topo, corpus.feats)
    for p in range(am.num_pdfs):
        am.get_pdf(p).split(8, 0.1, rng=rng)
    graphs = compile_training_graphs(lp, tm, tree, corpus.word_seqs)
    pipe = EStepPipeline(
        tm, acoustic_scale=0.1, self_loop_scale=0.1, batch_size=batch_size,
        mix_pad_multiple=8, states_pad_multiple=256, frames_pad_multiple=256,
        align_backend="banded", device=device,
    )
    return pipe, pipe.pack_graphs_base(graphs), corpus.feats, am


def sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--utts-per-rank", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from khg_tpu_torch.align.packed import pack_graph_batch
    from khg_tpu_torch.est.mle import MleDiagGmmOptions
    from khg_tpu_torch.model.transition_device import build_transition_struct
    from khg_tpu_torch.model.transition_model import MleTransitionUpdateConfig
    from khg_tpu_torch.parallel import mesh as M
    from khg_tpu_torch.parallel.scaling import weak_scaling_curve

    cuda = args.device == "cuda"
    if cuda:
        import os

        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo",
                            timeout=datetime.timedelta(seconds=300),
                            device_id=torch.device("cuda", torch.cuda.current_device())
                            if cuda else None)
    rank, world = dist.get_rank(), dist.get_world_size()
    device = f"cuda:{torch.cuda.current_device()}" if cuda else "cpu"
    devices = [f"cuda:{r % torch.cuda.device_count()}" for r in range(world)] \
        if cuda else ["cpu"] * world
    try:
        t0 = time.perf_counter()
        pipe, base, feats, am = build_problem(args.utts_per_rank * world,
                                              args.batch_size, device)
        setup_s = time.perf_counter() - t0
        model = pipe.pack_model_device(am)
        order = sorted(range(len(feats)), key=lambda i: feats[i].shape[0])

        # 1. weak scaling over the world sizes this launch has; rank r of
        # n takes rows [r * per_rank, (r + 1) * per_rank), so deal the
        # length-sorted utterances round-robin: every shard spans the
        # same lengths (contiguous shards of a sorted list would hand the
        # last rank the longest utterances, and a step waits for it)
        def problem(num_utts):
            n = num_utts // args.utts_per_rank
            idx = [order[i] for r in range(n) for i in range(r, num_utts, n)]
            sub = [feats[i] for i in idx]
            x = np.zeros((num_utts, max(f.shape[0] for f in sub), sub[0].shape[1]),
                         np.float32)
            for j, f in enumerate(sub):
                x[j, : f.shape[0]] = f
            refreshed = pipe.refresh_transition_costs([base[i] for i in idx])
            g = pack_graph_batch(refreshed, states_pad_to=256, indeg_pad_to=2)
            lens = np.array([f.shape[0] for f in sub], np.int32)
            return model[:3], model[3], g, x, lens, pipe._id2pdf_t

        sizes = [n for n in (1, 2, 4, 8) if n <= world]
        curve = weak_scaling_curve(problem, sizes, per_device_batch=args.utts_per_rank,
                                   iters=10, acoustic_scale=0.1, devices=devices)

        # 2. the sharded resident loop at the full world
        mesh = M.make_data_mesh(devices=devices)
        batches = pipe.device_batches(base, feats)
        mine = batches[rank::world]
        struct = build_transition_struct(pipe.tm)
        P, K = model[0].shape
        loop = M.sharded_resident_em_loop(
            mesh, P, K, model[1].shape[-1], struct.num_tids, struct,
            acoustic_scale=0.1, transition_scale=1.0, self_loop_scale=0.1,
            mle_config=MleDiagGmmOptions())
        logp = torch.as_tensor(np.asarray(pipe.tm.log_probs, np.float32), device=device)
        delta = loop.delta(logp)
        m, packets, pass_s, reduce_s = model, [], [], []
        for _ in range(PASSES):
            sync(device)
            t0 = time.perf_counter()
            carry, comp = loop.make_carry()
            for bfeats, lens, graphs, banded, _sp in mine:
                tables, offsets = banded if banded is not None else (graphs, None)
                carry, comp = loop.fold(m, delta, carry, comp, tables, bfeats, lens,
                                        pipe._id2pdf_t, offsets=offsets)
            sync(device)
            t1 = time.perf_counter()
            M._reduce_carry(mesh, carry, comp)
            sync(device)
            reduce_s.append(time.perf_counter() - t1)
            m, logp, delta, packet = loop.finish(m, carry, comp, logp)
            packets.append(packet.cpu().numpy().astype(np.float64))
            pass_s.append(time.perf_counter() - t0)
        dist.barrier()
        record = None
        if rank == 0:
            sync(device)
            t0 = time.perf_counter()
            m_ref, rec = pipe.em_passes_resident(
                model, base, feats, PASSES, mle_config=MleDiagGmmOptions(),
                transition_cfg=MleTransitionUpdateConfig())
            one_s = time.perf_counter() - t0
            pk = np.stack(packets)
            n = pk.shape[1]
            same_model = all(torch.equal(a, b) for a, b in zip(m, m_ref))
            same_records = bool((pk[:, 0] == rec[:, 0]).all()
                                and (pk[:, n - 4:] == rec[:, 2:6]).all())
            record = dict(
                card=card_line() if cuda else "cpu", world=world,
                utterances=len(feats), batches=len(batches),
                frames=int(sum(f.shape[0] for f in feats)), setup_s=setup_s,
                weak_scaling=curve, sharded_pass_s=pass_s,
                reduction_ms=[s * 1e3 for s in reduce_s],
                single_process_2_passes_s=one_s,
                model_bit_equal=same_model, records_bit_equal=same_records,
                avg_loglike=(pk[:, 0] / pk[:, 1]).tolist(),
            )
            print(record["card"], flush=True)
            print(json.dumps(record), flush=True)
            if args.out is not None:
                args.out.parent.mkdir(parents=True, exist_ok=True)
                args.out.write_text(json.dumps(record, indent=1))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0 and not (record["model_bit_equal"] and record["records_bit_equal"]):
        print("dp_cards: the sharded loop differs from em_passes_resident",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
