"""Weak-scaling efficiency of the sharded EM step (PyTorch port of
khg_tpu/parallel/scaling.py).

Weak scaling: the per-rank batch stays FIXED as the mesh grows; ideal
throughput is linear in the mesh size, efficiency(n) = throughput(n) /
(n * throughput(1)).  The curve covers the world sizes this launch has
(the initialised process group; world size 1 without one): run it on
every rank of a ``torchrun --nproc-per-node=<cards>`` launch, and sizes
beyond the world are skipped.
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence



def weak_scaling_curve(
    problem_fn: Callable[[int], tuple],
    mesh_sizes: Sequence[int],
    per_device_batch: int = 4,
    iters: int = 3,
    acoustic_scale: float = 0.1,
    devices=None,
    frames_per_sec: float = 100.0,
) -> List[dict]:
    """Time the full sharded EM step (parallel/mesh.sharded_em_step) at
    a fixed per-rank batch over increasing mesh sizes.

    ``problem_fn(num_utts)`` returns the global problem (model=(gconsts,
    miv, iv), weights, graph_arrays (dense BatchedGraphs), feats, lens,
    id2pdf) as arrays or tensors; each rank of an n-rank mesh takes
    rows [rank * per_device_batch, (rank + 1) * per_device_batch).
    ``devices`` names each rank's device (make_data_mesh).  Returns one
    record per mesh size: {"n_devices", "batch", "step_seconds",
    "audio_sec_per_s", "efficiency_pct"} (efficiency against the
    per-rank throughput of the smallest size measured); ranks outside a
    smaller mesh wait and record nothing for it."""
    from khg_tpu_torch.parallel.mesh import make_data_mesh, sharded_em_step
    from khg_tpu_torch.parallel.multihost import _rank_world, make_global_batch

    _rank, world = _rank_world()
    records = []
    base_tput = None
    for n in mesh_sizes:
        if n > world:
            continue
        mesh = make_data_mesh(n, devices=devices)
        if mesh.rank < 0:
            continue
        num_utts = n * per_device_batch
        model, weights, graph_arrays, feats, lens, id2pdf = problem_fn(num_utts)
        rows = slice(mesh.rank * per_device_batch, (mesh.rank + 1) * per_device_batch)

        g, f, ln = make_global_batch(
            (type(graph_arrays)(*(x[rows] for x in graph_arrays)), feats[rows],
             lens[rows]), mesh)
        m, ids = make_global_batch(((*model, weights), id2pdf), mesh)
        step = sharded_em_step(mesh, acoustic_scale=acoustic_scale)
        out = step(m, g, f, ln, ids)
        float(out.tot_log_like)  # warm up; the fetch waits for the device
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step(m, g, f, ln, ids)
        float(out.tot_log_like)
        step_s = (time.perf_counter() - t0) / iters
        audio_sec = float(lens[:num_utts].sum()) / frames_per_sec
        tput = audio_sec / step_s
        if base_tput is None:
            base_tput = tput / n
        records.append({
            "n_devices": n,
            "batch": num_utts,
            "step_seconds": round(step_s, 6),
            "audio_sec_per_s": round(tput, 2),
            "efficiency_pct": round(100.0 * tput / (n * base_tput), 1),
        })
    return records
