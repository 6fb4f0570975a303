"""Worker process of the port's multi-process data-parallel tests
(tests/test_torch_parallel.py, tests/test_torch_multihost.py).

Run as:  python tests/torch_multihost_worker.py MODE INIT_URL RANK WORLD PROBLEM.pkl OUT.npz

Joins a gloo process group (``parallel/multihost.initialize`` with a
``file://`` FileStore URL), takes its shard of the problem's utterances
(``process_shard``, ``make_global_batch``), runs the sharded entry
points (MODE "all": every one; "multihost": the EM step and the
resident loop) and writes their outputs; MODE "scaling" runs
parallel/scaling.weak_scaling_curve at sizes 1 and 2 instead.  It imports khg_tpu_torch and
numpy only: the card's machine has no JAX.  The test process calls
``run_entry_points`` itself for the world-size-1 runs.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from khg_tpu_torch.parallel import mesh as M  # noqa: E402
from khg_tpu_torch.parallel import multihost  # noqa: E402

ACOUSTIC_SCALE = 0.5
SELF_LOOP_SCALE = 0.1


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _halves(batch, lo, hi):
    """The rows [lo, hi) of each array in ``batch``, as two sub-batches
    (the resident folds carry across batches)."""
    mid = (lo + hi) // 2
    return [tuple(type(a)(*(x[s] for x in a)) if hasattr(a, "_fields") else a[s]
                  for a in batch)
            for s in (slice(lo, mid), slice(mid, hi))]


def run_entry_points(mesh, prob, lo, hi, mode="all"):
    """Every sharded entry point on the utterances [lo, hi) of ``prob``
    (this rank's shard); returns {name: numpy array}."""
    out = {}
    mg = lambda x: multihost.make_global_batch(x, mesh)  # noqa: E731
    model = mg((prob["gconsts"], prob["miv"], prob["iv"], prob["weights"]))
    id2pdf = mg(prob["id2pdf"].astype(np.int64))
    num_tids = int(prob["struct"].num_tids)

    def shard(*names):
        return mg(tuple(
            type(prob[n])(*(np.asarray(x)[lo:hi] for x in prob[n]))
            if hasattr(prob[n], "_fields") else prob[n][lo:hi] for n in names))

    def keep(prefix, res):
        for k, v in res._asdict().items():
            out[f"{prefix}.{k}"] = _np(v)

    graphs, banded, feats, lens = shard("graphs", "banded", "feats", "lens")
    offs = prob["offsets"]
    keep("em_dense", M.sharded_em_step(mesh, ACOUSTIC_SCALE)(
        model, graphs, feats, lens, id2pdf))

    loop = M.sharded_resident_em_loop(
        mesh, *prob["gconsts"].shape, prob["miv"].shape[-1], num_tids,
        prob["struct"], acoustic_scale=ACOUSTIC_SCALE, transition_scale=1.0,
        self_loop_scale=SELF_LOOP_SCALE,
    )
    (base,) = shard("base_graphs")
    lmodel, logp = model, mg(prob["logp"])
    delta = loop.delta(logp)
    for p in range(3):
        carry, comp = loop.make_carry()
        carry, comp = loop.fold(lmodel, delta, carry, comp, base, feats, lens, id2pdf)
        lmodel, logp, delta, packet = loop.finish(lmodel, carry, comp, logp)
        out[f"loop_dense.packet{p}"] = _np(packet)
    for name, x in zip(("gconsts", "miv", "iv", "weights"), lmodel):
        out[f"loop_dense.{name}"] = _np(x)
    out["loop_dense.logp"] = _np(logp)
    if mode == "multihost":
        return out

    keep("em_banded", M.sharded_em_step(mesh, ACOUSTIC_SCALE, banded_offsets=offs)(
        model, banded, feats, lens, id2pdf))
    keep("em_wide", M.sharded_em_step(
        mesh, ACOUSTIC_SCALE, banded_offsets=offs, per_state=True)(
        model, banded, feats, lens, id2pdf))
    keep("fb_dense", M.sharded_fb_em_step(
        mesh, num_tids, ACOUSTIC_SCALE, uniform_dest_pdf=True)(
        model, graphs, feats, lens))
    (fb_banded,) = shard("fb_banded")
    keep("fb_banded", M.sharded_fb_em_step(
        mesh, num_tids, ACOUSTIC_SCALE, banded_offsets=prob["fb_offsets"])(
        model, fb_banded, feats, lens))

    P, K = prob["gconsts"].shape
    D = prob["miv"].shape[-1]
    for name, g, kw in (("res_dense", "graphs", {}),
                        ("res_wide", "banded", dict(banded_offsets=offs,
                                                    per_state=True))):
        r = M.sharded_resident_em(mesh, P, K, D, num_tids,
                                  acoustic_scale=ACOUSTIC_SCALE, **kw)
        carry, comp = r.make_carry()
        for gg, f, ln in _halves((prob[g], prob["feats"], prob["lens"]), lo, hi):
            gg, f, ln = mg((gg, f, ln))
            carry, comp = r.fold(model, carry, comp, gg, f, ln, id2pdf)
        new_model, packet = r.finish(model, carry, comp)
        out[f"{name}.packet"] = _np(packet)
        for nm, x in zip(("gconsts", "miv", "iv", "weights"), new_model):
            out[f"{name}.{nm}"] = _np(x)

    for name, g, offsets in (("fbloop_banded", "fb_base_banded", prob["fb_offsets"]),
                             ("fbloop_dense", "base_graphs", None)):
        loop = M.sharded_resident_fb_em_loop(
            mesh, P, K, D, num_tids, prob["struct"], acoustic_scale=ACOUSTIC_SCALE,
            transition_scale=1.0, self_loop_scale=SELF_LOOP_SCALE,
            uniform_dest_pdf=True, banded_offsets=offsets,
        )
        (gg,) = shard(g)
        lmodel, logp = model, mg(prob["logp"])
        delta = loop.delta(logp)
        for _p in range(2):
            carry, comp = loop.make_carry()
            carry, comp = loop.fold(lmodel, delta, carry, comp, gg, feats, lens)
            lmodel, logp, delta, packet = loop.finish(lmodel, carry, comp, logp)
        out[f"{name}.packet"] = _np(packet)
        out[f"{name}.logp"] = _np(logp)
        for nm, x in zip(("gconsts", "miv", "iv", "weights"), lmodel):
            out[f"{name}.{nm}"] = _np(x)
    return out


def problem_fn(prob):
    """weak_scaling_curve's problem: the first ``num_utts`` utterances
    of ``prob`` (model, weights, dense tables, feats, lens, id2pdf)."""

    def fn(num_utts):
        rows = slice(0, num_utts)
        graphs = type(prob["graphs"])(*(np.asarray(x)[rows] for x in prob["graphs"]))
        return ((prob["gconsts"], prob["miv"], prob["iv"]), prob["weights"], graphs,
                prob["feats"][rows], prob["lens"][rows], prob["id2pdf"].astype(np.int64))

    return fn


def main(argv):
    mode, init_url, rank, world, prob_path, out_path = argv
    multihost.initialize(init_url, int(world), int(rank), backend="gloo")
    with open(prob_path, "rb") as f:
        prob = pickle.load(f)
    if mode == "scaling":
        from khg_tpu_torch.parallel.scaling import weak_scaling_curve

        records = weak_scaling_curve(problem_fn(prob), [1, 2], per_device_batch=2,
                                     iters=1, devices=["cpu"] * int(world))
        np.savez(out_path, records=np.array([[r["n_devices"], r["batch"],
                                              r["step_seconds"], r["audio_sec_per_s"],
                                              r["efficiency_pct"]] for r in records]))
        torch.distributed.destroy_process_group()
        return
    mesh = multihost.global_data_mesh(devices=["cpu"] * int(world))
    assert (mesh.rank, mesh.world_size) == (int(rank), int(world))
    lo, hi = multihost.process_shard(len(prob["feats"]))
    out = run_entry_points(mesh, prob, lo, hi, mode)
    out["shard"] = np.array([lo, hi])
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()
    print(f"worker {rank}: shard [{lo},{hi}) done", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1:])
