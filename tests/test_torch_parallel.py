"""The port's data-parallel EM (khg_tpu_torch/parallel/mesh.py) against
khg_tpu's mesh, on the CPU.

Every sharded entry point runs at world size 1 (a single-process gloo
group on a FileStore, in this process) and at world size 2 (two
processes spawned once for the module by tests/torch_multihost_worker.py,
each on its half of the utterances), and is held to khg_tpu's
shard_map on a 1- and a 2-device mesh (the conftest's virtual CPU
devices).  Each rank's alignments equal the world-1 run's rows bit for
bit, and the replicated outputs are bit-identical on both ranks.

Tolerances are tests/test_parallel.py's for the same quantity
(``TOL``): stats 1e-4 (sharding invariance), packets' log-likelihood
2e-5 relative and tid counts 1e-3, models 1e-5 (resident pass) or
2e-4 after three passes with the transition update (resident loop),
transition log-probs 1e-5, log Z 1e-5 relative.  Costs, which
test_parallel.py compares within one package at 0, are held to 1e-5
relative: the two packages' f32 products round differently."""

import copy
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from khg_tpu.align.banded import band_renumber, pack_banded
from khg_tpu.align.packed import pack_graph, pack_graph_batch, uniform_dest_pdf
from khg_tpu.graph.h_builder import add_transition_probs
from khg_tpu.model.transition_device import build_transition_struct
from khg_tpu.parallel import mesh as J
from khg_tpu_torch.parallel import mesh as M
from tests.test_align import random_am
from tests.test_graph_compiler import build_yesno_like
from tests.torch_multihost_worker import ACOUSTIC_SCALE, SELF_LOOP_SCALE, run_entry_points
from tests.torch_parity import port_copy

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_multihost_worker.py"
N_UTTS, T, DIM = 8, 24, 6
MODEL = ("gconsts", "miv", "iv", "weights")


def make_problem():
    """8 yesno-like utterances with random features and a random
    2-Gaussian model; dense tables with and without the transition
    probs, banded tables (Viterbi and forward-backward packings)."""
    lp, topo, tree, tm, gc = build_yesno_like()
    rng = np.random.default_rng(0)
    am = random_am(tree.num_pdfs, DIM, rng, max_mix=2)
    id2pdf = tm.id2pdf_array()
    base, with_probs = [], []
    for i in range(N_UTTS):
        words = [lp.word2id["YES" if (i + j) % 2 else "NO"] for j in range(2 + i % 2)]
        g = gc.compile_graph_from_text(words).copy()
        base.append(pack_graph(g.copy(), id2pdf))
        add_transition_probs(tm, g, 1.0, SELF_LOOP_SCALE)
        with_probs.append(pack_graph(g, id2pdf))
    graphs = pack_graph_batch(with_probs, states_pad_to=8, indeg_pad_to=2)
    base_graphs = pack_graph_batch(base, states_pad_to=8, indeg_pad_to=2)
    ren, _ = band_renumber(graphs)
    banded, offsets = pack_banded(ren, uniform_dest_pdf(ren))
    fb_banded, fb_offsets = pack_banded(ren, uniform_dest_pdf(ren), reject_parallel=True)
    bren, _ = band_renumber(base_graphs)
    fb_base_banded, fb_base_offsets = pack_banded(
        bren, uniform_dest_pdf(bren), reject_parallel=True)
    assert fb_base_offsets == fb_offsets
    pm = am.pack(mix_pad_to=2)
    weights = np.zeros(pm.gconsts.shape, dtype=np.float32)
    for p in range(am.num_pdfs):
        weights[p, : am.get_pdf(p).num_gauss] = am.get_pdf(p).weights
    return dict(
        gconsts=np.asarray(pm.gconsts), miv=np.asarray(pm.means_invvars),
        iv=np.asarray(pm.inv_vars), weights=weights, id2pdf=id2pdf,
        graphs=graphs, base_graphs=base_graphs, banded=banded, offsets=offsets,
        fb_banded=fb_banded, fb_base_banded=fb_base_banded, fb_offsets=fb_offsets,
        feats=rng.standard_normal((N_UTTS, T, DIM)).astype(np.float32),
        lens=np.array([T - (i % 3) for i in range(N_UTTS)], np.int32),
        logp=np.asarray(tm.log_probs, np.float32),
        struct=build_transition_struct(tm),
    )


def _halves(x):
    return [jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[s]), x)
            for s in (slice(0, N_UTTS // 2), slice(N_UTTS // 2, N_UTTS))]


def jax_reference(prob, n):
    """Every entry point through khg_tpu on an n-device mesh, in the
    worker's output layout."""
    mesh = J.make_data_mesh(n, devices=jax.devices("cpu")[:n])
    tree = lambda x: jax.tree.map(jnp.asarray, x)  # noqa: E731
    model = tuple(jnp.asarray(prob[k]) for k in MODEL)
    feats, lens, id2pdf = map(jnp.asarray, (prob["feats"], prob["lens"], prob["id2pdf"]))
    P, K = prob["gconsts"].shape
    num_tids = int(prob["struct"].num_tids)
    offs, fb_offs = prob["offsets"], prob["fb_offsets"]
    out = {}

    def keep(prefix, res):
        for k, v in res._asdict().items():
            out[f"{prefix}.{k}"] = np.asarray(v)

    keep("em_dense", J.sharded_em_step(mesh, ACOUSTIC_SCALE)(
        model, tree(prob["graphs"]), feats, lens, id2pdf))
    keep("em_banded", J.sharded_em_step(
        mesh, ACOUSTIC_SCALE, banded_offsets=offs, banded_interpret=True)(
        model, tree(prob["banded"]), feats, lens, id2pdf))
    keep("em_wide", J.sharded_em_step(
        mesh, ACOUSTIC_SCALE, banded_offsets=offs, banded_interpret=True,
        per_state=True)(model, tree(prob["banded"]), feats, lens, id2pdf))
    keep("fb_dense", J.sharded_fb_em_step(
        mesh, num_tids, ACOUSTIC_SCALE, uniform_dest_pdf=True)(
        model, tree(prob["graphs"]), feats, lens))
    keep("fb_banded", J.sharded_fb_em_step(
        mesh, num_tids, ACOUSTIC_SCALE, banded_offsets=fb_offs, banded_interpret=True)(
        model, tree(prob["fb_banded"]), feats, lens))

    for name, g, kw in (("res_dense", "graphs", {}),
                        ("res_wide", "banded", dict(banded_offsets=offs,
                                                    banded_interpret=True,
                                                    per_state=True))):
        r = J.sharded_resident_em(mesh, P, K, DIM, num_tids,
                                  acoustic_scale=ACOUSTIC_SCALE, **kw)
        carry, comp = r.make_carry()
        for gg, f, ln in _halves((prob[g], prob["feats"], prob["lens"])):
            carry, comp = r.fold(model, carry, comp, gg, f, ln, id2pdf)
        new_model, packet = r.finish(model, carry, comp)
        out[f"{name}.packet"] = np.asarray(packet)
        for nm, x in zip(MODEL, new_model):
            out[f"{name}.{nm}"] = np.asarray(x)

    loop = J.sharded_resident_em_loop(
        mesh, P, K, DIM, num_tids, prob["struct"], acoustic_scale=ACOUSTIC_SCALE,
        transition_scale=1.0, self_loop_scale=SELF_LOOP_SCALE,
    )
    lmodel, logp = model, jnp.asarray(prob["logp"])
    delta = loop.delta(logp)
    for p in range(3):
        carry, comp = loop.make_carry()
        carry, comp = loop.fold(lmodel, delta, carry, comp, tree(prob["base_graphs"]),
                                feats, lens, id2pdf)
        lmodel, logp, delta, packet = loop.finish(lmodel, carry, comp, logp)
        out[f"loop_dense.packet{p}"] = np.asarray(packet)
    for nm, x in zip(MODEL, lmodel):
        out[f"loop_dense.{nm}"] = np.asarray(x)
    out["loop_dense.logp"] = np.asarray(logp)

    for name, g, kw in (("fbloop_banded", "fb_base_banded",
                         dict(banded_offsets=fb_offs, banded_interpret=True)),
                        ("fbloop_dense", "base_graphs", {})):
        loop = J.sharded_resident_fb_em_loop(
            mesh, P, K, DIM, num_tids, prob["struct"], acoustic_scale=ACOUSTIC_SCALE,
            transition_scale=1.0, self_loop_scale=SELF_LOOP_SCALE,
            uniform_dest_pdf=True, **kw,
        )
        lmodel, logp = model, jnp.asarray(prob["logp"])
        delta = loop.delta(logp)
        for _p in range(2):
            carry, comp = loop.make_carry()
            carry, comp = loop.fold(lmodel, delta, carry, comp, tree(prob[g]), feats, lens)
            lmodel, logp, delta, packet = loop.finish(lmodel, carry, comp, logp)
        out[f"{name}.packet"] = np.asarray(packet)
        out[f"{name}.logp"] = np.asarray(logp)
        for nm, x in zip(MODEL, lmodel):
            out[f"{name}.{nm}"] = np.asarray(x)
    return out


# (rtol, atol) by output field; see the module docstring
TOL = {
    "total_cost": (1e-5, 1e-4), "log_z": (1e-5, 1e-5),
    "occ": (1e-4, 1e-4), "mean_acc": (1e-4, 1e-4), "var_acc": (1e-4, 1e-4),
    "tid_counts": (1e-4, 1e-4), "tot_log_like": (1e-4, 1e-4),
    "tot_frames": (1e-4, 1e-4),
    "logp": (0, 1e-5),
}
MODEL_TOL = {"loop_dense": (2e-4, 2e-4), "fbloop_banded": (2e-4, 2e-4),
             "fbloop_dense": (2e-4, 2e-4)}


def _check(got, ref, n):
    for key, want in ref.items():
        name, field = key.split(".")
        have = got[key]
        if field in ("tids", "failed") or (field, name[:2]) == ("tot_frames", "em"):
            np.testing.assert_array_equal(have, want, err_msg=key)
            continue
        if field.startswith("packet"):
            # [tot_ll, tot_frames, tid counts..., like_sum, done, error, frames]
            np.testing.assert_allclose(have[0], want[0], rtol=2e-5, err_msg=key)
            np.testing.assert_allclose(have[1:], want[1:], rtol=0, atol=1e-3, err_msg=key)
            continue
        if field in TOL:
            rtol, atol = TOL[field]
        else:  # the new model
            rtol, atol = MODEL_TOL.get(name, (1e-5, 1e-5))
        np.testing.assert_allclose(have, want, rtol=rtol, atol=atol,
                                   err_msg=f"{key} (world {n})")


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    prob = make_problem()
    path = tmp_path_factory.mktemp("par") / "problem.pkl"
    port = port_copy({k: v for k, v in prob.items()})
    with open(path, "wb") as f:
        pickle.dump(port, f)
    return prob, port, path


@pytest.fixture(scope="module")
def world1(problem, tmp_path_factory):
    """World size 1: a single-process gloo group in this process."""
    _prob, port, _path = problem
    store = tmp_path_factory.mktemp("w1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = M.make_data_mesh(devices=["cpu"])
        assert mesh.group is not None and mesh.world_size == 1
        return run_entry_points(mesh, port, 0, N_UTTS)
    finally:
        dist.destroy_process_group()


def spawn_workers(mode, prob_path, d, world=2):
    """Start ``world`` worker processes on a FileStore in ``d``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    procs = []
    for rank in range(world):
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), mode, f"file://{d / 'store'}", str(rank),
             str(world), str(prob_path), str(d / f"rank{rank}.npz")],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ), d / f"rank{rank}.npz"))
    return procs


def join_workers(procs, timeout=240):
    """Each worker's outputs; a worker that fails or outlives
    ``timeout`` seconds fails the test (all are killed first)."""
    logs = []
    for p, _out in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q, _o in procs:
                q.kill()
            logs.append(p.communicate()[0].decode(errors="replace"))
    for (p, _out), log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return [dict(np.load(out)) for _p, out in procs]


@pytest.fixture(scope="module")
def world2_procs(problem, tmp_path_factory):
    """World size 2: two worker processes, started once for the module
    (before the khg_tpu references, which they overlap), each running
    every entry point on its half of the utterances."""
    procs = spawn_workers("all", problem[2], tmp_path_factory.mktemp("w2"))
    yield procs
    for p, _out in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def world2(world2_procs):
    return join_workers(world2_procs)


@pytest.fixture(scope="module")
def references(problem, world2_procs):
    prob, _port, _path = problem
    return {n: jax_reference(prob, n) for n in (1, 2)}


def test_world1_matches_khg_tpu_one_device(world1, references):
    _check(world1, references[1], 1)


def test_world2_matches_khg_tpu_two_devices(world2, references):
    ref = references[2]
    for rank, got in enumerate(world2):
        lo, hi = got["shard"]
        assert (lo, hi) == (rank * N_UTTS // 2, (rank + 1) * N_UTTS // 2)
        sharded = {k: v[lo:hi] if k.split(".")[1] in ("tids", "total_cost", "log_z",
                                                      "failed") else v
                   for k, v in ref.items()}
        _check(got, sharded, 2)


def test_world2_ranks_bit_identical_and_tids_equal_world1(world1, world2):
    r0, r1 = world2
    for key in r0:
        field = key.split(".")[-1]
        if key == "shard" or field in ("tids", "total_cost", "log_z", "failed"):
            continue
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    for r in world2:
        lo, hi = r["shard"]
        for key in ("em_dense.tids", "em_banded.tids", "em_wide.tids"):
            np.testing.assert_array_equal(r[key], world1[key][lo:hi], err_msg=key)


def test_world2_sums_equal_world1(world1, world2):
    """The all-reduced sums of two ranks equal the serial sums."""
    _check(world2[0], {k: v for k, v in world1.items()
                       if k.split(".")[1] not in ("tids", "total_cost", "log_z",
                                                  "failed")}, 2)


def test_unpack_resident_packet_on_a_khg_tpu_packet(problem, references):
    num_tids = len(problem[0]["id2pdf"]) - 1
    packet = references[2]["res_dense.packet"]
    got = M.unpack_resident_packet(packet, num_tids)
    want = J.unpack_resident_packet(packet, num_tids)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1] == N_UTTS * T - sum(i % 3 for i in range(N_UTTS))
    assert got[4] == N_UTTS and got[5] == 0
    got_t = M.unpack_resident_packet(torch.tensor(packet), num_tids)
    for a, b in zip(got_t, want):
        np.testing.assert_array_equal(a, b)


def test_make_data_mesh_without_a_group():
    mesh = M.make_data_mesh(devices=["cpu"])
    assert (mesh.group, mesh.rank, mesh.world_size) == (None, 0, 1)
    x = torch.arange(3.0)
    assert torch.equal(mesh.all_reduce(x), x)
    with pytest.raises(ValueError):
        M.make_data_mesh(2, devices=["cpu"])


@pytest.fixture(scope="module")
def port_system():
    """A small trained yesno system of the port (CPU): the transition
    model, GMM and graphs the pipeline and the sharded loops share."""
    from khg_tpu_torch.recipes.yesno import make_synthetic_corpus, train_yesno

    lp, corpus = make_synthetic_corpus(num_utts=7, dim=8,
                                       rng=np.random.default_rng(11))
    result = train_yesno(lp, corpus, num_iters=3, total_gauss=22, max_iter_inc=2,
                         realign_iters="1 2", device="cpu")
    return corpus, result


@pytest.mark.parametrize("like", ["xla", "pallas"])
@pytest.mark.parametrize("align", ["banded", "xla"])
@pytest.mark.parametrize("fb", [False, True], ids=["hard", "soft"])
def test_sharded_loop_equals_the_pipelines_passes(port_system, monkeypatch, fb,
                                                  align, like):
    """A rank's batches go through the pipeline's own per-batch
    functions: at world size 1, folding EStepPipeline.device_batches,
    two passes of the sharded loop equal em_passes_resident (or
    fb_em_passes_resident) to the bit, for each route and likelihood
    backend, and score through the fused loglikes entry (kernel B on
    the card, its plain version here) exactly as often as the pipeline
    does: every batch with "pallas", never with "xla"."""
    from khg_tpu_torch.est.mle import MleDiagGmmOptions
    from khg_tpu_torch.model.transition_device import build_transition_struct
    from khg_tpu_torch.model.transition_model import MleTransitionUpdateConfig
    from khg_tpu_torch.recipes import pipeline as port_pipeline
    from khg_tpu_torch.recipes.pipeline import EStepPipeline

    fused_calls = []
    fused = port_pipeline.loglikes_fused
    monkeypatch.setattr(port_pipeline, "loglikes_fused",
                        lambda *a, **k: fused_calls.append(1) or fused(*a, **k))
    corpus, result = port_system
    opts, tcfg = MleDiagGmmOptions(), MleTransitionUpdateConfig()
    kw = dict(acoustic_scale=1.0, self_loop_scale=1.0 if fb else 0.1, batch_size=3,
              align_backend=align, likelihood_backend=like, device="cpu")
    ref = EStepPipeline(copy.deepcopy(result.transition_model), **kw)
    base = ref.pack_graphs_base(result.graphs)
    passes = ref.fb_em_passes_resident if fb else ref.em_passes_resident
    m_ref, rec = passes(ref.pack_model_device(result.am), base, corpus.feats, 2,
                        mle_config=opts, transition_cfg=tcfg)
    ref_calls, fused_calls[:] = len(fused_calls), []

    pipe = EStepPipeline(copy.deepcopy(result.transition_model), **kw)
    batches = pipe.device_batches(base, corpus.feats, fb=fb)
    assert any(b[3] is not None for b in batches) == (align == "banded")
    struct = build_transition_struct(pipe.tm)
    model = pipe.pack_model_device(result.am)
    make = M.sharded_resident_fb_em_loop if fb else M.sharded_resident_em_loop
    loop = make(M.make_data_mesh(devices=["cpu"]), *model[0].shape,
                model[1].shape[-1], struct.num_tids, struct,
                acoustic_scale=pipe.acoustic_scale,
                transition_scale=pipe.transition_scale,
                self_loop_scale=pipe.self_loop_scale, uniform_dest_pdf=fb,
                mle_config=opts, transition_cfg=tcfg, likelihood_backend=like)
    logp = torch.as_tensor(np.asarray(pipe.tm.log_probs, np.float32))
    delta = loop.delta(logp)
    packets = []
    for _ in range(2):
        carry, comp = loop.make_carry()
        for bfeats, lens, graphs, banded, state_pdf in batches:
            assert not fb or banded is not None or state_pdf is not None
            tables, offsets = banded if banded is not None else (graphs, None)
            args = (bfeats, lens) if fb else (bfeats, lens, pipe._id2pdf_t)
            carry, comp = loop.fold(model, delta, carry, comp, tables, *args,
                                    offsets=offsets)
        model, logp, delta, packet = loop.finish(model, carry, comp, logp)
        packets.append(packet.numpy().astype(np.float64))
    packets = np.stack(packets)
    assert len(fused_calls) == ref_calls == (2 * len(batches) if like == "pallas" else 0)
    for a, b in zip(model, m_ref):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(packets[:, :2], rec[:, :2])
    np.testing.assert_array_equal(packets[:, -4:], rec[:, 2:6])
    np.testing.assert_array_equal(logp.numpy()[1:], ref.tm.log_probs[1:])
    assert rec[:, 4].sum() == 0
