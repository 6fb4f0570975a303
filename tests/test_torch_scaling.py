"""The port's weak-scaling harness (khg_tpu_torch/parallel/scaling.py):
tests/test_scaling.py's two cases.  The curve covers the world sizes
the launch has, so the structure case runs in two gloo processes
(tests/torch_multihost_worker.py, mode "scaling"); the oversized-mesh
case runs here at world size 1.  As there, only the contract is pinned:
fixed per-rank batch, positive timings, efficiency normalised to the
1-rank throughput (CPU timings are noise)."""

import math

from tests.test_torch_parallel import join_workers, spawn_workers
from tests.torch_multihost_worker import problem_fn


def test_weak_scaling_curve_structure(tmp_path):
    import pickle

    from tests.test_torch_parallel import make_problem
    from tests.torch_parity import port_copy

    path = tmp_path / "problem.pkl"
    with open(path, "wb") as f:
        pickle.dump(port_copy(make_problem()), f)
    r0, r1 = join_workers(spawn_workers("scaling", path, tmp_path))
    records = r0["records"]
    assert records[:, 0].tolist() == [1, 2]
    assert records[:, 1].tolist() == [2, 4]            # batch = n * per_device_batch
    assert (records[:, 2] > 0).all() and (records[:, 3] > 0).all()
    assert all(0 < e < math.inf for e in records[:, 4])
    assert records[0, 4] == 100.0
    # rank 1 sits outside the 1-rank mesh and times only the 2-rank one
    assert r1["records"][:, 0].tolist() == [2]


def test_weak_scaling_skips_oversized_meshes(tmp_path):
    from khg_tpu_torch.parallel.scaling import weak_scaling_curve
    from tests.test_torch_parallel import make_problem
    from tests.torch_parity import port_copy

    records = weak_scaling_curve(problem_fn(port_copy(make_problem())), [1, 16],
                                 per_device_batch=2, iters=1, devices=["cpu"])
    assert [r["n_devices"] for r in records] == [1]
    assert records[0]["batch"] == 2 and records[0]["efficiency_pct"] == 100.0
