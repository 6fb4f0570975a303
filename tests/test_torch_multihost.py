"""The port's multi-process set-up (khg_tpu_torch/parallel/multihost.py):
two real processes join a gloo group (``initialize`` on a FileStore
URL), take their shards (``process_shard``, ``make_global_batch``) and
run the sharded EM step and three passes of the resident loop
(tests/torch_multihost_worker.py, mode "multihost").  Their
all-reduced results are bit-identical on both processes and equal the
serial single-process run at tests/test_multihost.py's tolerances; a
process that fails or hangs fails the test within its timeout."""

import numpy as np
import pytest

from khg_tpu_torch.parallel import mesh as M
from khg_tpu_torch.parallel import multihost
from tests.test_torch_parallel import join_workers, spawn_workers
from tests.torch_multihost_worker import run_entry_points

REPLICATED = ("occ", "mean_acc", "var_acc", "tid_counts", "tot_log_like",
              "tot_frames", "new_gconsts", "new_weights")


@pytest.fixture(scope="module")
def two_process_outputs(problem, tmp_path_factory):
    return join_workers(spawn_workers("multihost", problem[2],
                                      tmp_path_factory.mktemp("mh")))


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    import pickle

    from tests.test_torch_parallel import make_problem
    from tests.torch_parity import port_copy

    port = port_copy(make_problem())
    path = tmp_path_factory.mktemp("mhp") / "problem.pkl"
    with open(path, "wb") as f:
        pickle.dump(port, f)
    return None, port, path


def test_two_process_sum_equals_serial(problem, two_process_outputs):
    p0, p1 = two_process_outputs
    for key in REPLICATED:
        np.testing.assert_array_equal(p0[f"em_dense.{key}"], p1[f"em_dense.{key}"],
                                      err_msg=key)
    for key in p0:
        if key.startswith("loop_dense."):
            np.testing.assert_array_equal(p0[key], p1[key], err_msg=key)
    assert p0["shard"].tolist() == [0, 4] and p1["shard"].tolist() == [4, 8]

    ref = run_entry_points(M.make_data_mesh(devices=["cpu"]), problem[1], 0, 8,
                           "multihost")
    got = {k.split(".", 1)[1]: v for k, v in p0.items() if k.startswith("em_dense.")}
    want = {k.split(".", 1)[1]: v for k, v in ref.items() if k.startswith("em_dense.")}
    np.testing.assert_allclose(got["occ"], want["occ"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["mean_acc"], want["mean_acc"], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got["var_acc"], want["var_acc"], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got["tid_counts"], want["tid_counts"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got["tot_log_like"]), float(want["tot_log_like"]),
                               rtol=1e-6)
    assert float(got["tot_frames"]) == float(want["tot_frames"])
    np.testing.assert_allclose(got["new_gconsts"], want["new_gconsts"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["new_weights"], want["new_weights"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(np.concatenate([p0["em_dense.tids"], p1["em_dense.tids"]]),
                                  want["tids"])
    for p in range(3):
        a, b = p0[f"loop_dense.packet{p}"], ref[f"loop_dense.packet{p}"]
        np.testing.assert_allclose(a[0], b[0], rtol=2e-5)
        np.testing.assert_allclose(a[1:], b[1:], rtol=0, atol=1e-3)
    np.testing.assert_allclose(p0["loop_dense.logp"], ref["loop_dense.logp"], rtol=0,
                               atol=1e-5)


def test_single_process_helpers():
    """Without a process group: initialize() does nothing for one
    process, the shard is everything, and make_global_batch hands the
    local arrays back as tensors in the same structure."""
    multihost.initialize(num_processes=1)
    assert multihost.process_shard(7) == (0, 7)
    mesh = multihost.global_data_mesh(devices=["cpu"])
    assert mesh.world_size == 1
    from khg_tpu_torch.align.packed import BatchedGraphs

    g = BatchedGraphs(*[np.full((2, 3), i, np.int32) for i in range(10)])
    g2, x = multihost.make_global_batch((g, np.ones((2, 4), np.float32)), mesh)
    assert type(g2) is BatchedGraphs and g2.out_tid.tolist() == [[5] * 3] * 2
    assert x.shape == (2, 4) and str(x.device) == "cpu"
