"""The non-banded Viterbi kernel's plain version (align/viterbi_kernel.py,
what csrc/viterbi.cu computes operation for operation) against khg_tpu's
Pallas Viterbi kernel in interpret mode, on tests/test_pallas_viterbi.py's
batch: costs bit-equal, tids equal, the infeasible utterance failed."""

import numpy as np
import pytest
import torch

from khg_tpu.align.pallas_viterbi import viterbi_align_batch_pallas
from khg_tpu_torch.align.viterbi import viterbi_align_batch
from khg_tpu_torch.align.viterbi_kernel import (
    viterbi_cuda,
    viterbi_plain,
    viterbi_plan,
)
from khg_tpu_torch.utils.convert import batched_graphs_to_torch
from tests.test_align import setup  # noqa: F401
from tests.test_pallas_viterbi import _batch
import tests.torch_parity  # noqa: F401  (two torch threads per worker)


def _words(lp, *seqs):
    return [[lp.word2id[w] for w in s] for s in seqs]


def _port_args(arrays, ll, nf):
    return (batched_graphs_to_torch(arrays, "cpu"), torch.as_tensor(np.array(ll)),
            torch.as_tensor(nf))


@pytest.mark.parametrize("scale", [0.5, 0.1])
def test_plain_matches_pallas_interpret(setup, scale):  # noqa: F811
    lp = setup[0]
    words = _words(lp, ["YES"], ["NO", "NO"], ["YES", "NO"])
    lens = [12, 19, 30]
    _graphs, arrays, ll, nf, id2pdf = _batch(setup, lens, words)
    ref = viterbi_align_batch_pallas(
        arrays, ll, nf, id2pdf, acoustic_scale=scale,
        block_b=2, time_chunk=16, lane=8, interpret=True,
    )
    tids, cost = viterbi_plain(*_port_args(arrays, ll, nf), scale)
    np.testing.assert_array_equal(cost.numpy(), np.asarray(ref.total_cost))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ref.tids))
    res = viterbi_align_batch(*_port_args(arrays, ll, nf),
                              torch.as_tensor(id2pdf), acoustic_scale=scale)
    assert not res.failed.any()
    np.testing.assert_array_equal(res.total_cost.numpy(), np.asarray(ref.total_cost))
    np.testing.assert_allclose(res.acoustic_cost.numpy(),
                               np.asarray(ref.acoustic_cost), rtol=1e-6)


def test_plain_infeasible_fails(setup):  # noqa: F811
    lp = setup[0]
    _graphs, arrays, ll, nf, id2pdf = _batch(setup, [3], _words(lp, ["YES", "NO"]))
    ref = viterbi_align_batch_pallas(
        arrays, ll, nf, id2pdf, acoustic_scale=0.5,
        block_b=1, time_chunk=8, lane=8, interpret=True,
    )
    res = viterbi_align_batch(*_port_args(arrays, ll, nf),
                              torch.as_tensor(id2pdf), acoustic_scale=0.5)
    assert bool(np.asarray(ref.failed)[0]) and bool(res.failed[0])
    np.testing.assert_array_equal(res.total_cost.numpy(), np.asarray(ref.total_cost))


def test_kernel_wrapper_rejects_cpu_tensors_and_wide_tables(setup):  # noqa: F811
    lp = setup[0]
    _graphs, arrays, ll, nf, _ = _batch(setup, [12], _words(lp, ["YES"]))
    with pytest.raises(ValueError):
        viterbi_cuda(*_port_args(arrays, ll, nf), 0.5)
    # every (S, M) has a kernel: which one, its backpointers, where alpha lives
    assert viterbi_plan(256, 4) == ("compiled", torch.int8, "shared")
    assert viterbi_plan(1, 1) == ("compiled", torch.int8, "shared")
    assert viterbi_plan(512, 8) == ("compiled", torch.int8, "shared")
    assert viterbi_plan(1000, 16) == ("generic", torch.int8, "shared")
    assert viterbi_plan(513, 4) == ("generic", torch.int8, "shared")
    assert viterbi_plan(256, 9) == ("generic", torch.int8, "shared")
    assert viterbi_plan(2048, 4) == ("generic", torch.int8, "shared")
    assert viterbi_plan(256, 16) == ("generic", torch.int8, "shared")
    assert viterbi_plan(8000, 4) == ("generic", torch.int8, "shared")
    assert viterbi_plan(64, 128) == ("generic", torch.int16, "shared")
    assert viterbi_plan(64, 200) == ("generic", torch.int16, "shared")
    assert viterbi_plan(50, 40000) == ("generic", torch.int32, "shared")
    assert viterbi_plan(29024, 4) == ("generic", torch.int8, "shared")
    assert viterbi_plan(29025, 2) == ("generic", torch.int8, "global")
