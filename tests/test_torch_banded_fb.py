"""Banded forward-backward in the port (khg_tpu_torch/align/banded_fb.py):
the plain version (what csrc/banded_fb.cu computes, operation for
operation) against khg_tpu's Pallas kernels in interpret mode and
against the port's dense FB; parallel-arc rejection, padding frames,
and the kernels' shape-only fit check."""

import numpy as np
import pytest
import torch

from khg_tpu.align.banded import band_renumber, pack_banded
from khg_tpu.align.packed import uniform_dest_pdf
from khg_tpu.align.pallas_banded_fb import forward_backward_banded as j_banded_fb
from khg_tpu_torch.align.banded_fb import (
    banded_fb_cuda,
    banded_fb_fwd_plain,
    fb_kernel_fits,
    forward_backward_banded,
)
from khg_tpu_torch.align.banded_kernel import kernel_fits
from khg_tpu_torch.align.forward_backward import NEG_BIG, forward_backward_batch
from khg_tpu_torch.utils.convert import banded_to_torch, batched_graphs_to_torch
from tests.test_align import setup  # noqa: F401
from tests.test_banded import _parallel_arc_batch
from tests.test_torch_forward_backward import _assert_fb_close, _problem


def _banded(arrays):
    ren, _ = band_renumber(arrays)
    out = pack_banded(ren, uniform_dest_pdf(ren), reject_parallel=True)
    assert out is not None
    return out


def _port_banded(banded, offsets, ll, nf, tm, scale):
    return forward_backward_banded(
        banded_to_torch(banded, "cpu"), offsets, torch.as_tensor(ll),
        torch.as_tensor(nf), tm.num_transition_ids, acoustic_scale=scale,
    )


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_banded_fb_plain_matches_pallas_interpret(setup, scale):  # noqa: F811
    """log Z rtol 1e-5, gamma atol 1e-4, tid counts atol 1e-3 against
    the Pallas kernels, with padding frames past each utterance."""
    words = [["YES"], ["NO", "YES"], ["NO"]]
    lens = [14, 26, 9]
    _g, arrays, ll, nf, tm = _problem(setup, lens, words, seed=11)
    banded, offsets = _banded(arrays)
    got = _port_banded(banded, offsets, ll, nf, tm, scale)
    ref = j_banded_fb(
        banded, offsets, ll, nf, tm.num_transition_ids, acoustic_scale=scale,
        block_b=2, time_chunk=8, lane=8, interpret=True,
    )
    assert not got.failed.any()
    _assert_fb_close(got, ref)
    for i, t in enumerate(lens):
        assert (got.gamma.numpy()[i, t:] == 0).all()


def test_banded_fb_plain_matches_dense(setup):  # noqa: F811
    """Against the port's dense FB on the ORIGINAL numbering (band
    renumbering leaves the outgoing tables unrenumbered, so only
    numbering-free outputs are compared), with one utterance too short
    to align."""
    words = [["YES", "NO"], ["NO"], ["YES", "NO", "YES"]]
    lens = [25, 11, 4]
    _g, arrays, ll, nf, tm = _problem(setup, lens, words, seed=12)
    banded, offsets = _banded(arrays)
    got = _port_banded(banded, offsets, ll, nf, tm, 0.8)
    dense = forward_backward_batch(
        batched_graphs_to_torch(arrays, "cpu"), torch.as_tensor(ll),
        torch.as_tensor(nf), tm.num_transition_ids, acoustic_scale=0.8,
        state_pdf=torch.as_tensor(uniform_dest_pdf(arrays)),
    )
    assert got.failed.tolist() == [False, False, True]
    assert float(got.log_z[2]) == np.float32(NEG_BIG)
    _assert_fb_close(got, dense)


def test_banded_fb_plain_zero_frames(setup):  # noqa: F811
    """An utterance of zero frames: alpha stays the initial one, no
    posteriors, and it fails (no start state is final)."""
    words = [["YES"], ["NO"]]
    _g, arrays, ll, nf, tm = _problem(setup, [12, 6], words, seed=13)
    nf[1] = 0
    banded, offsets = _banded(arrays)
    got = _port_banded(banded, offsets, ll, nf, tm, 0.5)
    assert got.failed.tolist() == [False, True]
    assert float(got.gamma[1].abs().sum()) == 0.0
    alphas, _lz = banded_fb_fwd_plain(
        banded_to_torch(banded, "cpu"), offsets, torch.as_tensor(ll),
        torch.as_tensor(nf), 0.5,
    )
    assert alphas.shape == (2, 12, banded.plane_cost.shape[2])


def test_pack_banded_rejects_parallel_arcs_for_fb():
    """FB needs every parallel arc's mass and a plane cell holds one:
    packing for FB gives None, and the pipeline takes the dense FB."""
    from khg_tpu_torch.align.banded import pack_banded as t_pack_banded
    from khg_tpu_torch.align.packed import uniform_dest_pdf as t_udp
    from khg_tpu_torch.recipes.pipeline import EStepPipeline
    from tests.test_transition_device import build_tm
    from tests.torch_parity import port_copy

    arrays = port_copy(_parallel_arc_batch())
    sp = t_udp(arrays)
    assert t_pack_banded(arrays, sp, reject_parallel=True) is None
    assert t_pack_banded(arrays, sp) is not None  # Viterbi keeps the min arc
    pipe = EStepPipeline(port_copy(build_tm()), align_backend="banded",
                         device="cpu")
    assert pipe._try_pack_banded(arrays, fb=True) is None


@pytest.mark.parametrize("DK,S,fits", [
    (20, 256, True),
    (128, 256, True),    # no plane limit: FB keeps no int8 backpointers
    (64, 800, True),
    (20, 1056, False),   # one thread per state, at most 1,024
    (128, 512, False),   # 256 KiB of plane costs: beyond shared memory
])
def test_fb_kernel_fit_check(DK, S, fits):
    assert fb_kernel_fits(DK, S) is fits
    if DK >= 128:
        assert not kernel_fits(DK, S)  # the Viterbi kernel refuses them


def test_banded_fb_cuda_wrapper_rejects_cpu_tensors(setup):  # noqa: F811
    _g, arrays, ll, nf, tm = _problem(setup, [12], [["YES"]], seed=14)
    banded, offsets = _banded(arrays)
    with pytest.raises(ValueError):
        banded_fb_cuda(banded_to_torch(banded, "cpu"), offsets,
                       torch.as_tensor(ll), torch.as_tensor(nf), 0.5)
