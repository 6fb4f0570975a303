"""Which (planes, states) shapes the banded kernels take, on the CPU.

The banded Viterbi kernel (csrc/banded_viterbi.cu) and the banded
forward-backward kernels (csrc/banded_fb.cu) each have a compiled path
for the band widths of the main paths and a generic one for the rest.
Whether a batch goes to a kernel at all is decided from shapes alone
(``kernel_fits``, ``fb_kernel_fits``): every shape that the first
ports' shared-memory formulas took must still be taken, and the Python
mirrors of the launchers' shared-memory requests must equal the sizes
worked out here from the .cu layouts.
"""

import pytest

from khg_tpu_torch.align.banded_fb import fb_kernel_fits, fb_kernel_smem_bytes
from khg_tpu_torch.align.banded_kernel import kernel_fits, kernel_smem_bytes

LIMIT = 232448  # shared memory a block may use on an H100 (bytes)


def viterbi_fits_before(DK, S):
    """The banded Viterbi kernel's acceptance before its redesign: int8
    backpointers and one block of plane costs, two alpha buffers, the
    offsets and an argmin scratch of 8 bytes a thread."""
    nt = min(1024, -(-S // 32) * 32)
    return DK < 128 and DK * S * 4 + 2 * S * 4 + DK * 4 + nt * 8 <= LIMIT


def fb_fits_before(DK, S):
    """The banded forward-backward kernels' acceptance before the
    redesign: one thread per state, and the backward block's negated
    costs, two double-buffered rows and the offsets."""
    return S <= 1024 and (DK * S + 4 * S) * 4 + DK * 4 <= LIMIT


PLANES = (1, 2, 5, 16, 20, 32, 33, 64, 100, 127, 128, 300)
STATES = (1, 31, 37, 64, 256, 512, 513, 1000, 1024, 1025, 2000, 2550, 4000, 18000)


@pytest.mark.parametrize("S", STATES)
@pytest.mark.parametrize("DK", PLANES)
def test_accepted_shapes_unchanged(DK, S):
    assert kernel_fits(DK, S) == viterbi_fits_before(DK, S)
    assert fb_kernel_fits(DK, S) == fb_fits_before(DK, S)
    if kernel_fits(DK, S):
        assert kernel_smem_bytes(DK, S) <= LIMIT
    if fb_kernel_fits(DK, S):
        assert fb_kernel_smem_bytes(DK, S) <= LIMIT


# (DK, S): bytes that launch_banded_viterbi requests.  Compiled path
# (DK 16, 20 or 32, S <= 512): alpha 2 x 512 f32 (4,096) + staged
# backpointers 2 x 32 rows of S padded to 16 bytes + offsets DK i32 +
# path 2 x 2 x 32 i32 (512) + argmin scratch 256.
# Generic path: plane costs DK x S f32 + alpha 2 x S f32 + offsets DK
# i32 + argmin scratch 8 bytes per thread (S rounded up to 32, at most
# 1,024 threads).
VITERBI_SMEM = {
    (20, 256): 4096 + 64 * 256 + 80 + 512 + 256,   # 21,328
    (32, 37): 4096 + 64 * 48 + 128 + 512 + 256,     # 8,064
    (16, 512): 4096 + 64 * 512 + 64 + 512 + 256,    # 37,696
    (20, 64): 4096 + 64 * 64 + 80 + 512 + 256,      # 9,040
    (20, 600): 20 * 600 * 4 + 8 * 600 + 80 + 608 * 8,         # 57,744
    (127, 37): 127 * 37 * 4 + 8 * 37 + 508 + 64 * 8,          # 20,112
    (1, 2000): 1 * 2000 * 4 + 8 * 2000 + 4 + 1024 * 8,        # 32,196
    (64, 256): 64 * 256 * 4 + 8 * 256 + 256 + 256 * 8,        # 69,888
}

# (DK, S): bytes that launch_banded_fb_bwd requests.  Compiled path (DK
# 16 or 20, S <= 512): alpha ring 4 x 2S f32 + beta' + acoustic 2 x 2S
# f32 = 48 S.  Generic path: negated costs DK x
# S f32 + 4 rows of S f32 + offsets DK i32, plus the plane-posterior
# sums DK x S f32 where the whole still fits.
FB_SMEM = {
    (20, 256): 48 * 256,                                        # 12,288
    (16, 37): 48 * 37,                                          # 1,776
    (20, 512): 48 * 512,                                        # 24,576
    (64, 300): (64 * 300 + 4 * 300) * 4 + 256 + 64 * 300 * 4,   # 158,656
    (128, 400): (128 * 400 + 4 * 400) * 4 + 512,                # 211,712
    (20, 600): (20 * 600 + 4 * 600) * 4 + 80 + 20 * 600 * 4,    # 105,680
    (32, 256): (32 * 256 + 4 * 256) * 4 + 128 + 32 * 256 * 4,   # 69,760
}


@pytest.mark.parametrize("DK,S", sorted(VITERBI_SMEM))
def test_viterbi_smem_mirror(DK, S):
    assert kernel_smem_bytes(DK, S) == VITERBI_SMEM[(DK, S)]


@pytest.mark.parametrize("DK,S", sorted(FB_SMEM))
def test_fb_smem_mirror(DK, S):
    assert fb_kernel_smem_bytes(DK, S) == FB_SMEM[(DK, S)]
