"""Fused GMM log-likelihoods: the CUDA kernel ``csrc/loglikes.cu`` and
its plain PyTorch version.

Port of khg_tpu/gmm/pallas_kernels.py.  The plain path
(``gmm/likelihoods.loglikes``) writes the (N, P*K) component scores to
device memory before the logsumexp reduces them to (N, P); the kernel
keeps them in registers and writes only (N, P).  The kernel stabilises
each pdf's logsumexp with that pdf's own max, so unlike the TPU kernel
no pdf underflows to -inf far below the row max.

Padding contract (as in khg_tpu): padding components have gconst = -inf
and zero model rows; padding pdfs are never indexed by callers.

``loglikes_fused`` takes the kernel for CUDA tensors and the plain
version only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from khg_tpu_torch.gmm.likelihoods import expand_feats, loglikes, stack_model

# the row widths the wrapper pads to (csrc/loglikes.cu takes any multiple
# of 16): 2D = 46 for 23 fbank bins, 78 for 39-dim MFCC + deltas, 160 for
# 80-dim features; wider rows pad to a multiple of the last
_WIDTHS = (48, 80, 160)


# csrc/loglikes.cu's tiles: 256 threads, each 4 rows x 8 components of
# one pdf; 8 pdfs and 128 rows a block; a 4-stage ring of 16-column
# slices of the rows and of the component chunk's model rows
_THREADS, _ROWS, _COMPS, _PDFS = 256, 4, 8, 8
_BLOCK_ROWS = _THREADS // _PDFS * _ROWS
_COLS, _NSTAGE = 16, 4


def loglikes_smem_bytes(K: int) -> int:
    """Dynamic shared memory of a csrc/loglikes.cu block for K components
    (mirrors smem_bytes), f32 or bf16 alike: the ring's rows and model
    vectors of 4 f32 values; each (row, pdf)'s running max and sum; per
    pdf its real components' gconsts and indices, and their count."""
    vectors = _COLS // 4 * (_BLOCK_ROWS + _COMPS * _PDFS)
    return (_NSTAGE * vectors * 16 + 2 * _ROWS * _THREADS * 4
            + 2 * _PDFS * K * 4 + _PDFS * 4)


def loglikes_grid(N: int, P: int) -> tuple:
    """The launch grid: (row blocks of 128, pdf blocks of 8)."""
    return -(-N // _BLOCK_ROWS), -(-P // _PDFS)


def padded_width(d2: int) -> int:
    """The kernel's row width for a feature row of 2D = ``d2`` values."""
    for w in _WIDTHS:
        if d2 <= w:
            return w
    return -(-d2 // _WIDTHS[-1]) * _WIDTHS[-1]


def loglikes_plain(gconsts, means_invvars, inv_vars, feats, compute_dtype=None):
    """Plain PyTorch version: one GEMM, then logsumexp over K."""
    return loglikes(
        gconsts, means_invvars, inv_vars, feats, compute_dtype=compute_dtype
    )


def kernel_operands(
    gconsts: torch.Tensor,
    means_invvars: torch.Tensor,
    inv_vars: torch.Tensor,
    feats: torch.Tensor,
    compute_dtype: Optional[str] = None,
):
    """What ``csrc/loglikes.cu`` reads: (x2 (N, D2P), model (P*K, D2P),
    gconst (P*K,), N, P, K, D2P, bf16), rows padded with zeros to the
    kernel's width and cast to the compute type."""
    for t in (gconsts, means_invvars, inv_vars, feats):
        if t.device.type != "cuda":
            raise ValueError("loglikes_cuda needs CUDA tensors")
        if t.dtype != torch.float32:
            raise ValueError("loglikes_cuda takes float32 model and features")
    P, K, D = means_invvars.shape
    if gconsts.shape != (P, K) or inv_vars.shape != (P, K, D):
        raise ValueError("model tensors disagree in shape")
    if feats.shape[-1] != D:
        raise ValueError(f"features have dim {feats.shape[-1]}, model {D}")
    bf16 = compute_dtype == "bfloat16"
    if compute_dtype not in (None, "bfloat16"):
        raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
    x2 = expand_feats(feats.reshape(-1, D))
    A, g = stack_model(gconsts, means_invvars, inv_vars)
    d2p = padded_width(2 * D)
    pad = d2p - 2 * D
    x2 = torch.nn.functional.pad(x2, (0, pad))
    A = torch.nn.functional.pad(A, (0, pad))
    dtype = torch.bfloat16 if bf16 else torch.float32
    return (x2.to(dtype).contiguous(), A.to(dtype).contiguous(), g.contiguous(),
            x2.shape[0], P, K, d2p, bf16)


def loglikes_cuda(
    gconsts: torch.Tensor,
    means_invvars: torch.Tensor,
    inv_vars: torch.Tensor,
    feats: torch.Tensor,
    compute_dtype: Optional[str] = None,
) -> torch.Tensor:
    """Launch ``csrc/loglikes.cu``: (..., T, D) feats -> (..., T, P)."""
    from khg_tpu_torch import kernels

    x2, A, g, N, P, K, d2p, bf16 = kernel_operands(
        gconsts, means_invvars, inv_vars, feats, compute_dtype
    )
    out = torch.empty((N, P), dtype=torch.float32, device=feats.device)
    err = kernels.lib().launch_fused_loglikes(
        x2.data_ptr(), A.data_ptr(), g.data_ptr(), out.data_ptr(),
        N, P, K, d2p, int(bf16), kernels.stream_handle(feats.device),
    )
    kernels.check("fused_loglikes", err)
    return out.reshape(feats.shape[:-1] + (P,))


def loglikes_fused(gconsts, means_invvars, inv_vars, feats, compute_dtype=None):
    """(..., T, P) log-likelihoods: the kernel on CUDA, the plain
    version on the CPU."""
    if feats.device.type == "cuda":
        return loglikes_cuda(
            gconsts, means_invvars, inv_vars, feats, compute_dtype
        )
    return loglikes_plain(
        gconsts, means_invvars, inv_vars, feats, compute_dtype
    )
