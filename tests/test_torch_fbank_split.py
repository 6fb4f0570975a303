"""The split-TF32 arithmetic of the fbank kernel (csrc/fbank.cu), on the
CPU.

The kernel takes the frontend's two products on the tensor cores:
frames and table are each split into three TF32 parts
(``split_tf32``), and the six products of frame part i and table part j
with i + j <= 2 are summed.  Here ``split_tf32`` is held to its
contract, the host table (``kernel_tables``, ``fragment_order``) to the
folded matrices and the mma fragment layout, and a numpy emulation of
the kernel's arithmetic (exact products, sums rounded to f32, then the
power, the mel sums over the used bins and the log in f32) to the plain
version ``fbank_plain`` within the kernel's 1e-3, at 8 to 48 kHz on
integer-valued (WAV) and full-mantissa rows.  The emulation lives here
only: the main path runs the kernel on the card and ``fbank_plain`` on
the CPU.  It takes the split products as a parameter (``PRODUCTS``);
``tools/fbank_split_emulation.py`` tabulates the candidates with it.
"""

import math

import numpy as np
import pytest
import torch

from khg_tpu_torch.features.fbank import FbankConfig, mel_banks, num_frames
from khg_tpu_torch.features.fbank_kernel import (
    _FLT_MIN,
    CHUNK,
    _padded_wave,
    fbank_plain,
    fbank_plan,
    folded_frontend,
    fragment_order,
    kernel_tables,
    split_tf32,
    used_bins,
)

RATES = (8000, 16000, 22050, 44100, 48000)


def _tf32_representable(parts):
    return not (parts.view(np.uint32) & 0x1FFF).any()


@pytest.mark.parametrize("kind", ["normal", "integers", "negative", "zeros",
                                  "exponents", "tf32-subnormals"])
def test_split_tf32_parts_sum_to_input(kind):
    """Three parts, each a TF32 value, sum exactly to the f32 input over
    the exponents where TF32 parts can hold it (2**-113 to 2**127); a
    subnormal that TF32 can hold is its own first part."""
    rng = np.random.default_rng(5)
    x = {
        "normal": rng.standard_normal(20000) * 300,
        "integers": np.arange(-32767, 32768),
        "negative": -np.abs(rng.standard_normal(5000)) * 1e4,
        "zeros": np.array([0.0, -0.0, 0.0]),
        "exponents": rng.standard_normal(20000) * 2.0 ** rng.integers(-110, 125, 20000),
        "tf32-subnormals": (rng.integers(-1023, 1024, 2000) * 2.0 ** -136),
    }[kind].astype(np.float32)
    if kind == "exponents":
        x = x[(np.abs(x) >= 2.0 ** -113) & (np.abs(x) < 2.0 ** 127)]
    parts = split_tf32(x)
    assert parts.shape == (3,) + x.shape and parts.dtype == np.float32
    assert _tf32_representable(parts)
    total = parts.astype(np.float64).sum(0)
    assert np.array_equal(total, x.astype(np.float64))
    if kind == "tf32-subnormals":
        assert np.array_equal(parts[0], x) and not parts[1:].any()


def test_split_tf32_below_tf32_range():
    """Below 2**-113 (f32 subnormals included) TF32 parts are multiples of
    2**-136: the split misses the input by at most 2**-137."""
    rng = np.random.default_rng(6)
    x = np.concatenate([
        rng.standard_normal(5000) * 1e-39,          # f32 subnormals
        rng.standard_normal(5000) * 2.0 ** -120,
        np.array([1.4e-45, -1.4e-45, 1.1754942e-38]),
    ]).astype(np.float32)
    parts = split_tf32(x)
    assert _tf32_representable(parts)
    err = np.abs(parts.astype(np.float64).sum(0) - x.astype(np.float64))
    assert err.max() <= 2.0 ** -137


def test_split_tf32_integers_need_two_parts():
    """WAV samples (integers up to 32,767 in magnitude) have no third
    part, so the kernel's lo-frame product is zero for them."""
    x = np.arange(-32767, 32768, dtype=np.float32)
    parts = split_tf32(x)
    assert not parts[2].any()
    assert np.array_equal(parts[0].astype(np.float64) + parts[1], x)


@pytest.mark.parametrize("rate", RATES)
def test_kernel_table_is_the_folded_matrices(rate):
    """The split table's parts sum to the folded matrices' used bins, Re
    and Im side by side, zero past the frame length and the used columns;
    the mel weights and ranges are the used bins' nonzero weights; each
    chunk's filter range holds exactly the filters that weigh one of its
    32 bins."""
    cfg = FbankConfig(sample_rate=rate)
    plan = fbank_plan(cfg)
    parts, mel, rng, chunks = kernel_tables(cfg)
    first, count = used_bins(cfg)
    m_re, m_im = folded_frontend(cfg)
    flen = cfg.frame_length
    assert parts.shape == (3, plan.kp, parts.shape[2]) and parts.shape[2] % CHUNK == 0
    assert _tf32_representable(parts)
    table = parts.astype(np.float64).sum(0)
    assert np.array_equal(table[:flen, 0:2 * count:2], m_re[:, first:first + count])
    assert np.array_equal(table[:flen, 1:2 * count:2], m_im[:, first:first + count])
    assert not table[flen:].any() and not table[:, 2 * count:].any()
    full = mel_banks(cfg)
    assert np.array_equal(mel, full[:, first:first + count])
    assert not np.delete(full, np.arange(first, first + count), axis=1).any()
    for m in range(full.shape[0]):
        lo, hi = rng[m]
        assert not mel[m, :lo].any() and not mel[m, hi:].any()
        assert mel[m, lo] != 0 and mel[m, hi - 1] != 0
    bins = CHUNK // 2
    assert chunks.shape == (parts.shape[2] // CHUNK, 2)
    for c, (lo, hi) in enumerate(chunks):
        feeds = [m for m in range(full.shape[0]) if mel[m, c * bins:(c + 1) * bins].any()]
        assert list(range(lo, hi)) == feeds


def test_fragment_order_is_the_wgmma_b_layout():
    """Each (k-step s, part p) is wgmma's K-major B operand without
    swizzle: per 8-column group j, two core matrices (k-halves kg) of 8
    columns n x 4 rows k."""
    rng = np.random.default_rng(7)
    parts = rng.standard_normal((3, 32, 128)).astype(np.float32)
    frag = fragment_order(parts)
    assert frag.shape == (4, 3, 16, 2, 8, 4)
    for s, p, j, kg, n, k in np.ndindex(*frag.shape):
        assert frag[s, p, j, kg, n, k] == parts[p, 8 * s + 4 * kg + k, 8 * j + n]


def _bf16(x):
    """BF16 rounding of f32 ``x`` (to nearest even), as f32."""
    b = np.asarray(x, np.float32).view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> 16) & 1)) & np.uint32(0xFFFF0000)
    return r.astype(np.uint32).view(np.float32)


def _split(x, parts, kind):
    """(parts, ...) f64: f32 ``x`` split into TF32 (``split_tf32``) or
    BF16 parts, each rounded from what the parts before it left."""
    if kind == "tf32":
        return split_tf32(x, parts).astype(np.float64)
    out, rest = [], np.asarray(x, np.float32)
    for _ in range(parts):
        p = _bf16(rest)
        out.append(p.astype(np.float64))
        rest = (rest - p).astype(np.float32)
    return np.stack(out)


# name: (kind, frame parts, table parts, the products (i, j) of frame
# part i and table part j); kind None: the f64 product of the f32 operands
PRODUCTS = {
    "1xTF32": ("tf32", 1, 1, [(0, 0)]),
    "3xBF16 (2-way splits)": ("bf16", 2, 2, [(0, 0), (0, 1), (1, 0)]),
    "3xTF32 (2-way splits)": ("tf32", 2, 2, [(0, 0), (0, 1), (1, 0)]),
    "5xTF32 (2-way frames, 3-way table)": ("tf32", 2, 3,
                                           [(0, 0), (0, 1), (1, 0), (0, 2), (1, 1)]),
    "6xTF32 (3-way, i + j <= 2)": ("tf32", 3, 3,
                                  [(0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)]),
    "f64 product of the f32 operands": (None, 0, 0, []),
}
SIX = PRODUCTS["6xTF32 (3-way, i + j <= 2)"]


def emulate_kernel(padded, cfg, T, product=SIX):
    """The kernel's arithmetic in numpy, with the split ``product`` (one
    of ``PRODUCTS``; the kernel's is ``SIX``): frames and the f32 table
    split into parts, the chosen part products exact (f64), their sum
    rounded to f32; power, mel sums over each filter's used bins and log
    in f32; raw log energy in f32."""
    kind, fparts, tparts, pairs = product
    flen, shift = cfg.frame_length, cfg.frame_shift
    parts, mel, _rng, _chunks = kernel_tables(cfg)
    table = parts[:, :flen].astype(np.float64).sum(0)   # the f32 table, exactly
    x = padded.numpy()
    idx = np.arange(T)[:, None] * shift + np.arange(flen)[None, :]
    frames = x[:, idx]                                   # (B, T, flen) f32
    if kind is None:
        prod = frames.astype(np.float64) @ table
    else:
        fp = _split(frames, fparts, kind)
        tp = _split(table.astype(np.float32), tparts, kind)
        prod = sum(fp[i] @ tp[j] for i, j in pairs)
    count = mel.shape[1]
    spec = prod.astype(np.float32)[..., : 2 * count]
    re, im = spec[..., 0::2], spec[..., 1::2]
    power = re * re + im * im
    if not cfg.use_power:
        power = np.sqrt(power)
    feats = (torch.as_tensor(power) @ torch.as_tensor(mel.T)).numpy()
    if cfg.use_log_fbank:
        feats = np.log(np.maximum(feats, np.float32(_FLT_MIN)))
    s1 = frames.sum(-1, dtype=np.float32)
    s2 = (frames * frames).sum(-1, dtype=np.float32)
    e = s2 - s1 * s1 * np.float32(1.0 / flen) if cfg.remove_dc_offset else s2
    loge = np.log(np.maximum(e, np.float32(_FLT_MIN)))
    if cfg.energy_floor > 0.0:
        loge = np.maximum(loge, np.float32(math.log(cfg.energy_floor)))
    return feats, loge


OPTIONS = {
    "power": dict(),
    "magnitude-floor": dict(use_power=False, energy_floor=1.0),
    "snip-energy": dict(snip_edges=True, use_energy=True),
}


@pytest.mark.parametrize("opts", list(OPTIONS.values()), ids=list(OPTIONS))
@pytest.mark.parametrize("rows", ["integers", "normal"])
@pytest.mark.parametrize("rate", RATES)
def test_six_products_match_plain(rate, rows, opts):
    """The six-product arithmetic is within 1e-3 of ``fbank_plain`` in
    features and log energy, on integer-valued rows (as a WAV holds
    them) and on standard_normal x 300 rows (full f32 mantissas)."""
    cfg = FbankConfig(sample_rate=rate, **opts)
    rng = np.random.default_rng(rate + len(rows))
    n = int(0.23 * rate)
    w = rng.standard_normal((2, n)) * 300
    if rows == "integers":
        w = np.clip(np.round(w * 20), -32768, 32767)
    waves = torch.as_tensor(w.astype(np.float32))
    T = num_frames(cfg, n)
    padded = _padded_wave(waves, cfg, T)
    fp, ep = fbank_plain(padded, cfg, T)
    fe, ee = emulate_kernel(padded, cfg, T)
    assert fe.shape == tuple(fp.shape)
    assert np.abs(fe - fp.numpy()).max() <= 1e-3
    assert np.abs(ee - ep.numpy()).max() <= 1e-3
