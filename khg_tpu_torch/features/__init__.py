"""Feature extraction: fbank (plain PyTorch, and the CUDA kernel's entry
under khg_tpu's name ``compute_fbank_pallas``), MFCC, deltas and
resampling.  Names import on first use (utils/lazy.py)."""

from khg_tpu_torch.utils.lazy import lazy_exports

globals().update(lazy_exports(globals(), {
    "fbank": ["FbankConfig", "compute_fbank", "compute_fbank_batch"],
    "fbank_kernel": [("compute_fbank_pallas", "fbank_fused")],
    "resample": ["perturb_speed", "resample_waveform", "speed_perturb_corpus"],
}))
