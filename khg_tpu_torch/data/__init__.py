"""Audio I/O and batching: WAV reading and writing, and the bucketing
loader.  Names import on first use (utils/lazy.py)."""

from khg_tpu_torch.utils.lazy import lazy_exports

globals().update(lazy_exports(globals(), {
    "loader": ["BucketingLoader", "LoaderConfig"],
    "wav": ["WavInfo", "read_wav", "wav_info", "write_wav"],
}))
