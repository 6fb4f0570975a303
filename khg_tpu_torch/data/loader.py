"""Bucketing, prefetching data loader for the device E-step.

The runtime piece between storage and the device: groups utterances into
length buckets (bounding pad waste and recompilation), assembles padded
batches on background threads, and keeps a prefetch queue ahead of the
consumer so host assembly overlaps device compute.  The reference has no
loader at all (lhotse cuts are read in a serial Python loop,
egs/yesno/train.py:117); at pod scale the host side must pipeline.

Features are produced by a user-supplied callable (e.g. reading
precomputed fbank, or khg_tpu_torch.features.compute_fbank on raw audio) so the
loader stays storage-agnostic.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class LoaderConfig:
    batch_size: int = 64
    frames_pad_multiple: int = 32
    num_buckets: int = 4
    prefetch: int = 2
    num_workers: int = 2
    drop_last: bool = False
    shuffle: bool = True


class Batch(NamedTuple):
    indices: np.ndarray       # (B,) utterance indices in the dataset
    feats: np.ndarray         # (B, T_pad, D) float32
    num_frames: np.ndarray    # (B,) int32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BucketingLoader:
    def __init__(
        self,
        num_utts: int,
        get_feats: Callable[[int], np.ndarray],
        lengths: Optional[Sequence[int]] = None,
        config: LoaderConfig = LoaderConfig(),
        seed: int = 0,
    ):
        """``get_feats(i)`` returns the (T_i, D) features of utterance i.

        ``lengths`` lets the loader bucket without touching features; if
        absent, features are probed once up front.
        """
        self.num_utts = num_utts
        self.get_feats = get_feats
        self.config = config
        self.seed = seed
        if lengths is None:
            lengths = [get_feats(i).shape[0] for i in range(num_utts)]
        self.lengths = np.asarray(lengths, dtype=np.int64)

    # ------------------------------------------------------------- batching

    def _make_batches(self, epoch: int) -> List[List[int]]:
        cfg = self.config
        rng = np.random.default_rng(self.seed + epoch)
        order = np.argsort(self.lengths, kind="stable")
        # contiguous length buckets
        buckets = np.array_split(order, max(cfg.num_buckets, 1))
        batches: List[List[int]] = []
        for bucket in buckets:
            bucket = bucket.copy()
            if cfg.shuffle:
                rng.shuffle(bucket)
            for lo in range(0, len(bucket), cfg.batch_size):
                chunk = bucket[lo : lo + cfg.batch_size].tolist()
                if cfg.drop_last and len(chunk) < cfg.batch_size:
                    continue
                if chunk:
                    batches.append(chunk)
        if cfg.shuffle:
            rng.shuffle(batches)
        return batches

    def _assemble(self, idx: List[int]) -> Batch:
        cfg = self.config
        feats = [self.get_feats(i) for i in idx]
        dim = feats[0].shape[1]
        t_pad = _round_up(max(f.shape[0] for f in feats), cfg.frames_pad_multiple)
        out = np.zeros((len(idx), t_pad, dim), dtype=np.float32)
        lens = np.zeros(len(idx), dtype=np.int32)
        for j, f in enumerate(feats):
            out[j, : f.shape[0]] = f
            lens[j] = f.shape[0]
        return Batch(np.asarray(idx, dtype=np.int64), out, lens)

    # ------------------------------------------------------------ iteration

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        """Iterate padded batches with background prefetching."""
        cfg = self.config
        batches = self._make_batches(epoch)
        if cfg.num_workers <= 0:
            for idx in batches:
                yield self._assemble(idx)
            return

        work: "queue.Queue[Optional[int]]" = queue.Queue()
        done: "queue.Queue" = queue.Queue(maxsize=max(cfg.prefetch, 1))
        results = {}
        results_lock = threading.Lock()
        error: List[BaseException] = []

        for bi in range(len(batches)):
            work.put(bi)
        for _ in range(cfg.num_workers):
            work.put(None)

        def worker():
            while True:
                bi = work.get()
                if bi is None:
                    return
                try:
                    batch = self._assemble(batches[bi])
                except BaseException as e:  # propagate to consumer
                    error.append(e)
                    done.put(("error", bi))
                    return
                done.put((bi, batch))

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(cfg.num_workers)
        ]
        for t in threads:
            t.start()

        next_bi = 0
        pending = {}
        received = 0
        try:
            while next_bi < len(batches):
                if next_bi in pending:
                    yield pending.pop(next_bi)
                    next_bi += 1
                    continue
                tag, payload = done.get()
                if tag == "error":
                    raise error[0]
                received += 1
                pending[tag] = payload
        finally:
            for t in threads:
                t.join(timeout=0.1)

    def __iter__(self) -> Iterator[Batch]:
        return self.epoch(0)
