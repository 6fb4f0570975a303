"""Lightweight observability: phase timers and throughput counters
(khg_tpu/utils/profiling.py), and a torch.profiler trace context."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional


class Counters:
    """Accumulates per-phase wall time and frame counts."""

    def __init__(self, frame_shift_seconds: float = 0.01):
        self.wall: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.frames: Dict[str, int] = defaultdict(int)
        self.frame_shift_seconds = frame_shift_seconds

    @contextlib.contextmanager
    def phase(self, name: str, frames: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.wall[name] += time.perf_counter() - t0
            self.calls[name] += 1
            self.frames[name] += frames

    def audio_seconds_per_second(self, name: str) -> Optional[float]:
        if self.wall.get(name, 0.0) <= 0 or self.frames.get(name, 0) == 0:
            return None
        return self.frames[name] * self.frame_shift_seconds / self.wall[name]

    def report(self) -> str:
        lines = []
        for name in sorted(self.wall):
            rate = self.audio_seconds_per_second(name)
            rate_s = f", {rate:.0f} audio-sec/s" if rate else ""
            lines.append(
                f"{name}: {self.wall[name]:.3f}s over {self.calls[name]} "
                f"calls{rate_s}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """torch.profiler trace context (no-op when log_dir is None): host
    activity, and the card's where CUDA is present, written on exit to
    ``log_dir`` as a Chrome trace (``<host>_<pid>.<time>.pt.trace.json``,
    as TensorBoard's profiler plugin reads it)."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
