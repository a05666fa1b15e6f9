"""Tracing and profiling: ``torch.profiler`` traces, named regions, stage
timers and device memory.

Counterpart of ``multimodal_moe_tpu/utils/profiler.py``, with the same
names. ``trace`` writes a Chrome trace (``trace.json``, open it in Perfetto
or ``chrome://tracing``) of the host and, where there is a card, of its
kernels; ``StageTimer`` keeps the reference's ``speed_<stage>_ms_per_img``
keys and synchronises the card at each stage boundary, so that a stage's
time is the card's work and not only its launches.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: "str | Path") -> Iterator[None]:
    """Capture a host (and card) profile into ``log_dir/trace.json``.

    Usage::

        with profiler.trace("outputs/profiles/train"):
            for batch in loader:
                state, _ = trainer.train_step(state, batch)
    """
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        _sync()
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region that shows up on the profiler timeline."""
    with torch.profiler.record_function(name):
        yield


def _sync() -> None:
    """Wait for the card where this process has used it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulating wall-clock stage timer for pipeline accounting.

    Produces the reference-compatible ``speed_<stage>_ms_per_img`` dict.
    Where this process has used the card, each stage starts and ends with
    ``torch.cuda.synchronize``."""

    def __init__(self) -> None:
        self.totals: "Dict[str, float]" = defaultdict(float)
        self.count = 0

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.totals[name] += time.perf_counter() - t0

    def add_images(self, n: int) -> None:
        self.count += n

    def speeds_ms_per_img(self) -> "Dict[str, float]":
        n = max(self.count, 1)
        return {
            f"speed_{k}_ms_per_img": 1000.0 * v / n for k, v in self.totals.items()
        }


def memory_stats() -> "Dict[str, Optional[int]]":
    """Card memory of the current device: bytes allocated now, the peak
    since the last reset, and the card's total; None values where there is
    no card."""
    if not torch.cuda.is_available():
        return {"bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}
    device = torch.cuda.current_device()
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }
