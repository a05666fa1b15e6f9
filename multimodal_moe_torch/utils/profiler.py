"""Tracing and profiling: ``torch.profiler`` traces, the port's spans and
device memory.

Counterpart of ``multimodal_moe_tpu/utils/profiler.py``, with the same
names. ``trace`` writes a Chrome trace (``trace.json``, open it in Perfetto
or ``chrome://tracing``) of the host and, where there is a card, of its
kernels.

``annotate(name, **counts)`` is the port's one span primitive, placed at
the layer boundaries of the serving step, the NMS tail, the MoE level, the
train step and the server. With no profiler active it reads one flag and
records nothing. While a profiler is active (``trace`` or any
``torch.profiler.profile``) a span is a host-only operation in the
profiler's own trace (no device-side annotation, so it neither counts as
device work nor stretches over idle time there), and one entry of an
in-memory log: its name, its parent span on the same thread, the thread,
host start and end, the integer ``counts`` given, and where the process
uses the card a pair of CUDA events on the current stream. ``spans()``
reads the log, each event pair resolved to the stream time from the
span's entry to its exit: its kernels plus the idle the host leaves inside
it. Nothing on the hot path waits for the card.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"

_NO_SPAN = contextlib.nullcontext()
_log: "List[_Span]" = []
_log_lock = threading.Lock()
_local = threading.local()


@contextlib.contextmanager
def trace(log_dir: "str | Path") -> Iterator[None]:
    """Capture a host (and card) profile into ``log_dir/trace.json``; the
    spans opened inside it are in the trace and in :func:`spans`.

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


class _Span:
    """One span while a profiler is active; logged when it exits."""

    __slots__ = ("name", "counts", "parent", "thread", "start_ns", "end_ns", "events", "_op")

    def __init__(self, name: str, counts: "Dict[str, int]"):
        self.name, self.counts = name, counts

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.thread = threading.current_thread().name
        # A plain host op: record_function would add a device-side
        # annotation that spans the kernels and the idle between them.
        self._op = torch._C._profiler._RecordFunctionFast(self.name)
        self._op.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._op.__exit__(*exc)
        _local.stack.pop()
        with _log_lock:
            _log.append(self)


def annotate(name: str, **counts: int):
    """A named span (``with annotate("moe.experts", routed_rows=n): ...``):
    nothing unless a profiler is active (the module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, counts)


def spans() -> "List[dict]":
    """The span log in the order the spans ended: ``name``, ``parent``
    (the enclosing span's name on the same thread, or None), ``thread``,
    ``start_ns`` and ``end_ns`` (``time.perf_counter_ns``), ``host_ms``,
    ``device_ms`` (the stream time between the span's two CUDA events; None
    where the process had not used the card) and ``counts``. Resolving the
    events waits for the last one."""
    with _log_lock:
        log = list(_log)
    out = []
    for s in log:
        device_ms = None
        if s.events is not None:
            s.events[1].synchronize()
            device_ms = s.events[0].elapsed_time(s.events[1])
        out.append({"name": s.name, "parent": s.parent, "thread": s.thread,
                    "start_ns": s.start_ns, "end_ns": s.end_ns,
                    "host_ms": (s.end_ns - s.start_ns) / 1e6, "device_ms": device_ms,
                    "counts": dict(s.counts)})
    return out


def clear_spans() -> None:
    """Empty the span log."""
    with _log_lock:
        _log.clear()


def _sync() -> None:
    """Wait for the card where this process has used it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
