"""The port's own spans (``multimodal_moe_torch.utils.profiler``) as the
per-layer readers see them.

A cell's profiled stretch runs under ``torch.profiler``, so every span
the program opens there logs itself; nothing else in a run is profiled. A run with ``--trace 0``, a run off the card, or a program
without spans leaves nothing to read, and the readers then return None.
"""

from __future__ import annotations


def log(run, kind: str) -> list:
    """The span log of a run of ``kind`` (``serve``, ``train``) on the
    card, or an empty list."""
    if run.layer.get("kind") != kind or run.device.type != "cuda" or not run.layer.get("steps"):
        return []
    from multimodal_moe_torch.utils import profiler

    spans = getattr(profiler, "spans", None)
    return spans() if spans is not None else []


def device_ms_per_step(run, kind: str, name: str):
    """The device milliseconds of every span ``name`` over the stretch's
    steps, or None where it holds none."""
    found = [s for s in log(run, kind) if s["name"] == name]
    if not found or any(s["device_ms"] is None for s in found):
        return None
    return sum(s["device_ms"] for s in found) / run.layer["steps"]
