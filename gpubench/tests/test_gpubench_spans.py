"""The readers of the port's spans (``gpubench/spans.py`` and the eight
``metrics/*`` that use it) on fake runs: a value from a filled span log on
a run of their kind on the card; None from an empty log, a run of another
kind, a run off the card, or a program whose profiler has no ``spans()``
(the parent of the change that added them). Then the MoE counts of a real
span log, recorded on the CPU from a toy MoE-YOLO serving step."""

from types import SimpleNamespace

import pytest
import torch

from gpubench import run as bench_run
from multimodal_moe_torch.utils import profiler

SERVE = ["tail_ms.serve", "moe_route_ms.serve", "moe_experts_ms.serve", "moe_rows_useful.serve"]
TRAIN = ["forward_ms.train", "loss_ms.train", "backward_ms.train", "update_ms.train"]
STEPS = 2


def _span(name, device_ms, parent=None, **counts):
    return {"name": name, "parent": parent, "thread": "MainThread", "start_ns": 0,
            "end_ns": 1, "host_ms": 1e-6, "device_ms": device_ms, "counts": counts}


# Two steps of each kind: per step the tail 1.5 and 2.5 ms, three levels
# routing 1 ms and sweeping 4 ms over T·E = 2·(T·k) rows, the train spans.
LOG = [_span("serve.tail", ms, "serve.step") for ms in (1.5, 2.5)]
LOG += [_span("moe.route", 1.0, "moe.level") for _ in range(3 * STEPS)]
LOG += [_span("moe.experts", 4.0, "moe.level", routed_rows=100 * (i + 1),
              computed_rows=200 * (i + 1)) for i in range(3 * STEPS)]
LOG += [_span(f"train.{n}", ms, "train.step")
        for n, ms in (("forward", 30.0), ("loss", 8.0), ("backward", 60.0), ("update", 9.0))
        for _ in range(STEPS)]

EXPECTED = {"tail_ms.serve": 2.0, "moe_route_ms.serve": 3.0, "moe_experts_ms.serve": 12.0,
            "moe_rows_useful.serve": 50.0, "forward_ms.train": 30.0, "loss_ms.train": 8.0,
            "backward_ms.train": 60.0, "update_ms.train": 9.0}


def _run(kind, device="cuda"):
    return SimpleNamespace(layer={"kind": kind, "steps": STEPS}, device=torch.device(device))


@pytest.mark.parametrize("case", ["filled", "empty", "other_kind", "cpu", "no_spans"])
@pytest.mark.parametrize("metric", SERVE + TRAIN)
def test_reader_reads_its_spans_or_nothing(metric, case, monkeypatch):
    kind = "serve" if metric in SERVE else "train"
    monkeypatch.setattr(profiler, "spans", lambda: [] if case == "empty" else list(LOG))
    if case == "no_spans":
        monkeypatch.delattr(profiler, "spans")
    fake = _run({"other_kind": "train" if kind == "serve" else "serve"}.get(case, kind),
                "cpu" if case == "cpu" else "cuda")
    got = bench_run.load_module("metrics", metric).read(fake)
    if case == "filled":
        assert got == pytest.approx(EXPECTED[metric])
    else:
        assert got is None


def test_a_span_without_device_time_reads_nothing(monkeypatch):
    """A log recorded off the card has no device ms: the readers of times
    return None rather than a host number."""
    monkeypatch.setattr(profiler, "spans",
                        lambda: [dict(s, device_ms=None) for s in LOG])
    for metric in ("tail_ms.serve", "moe_route_ms.serve", "moe_experts_ms.serve"):
        assert bench_run.load_module("metrics", metric).read(_run("serve")) is None
    for metric in TRAIN:
        assert bench_run.load_module("metrics", metric).read(_run("train")) is None


def test_rows_useful_from_a_real_span_log():
    """MoE-YOLO-n at 64×128 on ``auto`` (dense at each level's few tokens):
    the share is T·k over the capacity slots E·C, summed over the levels."""
    from multimodal_moe_torch.models import moe as tm
    from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector
    from multimodal_moe_torch.serving import make_serving_step

    torch.manual_seed(0)
    model = MoEYoloDetector(num_classes=1, variant="n").eval()
    step = make_serving_step(model, pool=64, max_det=20)
    profiler.clear_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            step(torch.zeros((2, 64, 128, 3), dtype=torch.uint8), torch.tensor([0, 1]))
        got = bench_run.load_module("metrics", "moe_rows_useful.serve").read(
            SimpleNamespace(layer={"kind": "serve", "steps": 1}, device=torch.device("cuda")))
    finally:
        profiler.clear_spans()
    tokens = [2 * (64 // s) * (128 // s) for s in (8, 16, 32)]
    assert all(tm.resolve_dispatch("auto", t, 4) == "dense" for t in tokens)
    slots = [4 * max(int(t * 2 * 1.25 / 4), 2) for t in tokens]
    assert got == pytest.approx(100.0 * sum(2 * t for t in tokens) / sum(slots))
