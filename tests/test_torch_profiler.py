"""The port's ``utils/profiler.py``: mirrors tests/test_profiler.py (CPU)."""

import json
import time

import torch

from multimodal_moe_torch.utils import profiler
from multimodal_moe_torch.utils.profiler import StageTimer, annotate, memory_stats, trace


class TestStageTimer:
    def test_accumulates_and_derives_speeds(self):
        t = StageTimer()
        for _ in range(4):
            with t.stage("preprocess"):
                time.sleep(0.01)
            with t.stage("inference"):
                time.sleep(0.02)
            t.add_images(2)
        speeds = t.speeds_ms_per_img()
        assert set(speeds) == {
            "speed_preprocess_ms_per_img",
            "speed_inference_ms_per_img",
        }
        # 4×10ms over 8 images ≈ 5 ms/img (loose bounds for CI noise)
        assert 3 < speeds["speed_preprocess_ms_per_img"] < 30
        assert speeds["speed_inference_ms_per_img"] > speeds["speed_preprocess_ms_per_img"]

    def test_zero_images_safe(self):
        t = StageTimer()
        with t.stage("x"):
            pass
        assert t.speeds_ms_per_img()["speed_x_ms_per_img"] >= 0

    def test_stage_boundaries_synchronise_a_card_in_use(self, monkeypatch):
        calls = []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
        t = StageTimer()
        with t.stage("inference"):
            assert len(calls) == 1
        assert len(calls) == 2


class TestTrace:
    def test_trace_writes_profile(self, tmp_path):
        with trace(tmp_path / "prof"):
            with annotate("matmul"):
                x = torch.ones((64, 64))
                (x @ x).sum().item()
        files = list((tmp_path / "prof").rglob("*"))
        assert any(f.is_file() for f in files)  # the trace file exists
        events = json.loads((tmp_path / "prof" / profiler.TRACE_FILE).read_text())["traceEvents"]
        assert any(e.get("name") == "matmul" for e in events)

    def test_memory_stats_shape(self):
        stats = memory_stats()
        assert set(stats) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
        if not torch.cuda.is_available():
            assert set(stats.values()) == {None}
