"""The port's ``utils/profiler.py``: mirrors tests/test_profiler.py (CPU),
less ``StageTimer``, which the port does not keep (its spans are
tests/test_torch_tracing.py's)."""

import json

import torch

from multimodal_moe_torch.utils import profiler
from multimodal_moe_torch.utils.profiler import annotate, memory_stats, trace


class TestTrace:
    def test_trace_writes_profile(self, tmp_path):
        profiler.clear_spans()
        with trace(tmp_path / "prof"):
            with annotate("matmul"):
                x = torch.ones((64, 64))
                (x @ x).sum().item()
        files = list((tmp_path / "prof").rglob("*"))
        assert any(f.is_file() for f in files)  # the trace file exists
        events = json.loads((tmp_path / "prof" / profiler.TRACE_FILE).read_text())["traceEvents"]
        # a host op, not a user annotation (which the card would mirror on the device)
        assert [e.get("cat") for e in events if e.get("name") == "matmul"] == ["cpu_op"]
        assert [s["name"] for s in profiler.spans()] == ["matmul"]
        profiler.clear_spans()

    def test_memory_stats_shape(self):
        stats = memory_stats()
        assert set(stats) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
        if not torch.cuda.is_available():
            assert set(stats.values()) == {None}
