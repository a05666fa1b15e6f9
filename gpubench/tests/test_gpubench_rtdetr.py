"""The RT-DETR configuration and its two cells: they parse and are listed
where the benchmark reads them; the deformable rooflines' arithmetic by
hand; the six new readers on fake runs; and, on the CPU at a toy size, the
cells' checks pass the program and fail its faults and the control."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from gpubench import common, deform_rooflines as dr, faults
from gpubench import run as bench_run
from multimodal_moe_torch.utils import profiler

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
SERVE, TRAIN = "rtdetr_r50vd.offline_b16", "rtdetr_r50vd.train_b16"
TINY = dict(hidden_dim=64, aifi_ffn_dim=256, backbone_depths=[1, 1, 1, 1], num_decoder_layers=2,
            num_queries=24)


def test_configuration_and_cells_parse():
    cfg = common.load_json("configs", "rtdetr_r50vd")
    assert cfg["family"] == "rtdetr" and cfg["reduced"] == []
    assert (cfg["backbone_depths"], cfg["hidden_dim"], cfg["num_heads"], cfg["aifi_ffn_dim"],
            cfg["num_decoder_layers"], cfg["decoder_ffn_dim"], cfg["num_levels"],
            cfg["num_points"], cfg["num_queries"]) == ([3, 4, 6, 3], 256, 8, 1024, 6, 1024, 3, 4,
                                                       300)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert any(c["name"] == "rtdetr_r50vd" and c["file"] == "gpubench/configs/rtdetr_r50vd.json"
               for c in bench["configs"])
    for name, driver, metric in ((SERVE, "rtdetr_offline", "serve_img_s"),
                                 (TRAIN, "rtdetr_train", "train_img_s")):
        cell = common.load_json("cells", name)
        assert cell["config"] == "rtdetr_r50vd" and cell["driver"] == driver
        assert cell["chips"] == 1 and cell["batch"] == 16
        assert (ROOT / "gpubench/drivers" / f"{driver}.py").is_file()
        e2e = {m["name"]: m for m in bench["end_to_end"]}
        assert name in e2e[metric]["workloads"]
        listed = [m["name"] for m in bench["per_layer"] if name in m.get("workloads", [])]
        assert len(listed) >= 5, listed
        for m in listed:
            assert (ROOT / "gpubench/metrics" / f"{m}.py").is_file()


def test_sampled_work_by_hand():
    """One image, one head, one level of 4×4, two points: the first at the
    centre of pixel (1, 1) (one corner, weight 1 there), the second half
    way between pixels (2, 2) and (3, 3) (four corners); then the same
    point again (no new rows) and one outside the map (nothing)."""
    loc = torch.tensor([[1.5 / 4, 1.5 / 4], [3.0 / 4, 3.0 / 4], [3.0 / 4, 3.0 / 4],
                        [2.0, 2.0]]).view(1, 1, 1, 1, 4, 2)
    attn = torch.full((1, 1, 1, 1, 4), 0.25)
    rows, corners = dr.sampled_work(loc, attn, [(4, 4)], 16)
    assert corners == 1 + 4 + 4
    assert rows == 1 + 4


def test_bounds_by_hand():
    counts = dict(batch=2, value_rows=100, queries=10, heads=8, levels=3, points=4)
    d, rows, corners = 32, 500, 3000
    points = 2 * 10 * 8 * 3 * 4
    fwd_bytes = 4 * (rows * d + 2 * points + points + 2 * 10 * 8 * d)
    fwd_ops = corners * 2 * d + points * 20
    s, by = dr.fwd_bound(counts, d, rows, corners)
    assert s == pytest.approx(max(fwd_bytes / 3.35e12, fwd_ops / 67e12))
    assert by == ("bytes" if fwd_bytes / 3.35e12 >= fwd_ops / 67e12 else "operations")
    bwd_bytes = fwd_bytes + 4 * (3 * points + 2 * 100 * 8 * d)
    bwd_ops = corners * 4 * d + points * (20 + 42)
    s, _ = dr.bwd_bound(counts, d, rows, corners)
    assert s == pytest.approx(max(bwd_bytes / 3.35e12, bwd_ops / 67e12))


def test_kernel_names():
    assert dr.is_fwd_kernel("void (anonymous namespace)::ms_deform_fwd_kernel<true>(float const*)")
    assert dr.is_fwd_kernel("_ZN12_GLOBAL__N_120ms_deform_fwd_kernelILb1EEEvPKf")
    assert dr.is_bwd_kernel("void (anonymous namespace)::ms_deform_bwd_kernel<true>(float*)")
    assert not dr.is_fwd_kernel("void (anonymous namespace)::ms_deform_bwd_kernel<true>()")


def _span(name, device_ms=1.0, host_ms=2.0, **counts):
    return {"name": name, "parent": None, "thread": "MainThread", "start_ns": 0, "end_ns": 1,
            "host_ms": host_ms, "device_ms": device_ms, "counts": counts}


DEFORM = dict(batch=16, value_rows=18018, queries=300, heads=8, levels=3, points=4)
LOG = [_span("rtdetr.decoder", 9.0, queries=300, layers=6) for _ in range(2)]
LOG += [_span("rtdetr.deform", 0.1, **DEFORM) for _ in range(12)]
LOG += [_span("detr.match", 5.0, 15.0, problems=112, columns=900) for _ in range(2)]


def _fake(kind, device="cuda", work=True, kernel_us=1000.0):
    cfg = common.load_json("configs", "rtdetr_r50vd")
    name = "ms_deform_fwd_kernel" if kind == "serve" else "ms_deform_bwd_kernel"
    layer = {"kind": kind, "steps": 2, "events": [(name, 0.0, kernel_us), ("other", 0.0, 5.0)]}
    if work:
        layer["deform_work"] = [(100_000, 400_000)] * 12
    return SimpleNamespace(layer=layer, device=torch.device(device), config=cfg)


@pytest.mark.parametrize("case", ["filled", "other_kind", "cpu", "no_spans", "no_work"])
def test_readers_on_fake_runs(case, monkeypatch):
    monkeypatch.setattr(profiler, "spans", lambda: list(LOG))
    if case == "no_spans":
        monkeypatch.delattr(profiler, "spans")
    for metric, kind, bound in (("deform_fwd_roofline.serve", "serve", dr.fwd_bound),
                                ("deform_bwd_roofline.train", "train", dr.bwd_bound),
                                ("detr_decoder_ms.serve", "serve", None),
                                ("detr_match_ms.train", "train", None)):
        run = _fake({"other_kind": "train" if kind == "serve" else "serve"}.get(case, kind),
                    "cpu" if case == "cpu" else "cuda", work=case != "no_work")
        got = bench_run.load_module("metrics", metric).read(run)
        if not (case == "filled" or (case == "no_work" and "roofline" not in metric)):
            assert got is None, (metric, case)
        elif metric == "detr_decoder_ms.serve":
            assert got == pytest.approx(9.0)
        elif metric == "detr_match_ms.train":
            assert got == pytest.approx(15.0)
        else:
            want = 12 * bound(DEFORM, 32, 100_000, 400_000)[0]
            assert got == pytest.approx(100.0 * want * 1e6 / 1000.0)


def _execute(workload, cell, config=None, fault=None, seconds="0.3"):
    undo = faults.plant(fault) if fault else (lambda: None)
    try:
        return bench_run.execute(["--workload", workload, "--seed", "2147483701",
                                  "--seconds", seconds, "--trace", "0"],
                                 device=torch.device("cpu"), cell_overrides=cell,
                                 config_overrides=dict(TINY, **(config or {})))
    finally:
        undo()


# Toy limits, set from toy readings on the CPU as the cells' own are set
# from theirs on the card (PERF.md §2), three seeds each. Serving: the bf16
# program reads up to 0.047 / 0.0020 / 0.0078 on logits, boxes and the
# encoder's logits, the fp8 control at least 0.47 / 0.021 / 0.116, half a
# batch left out at least 0.48 / 0.030 / 0.168. Training: the float32
# program reads under 5e-7 on every number (no TF32 on the CPU), the bf16
# control at least 0.030 on the forward's logits, 0.0017 on its boxes,
# 5.5e-4 on the loss and 0.0043 on the update; half a batch and an
# unchanged state read 1.0 on the forward.
SERVE_TOY = dict(batch=2, pool_batches=2, img_h=64, img_w=96, check_images=4, profile_steps=1,
                 max_det=24, checks={"logit_err": 0.15, "box_err": 0.007, "enc_err": 0.03})
TRAIN_TOY = dict(batch=2, pool_batches=3, img_h=64, img_w=96, max_boxes=6,
                 checks={"forward_logit_err": 0.01, "forward_box_err": 5e-4, "loss_gap": 2e-4,
                         "grad_gap": 2e-3, "update_gap": 2e-3, "ema_gap": 2e-3})


@pytest.mark.parametrize("fault", [None, "half_batch", "answer_altered"])
def test_serve_faults(fault):
    _, line = _execute(SERVE, SERVE_TOY, fault=fault)
    assert line["correct"] is (fault is None), line["checks"]
    failed = {k for k, v in line["checks"].items() if v["value"] > v["limit"]}
    if fault == "answer_altered":
        assert failed == {"tail_mismatch"}


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_train_faults(fault):
    _, line = _execute(TRAIN, TRAIN_TOY, fault=fault, seconds="0.1")
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("workload,kind,cell", [(SERVE, "fp8", SERVE_TOY),
                                                (TRAIN, "bf16", TRAIN_TOY)])
def test_control_fails_where_the_program_passes(workload, kind, cell):
    run, line = _execute(workload, cell, seconds="0.1")
    assert line["correct"] is True, line["checks"]
    control = run.state.control(kind)
    assert any(v > run.cell["checks"][k] for k, v in control.items() if k in run.cell["checks"])


def test_reference_and_its_harness_load_no_jax_and_the_reference_nothing_of_the_port():
    code = ("import json, sys; sys.path.insert(0, {root!r}); "
            "from gpubench.reference import rtdetr; {more}"
            "print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))")
    forbidden = {"jax", "jaxlib", "flax", "multimodal_moe_tpu"}
    for more, banned in (("", forbidden | {"multimodal_moe_torch"}),
                         ("from gpubench import rtdetr_common, deform_rooflines; ", forbidden)):
        out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT), more=more)],
                             cwd=str(ROOT), capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        assert not set(json.loads(out.stdout.strip().splitlines()[-1])) & banned


@pytest.mark.cuda
@pytest.mark.parametrize("workload,kind", [(SERVE, "fp8"), (TRAIN, "bf16")])
def test_program_passes_and_control_fails_at_the_cells_size(workload, kind):
    """On the card, at the cells' own size, three seeds: the program's run
    is correct and the control fails at least one of the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on the card")
    for seed in (2147483611, 2147483612, 2147483613):
        run, line = bench_run.execute(["--workload", workload, "--seed", str(seed),
                                       "--seconds", "3", "--trace", "0"])
        assert line["correct"], line["checks"]
        control = run.state.control(kind)
        assert any(v > run.cell["checks"][k] for k, v in control.items()
                   if k in run.cell["checks"]), control
        del run
