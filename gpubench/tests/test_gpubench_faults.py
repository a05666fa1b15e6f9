"""The check catches the faults a cell can have. Each test skips the
harness's look for a card and drives the rest of a run on the CPU at a
small size, with the port's timed path broken underneath
(``gpubench/faults.py``), and sees ``correct`` come out false, through the
cell's own limits. The sound run beside them comes out true."""

import pytest
import torch

from gpubench import faults
from gpubench import run as bench_run

torch.set_num_threads(2)

# At this toy size on the CPU the bf16 program reads logit and box errors
# of up to 0.12 and 0.08 against the float32 reference, the fp8 control at
# least 0.35 and 0.23, half a batch left out 0.57 and 0.19 (four seeds):
# the offline cells are held here to limits set from those readings as the
# cells' own are set from theirs at 704×1248 on the card (PERF.md §2).
OFFLINE = dict(batch=4, pool_batches=2, img_h=64, img_w=128, check_images=8, profile_steps=1,
               pool=64, max_det=20, checks={"logit_err": 0.2, "box_err": 0.15})
TRAIN = dict(batch=4, pool_batches=3, img_h=64, img_w=128, max_boxes=8)
HTTP = dict(batch=4, img_h=64, img_w=128, frames=8, rate=25.0, connections=8, capture_calls=4,
            conf=0.02, min_requests_checked=4, grace_s=20.0, warmup_s=0.5)
SWEEP = dict(dispatch="sweep")   # what "auto" resolves to at the cells' sizes


def _run(workload, cell, config=None, seconds="0.3", fault=None):
    undo = faults.plant(fault) if fault else (lambda: None)
    try:
        _, line = bench_run.execute(["--workload", workload, "--seed", "2147483701",
                                     "--seconds", seconds, "--trace", "0"],
                                    device=torch.device("cpu"), cell_overrides=cell,
                                    config_overrides=config)
    finally:
        undo()
    return line


def _failed(line) -> set:
    return {k for k, v in line["checks"].items() if v["value"] > v["limit"]}


@pytest.mark.parametrize("workload", ["yolo_s.offline_b128", "moe_yolo_s.offline_b128"])
def test_offline_faults(workload):
    assert _run(workload, OFFLINE, SWEEP)["correct"] is True
    line = _run(workload, OFFLINE, SWEEP, fault="half_batch")
    assert line["correct"] is False and _failed(line) & {"logit_err", "box_err"}
    line = _run(workload, OFFLINE, SWEEP, fault="answer_altered")
    assert line["correct"] is False and _failed(line) == {"tail_mismatch"}


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "answer_altered"])
def test_train_faults(fault):
    line = _run("moe_yolo_s.train_b16", TRAIN, SWEEP, seconds="0.1", fault=fault)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("fault", [None, "half_batch", "answer_altered"])
def test_http_faults(fault):
    line = _run("yolo_s.http_jpeg", HTTP, seconds="2", fault=fault)
    assert line["correct"] is (fault is None), line["checks"]
    if fault:
        assert _failed(line) & {"answer_mismatch", "decode_mismatch"}
