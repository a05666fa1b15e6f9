"""The control of each cell, at a size a CPU test run holds: the reference
computed in the precision below the cell's (fp8 for the bf16 serving
cells, bfloat16 for the float32 ones under TF32) put in the program's
place fails at least one of the cell's limits, while the program's own run
passes them. On the card, at the cells' own sizes, the same is
``test_gpubench_cuda.py``."""

import pytest
import torch

from gpubench import run as bench_run

torch.set_num_threads(2)

# The toy size's limits where the cell's own (set at 704×1248 on the card)
# do not carry over: the bf16 program reads up to 0.12 / 0.08 here against
# the fp8 control's 0.35 / 0.23 (test_gpubench_faults.py); the HTTP cell's
# float32 program on the CPU reads ~3e-7 against the bf16 control's 2e-3 /
# 4.5e-4.
TOY_OFFLINE = {"logit_err": 0.2, "box_err": 0.15}
SMALL = {
    "moe_yolo_s.offline_b128": ("fp8", dict(batch=4, pool_batches=2, img_h=64, img_w=128,
                                            check_images=8, pool=64, max_det=20,
                                            checks=TOY_OFFLINE)),
    "yolo_s.offline_b128": ("fp8", dict(batch=4, pool_batches=2, img_h=64, img_w=128,
                                        check_images=8, pool=64, max_det=20,
                                        checks=TOY_OFFLINE)),
    "moe_yolo_s.train_b16": ("bf16", dict(batch=4, pool_batches=3, img_h=64, img_w=128,
                                          max_boxes=8)),
    "yolo_s.http_jpeg": ("bf16", dict(batch=4, img_h=64, img_w=128, frames=8, rate=25.0,
                                      connections=8, capture_calls=4, min_requests_checked=4,
                                      warmup_s=0.5, grace_s=20.0,
                                      checks={"logit_err": 5e-4, "box_err": 2e-4})),
}


@pytest.mark.parametrize("workload", list(SMALL))
def test_control_fails_where_the_program_passes(workload):
    kind, cell = SMALL[workload]
    run, line = bench_run.execute(["--workload", workload, "--seed", "2147483640",
                                   "--seconds", "1", "--trace", "0"],
                                  device=torch.device("cpu"), cell_overrides=cell,
                                  config_overrides=dict(dispatch="sweep"))
    assert line["correct"] is True, line["checks"]
    control = run.state.control(kind)
    failed = {k for k, v in control.items() if k in run.cell["checks"]
              and v > run.cell["checks"][k]}
    assert failed, control
