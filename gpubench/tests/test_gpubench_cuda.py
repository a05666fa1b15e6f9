"""On the card, at each cell's own size: the program's run is correct, and
the control (the reference computed in the precision below the cell's: fp8
for bf16, bfloat16 for float32 under TF32) fails at least one of the cell's
limits, on three seeds. Marked ``cuda``; each test skips without a card.

    python -m pytest gpubench/tests -q -m cuda
"""

import pytest
import torch

from gpubench import run as bench_run

pytestmark = pytest.mark.cuda

CONTROL = {"moe_yolo_s.offline_b128": "fp8", "moe_yolo_s.train_b16": "bf16",
           "yolo_s.offline_b128": "fp8", "yolo_s.http_jpeg": "bf16"}


@pytest.mark.parametrize("workload", list(CONTROL))
def test_program_passes_and_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on the card")
    for seed in (2147483601, 2147483602, 2147483603):
        run, line = bench_run.execute(["--workload", workload, "--seed", str(seed),
                                       "--seconds", "3", "--trace", "0"])
        assert line["correct"], line["checks"]
        control = run.state.control(CONTROL[workload])
        assert any(v > run.cell["checks"][k] for k, v in control.items()), control
        del run
