"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "multimodal_moe_tpu"}

LOAD_ALL = """
import json, sys, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(2)
from gpubench import calibrate, common, faults, http_client, knee_sweep, rooflines, run
for kind in ("drivers", "metrics"):
    for path in sorted((run.ROOT / kind).glob("*.py")):
        if path.name != "__init__.py":
            run.load_module(kind, path.stem)
run.execute(["--workload", "yolo_s.offline_b128", "--seed", "1", "--seconds", "0.2",
             "--trace", "1"], device=torch.device("cpu"),
            cell_overrides=dict(batch=2, pool_batches=2, img_h=64, img_w=128, check_images=2,
                                profile_steps=1, pool=32, max_det=10))
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from gpubench.reference import detector, nms, tal, train
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_metrics_and_a_run_load_no_jax():
    names = _top_level(LOAD_ALL)
    assert "multimodal_moe_torch" in names        # the run did drive the port
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    names = _top_level(LOAD_REFERENCE)
    assert not names & (FORBIDDEN | {"multimodal_moe_torch"})


def test_the_run_refuses_a_process_that_holds_jax(monkeypatch):
    """The run's own look at ``sys.modules`` after the window, by whole
    top-level names: ``jax_like`` is not ``jax``, ``jax.numpy`` is."""
    import torch

    from gpubench import run as bench_run

    small = dict(batch=2, pool_batches=2, img_h=64, img_w=128, check_images=2, pool=32,
                 max_det=10)
    argv = ["--workload", "yolo_s.offline_b128", "--seed", "2", "--seconds", "0.1"]
    monkeypatch.setitem(sys.modules, "jax_like", sys)
    bench_run.execute(argv, device=torch.device("cpu"), cell_overrides=small)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    try:
        bench_run.execute(argv, device=torch.device("cpu"), cell_overrides=small)
    except SystemExit as e:
        assert "jax" in str(e)
    else:
        raise AssertionError("a process holding jax.numpy printed a result")
