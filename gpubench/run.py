"""Run one benchmark cell once and print its result line.

    python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``gpubench/cells/<cell>.json``; it names its configuration
(``gpubench/configs/<config>.json``) and its traffic driver
(``gpubench/drivers/<driver>.py``). The driver makes the weights and the
inputs on the card from the seed, warms up the cell's shapes, measures for
``--seconds``, and checks the outputs against the plain reference in
``gpubench/reference/``. With ``--trace 1`` a bounded stretch of the window
is profiled and each per-layer metric that ``BENCHMARK.json`` lists for the
cell is read by ``gpubench/metrics/<metric>.py``.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``), then ``checks``: each number compared with its limit. The
same numbers are the last lines on standard error. Without a card, with
fewer cards than the cell asks for, or with the JAX package loaded in this
process, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_moe_tpu")

# Caches stay at fixed paths inside the checkout (the port builds its CUDA
# sources into its own multimodal_moe_torch/build/); no library may bring in JAX.
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".triton_cache"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


class Run:
    """One run: what the driver is given and what it reports."""

    def __init__(self, args, cell: dict, config: dict, device, t_start: float):
        self.args = args
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.cell = cell
        self.config = config
        self.device = device
        self.t_start = t_start
        self.e2e: dict = {}
        self.attempted = 0
        self.window_elapsed = None      # seconds the window's work took
        self.failed = 0
        self.memory_peak = 0
        self.layer: dict = {}           # what the per-layer readers read
        self.breakdown = None
        self.busy_s = None
        self.window_s = None
        self.checks: list = []
        self.info: dict = {}             # readings printed beside the checks, not compared
        self.state = None               # the driver's own, for the calibration script

    def mark(self, phase: str) -> None:
        """Note the seconds since the process started at the end of a set-up phase."""
        self.info[f"setup.{phase}"] = time.perf_counter() - self.t_start

    def check(self, name: str, value: float, limit=None) -> None:
        """A number compared with its limit (``value <= limit``); the limit
        comes from the cell's ``checks`` unless given."""
        if limit is None:
            limit = self.cell["checks"][name]
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim in self.checks)


def load_module(kind: str, name: str):
    """``gpubench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(f"gpubench.{kind}.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_file() -> dict:
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def applies(entry: dict, workload: str) -> bool:
    return workload in entry.get("workloads", [workload])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(argv=None, *, device=None, cell_overrides: "dict | None" = None,
            config_overrides: "dict | None" = None) -> "tuple[Run, dict]":
    """Set up, measure and check one cell; return the run and its result
    line. ``device`` and the overrides are for tests on the CPU at a small
    size; a benchmark run passes none of them and needs the card."""
    from . import common

    args = parse_args(argv)
    import torch

    cell = dict(common.load_json("cells", args.workload), **(cell_overrides or {}))
    config = dict(common.load_json("configs", cell["config"]), **(config_overrides or {}))
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: this benchmark runs only on the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{args.workload} needs {cell['chips']} cards, "
                             f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
    run = Run(args, cell, config, device, T_START)
    run.mark("imports")
    load_module("drivers", cell["driver"]).run(run)

    bench = benchmark_file()
    metrics = {}
    if run.trace:
        for m in bench["per_layer"]:
            if applies(m, args.workload):
                value = load_module("metrics", m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, args.workload):
                metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}

    found = sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}: the benchmark measures the "
                         "PyTorch port alone")

    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(run.memory_peak)}
    if run.trace:
        dev["busy_s"] = run.busy_s
        dev["window_s"] = run.window_s
    line = {"correct": run.correct, "attempted": int(run.attempted), "failed": int(run.failed),
            "metrics": metrics, "device": dev}
    if run.trace and run.breakdown is not None:
        line["breakdown"] = run.breakdown
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return run, line


def main(argv=None) -> int:
    run, line = execute(argv)
    for name, value in run.info.items():
        print(f"info {name} = {value!r}", file=sys.stderr)
    for name, value, limit in run.checks:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
