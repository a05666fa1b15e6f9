"""Find the HTTP cell's knee: open-loop windows at a few fixed rates against
one server set up once, on the card.

    python -m gpubench.knee_sweep --workload yolo_s.http_jpeg --rates 80,120,160,200 \\
        --seconds 8 --seed 1

For each rate: the requests due, those answered and their rate, p50 and
p95 latency (a failed request at the client's longest wait), the mean
batch fill, how late the generator ran, and the p50 latency of the last
third of the window over the first third (above 1 the backlog grows). The
knee is the highest rate at which every request is answered, the backlog
does not grow and the generator keeps its schedule; the cell's ``rate`` is
about 0.8 of it.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run as bench_run
from .drivers.http_open import Http, latencies_ms, percentile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="yolo_s.http_jpeg")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    import torch

    from . import common

    cell = common.load_json("cells", args.workload)
    config = common.load_json("configs", cell["config"])
    run_args = bench_run.parse_args(["--workload", args.workload, "--seed", str(args.seed),
                                     "--seconds", str(args.seconds)])
    run = bench_run.Run(run_args, cell, config, torch.device("cuda", 0), bench_run.T_START)
    h = Http(run)
    h.warm_up()
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            out = h.window(rate, args.seconds, args.seed + i)
            reqs = out["requests"]
            lat = latencies_ms(reqs, cell["grace_s"])
            ok = [r for r in reqs if r["latency"] is not None]
            third = max(1, len(reqs) // 3)
            first = [x for x in lat[:third]]
            last = [x for x in lat[-third:]]
            print(json.dumps({
                "rate": rate, "due": len(reqs), "answered": len(ok),
                "answered_per_s": len(ok) / args.seconds,
                "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
                "fill": out["batched_images"] / max(1, out["device_calls"]),
                "generator_late_ms": 1e3 * out["generator_late_s"],
                "backlog_growth": percentile(last, 50) / percentile(first, 50)}), flush=True)
    finally:
        h.free_program()
    return 0


if __name__ == "__main__":
    sys.exit(main())
