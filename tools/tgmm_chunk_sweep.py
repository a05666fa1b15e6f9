#!/usr/bin/env python3
"""How large tgmm's row chunks should be, measured on one NVIDIA GPU.

    python3 tools/tgmm_chunk_sweep.py

``gmm_kernel.tgmm`` cuts each expert's segment into chunks so that work
items × output tiles give every SM ``gmm_kernel._BLOCKS_PER_SM`` blocks
(``tgmm_rows_per_chunk``). This script times one tgmm launch (CUDA events,
mean of 5 after 1 warm-up) at the six level shapes of the MoE-YOLO-s B=16
training step, on ``chip_smoke.py``'s routed sizes and float32 inputs, for
targets of 1, 2, 4, 8 and 16 blocks an SM, in two rounds. It prints the
card's name and power limit, then one JSON object per round. Exits 1
without a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from multimodal_moe_torch.ops import gmm_kernel  # noqa: E402

TARGETS = (1, 2, 4, 8, 16)  # blocks an SM
ROUNDS = 2


@torch.inference_mode()
def main() -> int:
    if not torch.cuda.is_available():
        print("tgmm_chunk_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    problems = []
    for lvl, (t, d) in enumerate(zip(cs.GMM_LEVEL_TOKENS, cs.MOE_WIDTHS)):
        sizes = cs.routed_sizes(t, seed=40 + lvl, dev=dev)
        for name, k, n in ((f"level{lvl}_w1", d, 2 * d), (f"level{lvl}_w2", 2 * d, d)):
            lhs, _, g = cs.gmm_problem(sizes, k, n, torch.float32, 50 + len(problems), dev)
            problems.append((name, lhs, g, sizes))
    default = gmm_kernel._BLOCKS_PER_SM
    try:
        for r in range(ROUNDS):
            rows = []
            for name, lhs, g, sizes in problems:
                (m, k), n = lhs.shape, g.shape[1]
                row = {"case": name, "M": m, "K": k, "N": n, "ms": {}, "rows_per_chunk": {}}
                for target in TARGETS:
                    gmm_kernel._BLOCKS_PER_SM = target
                    row["rows_per_chunk"][target] = gmm_kernel.tgmm_rows_per_chunk(m, k, n, sms)
                    row["ms"][target] = cs.cuda_ms(lambda: gmm_kernel.tgmm(lhs, g, sizes),
                                                   reps=5, warmup=1)
                rows.append(row)
            sums = {t: sum(row["ms"][t] for row in rows) for t in TARGETS}
            print(json.dumps({"round": r, "sms": sms, "step_ms": sums, "cases": rows}))
    finally:
        gmm_kernel._BLOCKS_PER_SM = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
