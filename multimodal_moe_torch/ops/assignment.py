"""Linear-sum assignment for the DETR matcher, solved on the host.

Counterpart of ``multimodal_moe_tpu/ops/assignment.py``, with its contract:
``batched_lsa_assign(cost (B, Q, M), col_valid (B, M)) → (B, M)``, the row
of an exact minimum-cost assignment for every valid column, and row 0 for
every invalid (padded) column.

The JAX package solves in the graph (Jonker-Volgenant in ``lax`` loops)
only because its TPU runtime has no host callbacks. Here the cost is
copied to the host once per call (one synchronising copy for all B
problems) and each problem's valid columns go to
``scipy.optimize.linear_sum_assignment``, as RT-DETRv2's own PyTorch
matcher does. This is the one route, on every device; its host time is
measured by ``chip_smoke.py``. The result goes back to the cost's device.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def batched_lsa_assign(cost: torch.Tensor, col_valid: "torch.Tensor | None" = None) -> torch.Tensor:
    """(B, Q, M) costs with Q ≥ M → (B, M) int64 assigned rows. Optional
    (B, M) bool ``col_valid``: invalid columns take no part and get row 0."""
    b, q, m = cost.shape
    if q < m:
        raise ValueError(f"need at least as many rows as columns, got Q={q} < M={m}")
    host = cost.detach().to("cpu", torch.float32).numpy()
    valid = (np.ones((b, m), bool) if col_valid is None
             else col_valid.detach().to("cpu", torch.bool).numpy())
    assigned = np.zeros((b, m), np.int64)
    for i in range(b):
        cols = np.flatnonzero(valid[i])
        if cols.size:
            rows, picked = linear_sum_assignment(host[i][:, cols])
            assigned[i, cols[picked]] = rows
    return torch.from_numpy(assigned).to(cost.device)


def assignment_margin(cost: np.ndarray, col_valid: np.ndarray) -> float:
    """How much dearer the second-best assignment of the valid columns of
    ``cost`` (Q, M) is than the best: any other assignment moves at least
    one column off its optimal row, so the second best is the cheapest
    re-solve with one optimal pair forbidden. A cost perturbation of at
    most δ per entry cannot change the optimum while the margin exceeds
    2·(valid columns)·δ: this decides where two devices' matchings must
    agree."""
    c = np.asarray(cost, np.float64)[:, np.asarray(col_valid, bool)]
    if c.shape[1] == 0:
        return float("inf")
    rows, cols = linear_sum_assignment(c)
    best, margin = c[rows, cols].sum(), float("inf")
    for r, j in zip(rows, cols):
        forbidden = c.copy()
        forbidden[r, j] = 1e12
        r2, c2 = linear_sum_assignment(forbidden)
        margin = min(margin, forbidden[r2, c2].sum() - best)
    return float(margin)
