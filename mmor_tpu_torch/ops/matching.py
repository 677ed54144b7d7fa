"""Bipartite (Hungarian) assignment, solved exactly by scipy on the host.

Counterpart of ``mmor_tpu/ops/matching.py::hungarian_match`` on its
``callback`` path (the reference calls scipy's ``linear_sum_assignment`` per
batch element, `mask2former_video/modeling/matcher.py:155-160`). The cost
matrices are tiny (Q x N), so the host round trip is what the JAX package
does too. Its on-device ``auction`` backend comes with the training slice.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = 1e9


def _solve_batch(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment

    b, _q, n = cost.shape
    out = np.full((b, n), -1, dtype=np.int32)
    for i in range(b):
        cols = np.nonzero(valid[i])[0]
        if len(cols) == 0:
            continue
        c = np.nan_to_num(cost[i][:, cols], nan=_BIG, posinf=_BIG, neginf=-_BIG)
        rows, assigned = linear_sum_assignment(c)
        out[i, cols[assigned]] = rows.astype(np.int32)
    return out


def hungarian_match(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """cost: (B, Q, N) match costs; valid: (B, N) real-target flags.

    Returns (B, N) int32 on the cost's device: for each target, the assigned
    query index (-1 for padded targets). Each query goes to at most one
    target."""
    out = _solve_batch(cost.detach().float().cpu().numpy(),
                       valid.detach().bool().cpu().numpy())
    return torch.from_numpy(out).to(cost.device)
