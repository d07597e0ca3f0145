"""Mean squared distance to the 3 nearest neighbours (simple-knn equivalent).

Port of ``dreamgaussian_tpu/ops/knn.py``: exact, blocked over rows, with
pairwise squared distances as ``|a|^2 + |b|^2 - 2 a.b`` clamped at 0 and
the point itself excluded. Used once at init to size each gaussian.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def mean_knn_sq_dist(points: torch.Tensor, k: int = 3, block_size: int = 1024) -> torch.Tensor:
    """[N, 3] points -> [N] mean squared distance to their k nearest others."""
    points = points.float()
    n = points.shape[0]
    sq = torch.sum(points * points, dim=-1)
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    cols = torch.arange(n, device=points.device)
    for start in range(0, n, block_size):
        blk = points[start:start + block_size]
        d2 = sq[start:start + block_size, None] + sq[None, :] - 2.0 * (blk @ points.T)
        d2 = torch.clamp_min(d2, 0.0)
        rows = cols[start:start + block_size]
        d2[torch.arange(rows.shape[0], device=points.device), rows] = torch.inf
        out[start:start + block_size] = torch.topk(d2, k, dim=-1, largest=False).values.mean(-1)
    return out
