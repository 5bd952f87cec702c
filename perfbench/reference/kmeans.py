"""One iteration of Lloyd's algorithm, in blocks of rows.

The iteration assigns every row to the centroid with the least
``||c||^2 - 2 x.c``, sums the rows of each cluster, and moves each
nonempty cluster's centroid to its mean; an empty cluster keeps its
centroid.  The objective is the summed squared distance of every row to
the centroid it was assigned, before the update.

It carries the near-tie rule of the comparison: a row whose two best
scores lie closer than float32 round-off can tell apart may fall to
either centroid on a side that scores in float32, and ``step`` says how
far that can move each centroid.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perfbench.reference.precision import dtype_of, matmul

BLOCK = 1 << 20
UNIT_ROUNDOFF_F32 = 2.0 ** -24


def tie_margin(x_norm: torch.Tensor, c_max: float, d: int) -> torch.Tensor:
    """The most by which float32 round-off can move the difference of two
    scores ``||c||^2 - 2 x.c`` of a row of norm ``x_norm``: twice the
    bound (d + 2) u (||c||^2 + 2 ||x|| ||c||) on one score's error."""
    gamma = (d + 2) * UNIT_ROUNDOFF_F32
    return 2.0 * gamma * (c_max * c_max + 2.0 * x_norm * c_max)


def step(x: torch.Tensor, c0: torch.Tensor, precision: str = "float64",
         block: int = BLOCK
         ) -> Tuple[torch.Tensor, float, torch.Tensor]:
    """One Lloyd iteration from ``c0`` -> (centroids, objective, allowance).

    ``allowance`` (K,) is how far a side that scores in float32 may put
    each centroid from these by near ties alone: every row whose two best
    scores lie within ``tie_margin`` may join either cluster, and moves
    each of the two by at most its distance to the cluster's new centroid
    over the cluster's count of rows that are not tied."""
    dt = dtype_of(precision)
    c = c0.to(dt).clone()
    k, d = c.shape
    sums = torch.zeros((k, d), dtype=dt, device=x.device)
    counts = torch.zeros(k, dtype=torch.int64, device=x.device)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    c2 = (c * c).sum(1)
    c_max = float(c2.max().sqrt())
    tied_rows, tied_ids = [], []
    for i in range(0, x.shape[0], block):
        xb = x[i:i + block].to(dt)
        scores = c2 - 2.0 * matmul(xb, c.t(), precision)
        best = torch.topk(scores, min(2, k), dim=1, largest=False)
        ids = best.indices[:, 0]
        sums.index_add_(0, ids, xb)
        counts += torch.bincount(ids, minlength=k)
        total += ((xb - c[ids]) ** 2).sum(dtype=torch.float64)
        if k > 1:
            gap = best.values[:, 1] - best.values[:, 0]
            margin = tie_margin(torch.linalg.vector_norm(xb, dim=1).double(),
                                c_max, d)
            tied = torch.nonzero(gap.double() <= margin).flatten()
            tied_rows.append(tied + i)
            tied_ids.append(best.indices[tied])
    new = torch.where((counts > 0)[:, None],
                      sums / counts.clamp_min(1)[:, None].to(dt), c)
    allowance = torch.zeros(k, dtype=torch.float64, device=x.device)
    if tied_rows:
        rows = torch.cat(tied_rows)
        pairs = torch.cat(tied_ids)
        firm = (counts - torch.bincount(pairs[:, 0], minlength=k)).clamp_min(1)
        xt = x[rows].to(torch.float64)
        for j in range(pairs.shape[1]):
            dist = torch.linalg.vector_norm(
                xt - new[pairs[:, j]].to(torch.float64), dim=1)
            allowance.index_add_(0, pairs[:, j], dist / firm[pairs[:, j]])
    return new, float(total), allowance
