"""K-means (Lloyd's algorithm) on one device.

Counterpart of the in-memory part of ``audio_tokens_tpu/ops/kmeans.py``:
``kmeans_fit``, ``_lloyd_stats``, the Lloyd loop, ``_split_empty_clusters``,
``kmeans_plusplus_init``, ``precision_from_str`` and the warm-start
``KMeans`` class.  Replaces FAISS ``Kmeans`` (reference:
processors/cluster_creator.py:42-56).

Each Lloyd iteration makes two passes over the points:

* the assignment, ``argmin_k ||c_k||^2 - 2 x.c_k`` with the lowest index
  winning ties: kernel B2 with ``normalize=False`` (``ops/cuda_vq.py``) for
  CUDA tensors, its plain version for CPU tensors;
* the centroid sums, from the rows sorted by cluster: f64 running sums in
  blocks of sorted rows and one small GEMM over the runs
  (``cluster_sums``).  This moves O(N*d) bytes where the JAX package's
  one-hot GEMM does 2*N*K*d operations, as many as the assignment, and it
  uses no atomics, so two fits of the same points are bit-equal
  (``index_add_`` on CUDA adds with atomics, in an order that changes from
  run to run).

Counts are integer bincounts.  The objective is the assignment's score
summed per cluster, ``sum_k n_k ||c_k||^2 - 2 c_k.S_k`` with ``S_k`` the
cluster's sum (no further pass over the points), plus ``sum ||x||^2``
computed once.  As in the JAX package it is the objective of the LAST
iteration's assignment, taken with the centroids from before that
iteration's update.

Random draws follow the JAX function: one ``np.random.default_rng(seed)``
draws the ``max_points_per_centroid`` subsample first and then the
``random`` init, so both pick the same rows as the JAX package.
``kmeans++`` draws from a ``torch.Generator`` seeded with ``seed``: the JAX
package draws from ``jax.random``, whose bits torch cannot reproduce.

Not ported: ``kmeans_fit_streaming`` with its host, HBM and disk caches and
its wire formats (ROADMAP A2, second half), the matmul precision tiers
other than ``"highest"`` (ROADMAP A6) and meshes (ROADMAP A7).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin

logger = logging.getLogger(__name__)

SUM_CHUNK = 65536  # rows a pass of sum ||x||^2 and of the k-means++ distances
SEGMENT_BLOCK = 256  # sorted rows a block of the centroid sums' running sums
_SPLIT_EPS = 1.0 / 1024.0  # FAISS's symmetric perturbation magnitude
EMPTY_POLICIES = ("keep", "split_largest")


def precision_from_str(name: str) -> str:
    """Config string -> the Lloyd loop's matmul precision.  Only
    ``'highest'`` (f32) is ported; ``'high'`` and ``'default'`` raise."""
    key = name.lower()
    if key not in ("highest", "high", "default"):
        raise ValueError(
            f"unknown kmeans_precision '{name}' (use highest|high|default)")
    if key != "highest":
        raise NotImplementedError(
            f"kmeans_precision='{name}' is not ported yet; only 'highest' "
            "(float32) is: ROADMAP A6")
    return key


def _points(x, device: Optional[torch.device | str]) -> torch.Tensor:
    """numpy or tensor -> contiguous f32 tensor on ``device``; without one,
    on the tensor's own device, and numpy on ``cuda:0``."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda:0"
    return torch.as_tensor(x).to(device=device,
                                 dtype=torch.float32).contiguous()


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of every row (int32): kernel B2 on the card."""
    return vq_argmin(x, centroids, normalize=False)


def cluster_sums(x: torch.Tensor, ids: torch.Tensor, k: int,
                 block: int = SEGMENT_BLOCK
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (K, d) f32, counts (K,) f32) of the rows of each cluster, in a
    fixed order on any device.

    The rows are sorted by cluster (a stable sort), summed as f64 running
    sums within blocks of ``block`` sorted rows, and each run of one
    cluster inside a block is the difference of two running sums; a
    cluster's runs (about N / block + K of them in all) are then added by
    an f64 product with their one-hot (K, runs) matrix.  Every step is a
    sort, a gather, a scan along an outer dimension or a GEMM: no atomics.
    """
    n, d = x.shape
    sid, order = torch.sort(ids, stable=True)
    xs = x[order]
    m = n - n % block
    run = torch.empty((n, d), dtype=torch.float64, device=x.device)
    torch.cumsum(xs[:m].view(-1, block, d), 1, dtype=torch.float64,
                 out=run[:m].view(-1, block, d))
    torch.cumsum(xs[m:], 0, dtype=torch.float64, out=run[m:])
    del xs
    pos = torch.arange(n, device=x.device)
    last = pos % block == block - 1  # a run ends at its block's end ...
    last[:-1] |= sid[1:] != sid[:-1]  # ... or where the cluster changes
    last[-1] = True
    ends = last.nonzero().flatten()
    at_end = run[ends]
    runs = at_end.clone()
    same_block = (ends[1:] // block == ends[:-1] // block)[:, None]
    runs[1:] -= torch.where(same_block, at_end[:-1], 0.0)
    onehot = (sid[ends][None, :] == torch.arange(
        k, dtype=sid.dtype, device=x.device)[:, None]).to(torch.float64)
    sums = (onehot @ runs).to(torch.float32)
    counts = torch.bincount(ids, minlength=k).to(torch.float32)
    return sums, counts


def _lloyd_stats(x: torch.Tensor, centroids: torch.Tensor):
    """One assignment pass: centroid sums (K, d), counts (K,) and the
    assignment's summed score ``sum_i ||c_a(i)||^2 - 2 x_i.c_a(i)`` (f64;
    the ``||x||^2`` term is added once by the caller)."""
    ids = assign(x, centroids)
    sums, counts = cluster_sums(x, ids, centroids.shape[0])
    c = centroids.double()
    score = ((counts.double() * (c * c).sum(1)).sum()
             - 2.0 * (c * sums.double()).sum())
    return sums, counts, score


def _sum_squares(x: torch.Tensor, chunk: int = SUM_CHUNK) -> torch.Tensor:
    """sum ||x_i||^2 in f64, ``chunk`` rows at a time."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        xc = x[i : i + chunk]
        total += (xc * xc).sum(dtype=torch.float64)
    return total


def _split_empty_clusters(centroids: torch.Tensor, counts: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's deterministic FAISS-style repair: each empty
    centroid, in index order, becomes a copy of the largest cluster's
    centroid (argmax count, first index on ties) times 1 +- 1/1024 by
    dimension parity, the donor takes the opposite sign, and the donor's
    count is halved between the two."""
    empties = (counts == 0).nonzero().flatten().tolist()
    if not empties:
        return centroids, counts
    centroids, counts = centroids.clone(), counts.clone()
    parity = torch.arange(centroids.shape[1], device=centroids.device) % 2 == 0
    up = torch.where(parity, 1.0 + _SPLIT_EPS, 1.0 - _SPLIT_EPS).float()
    dn = torch.where(parity, 1.0 - _SPLIT_EPS, 1.0 + _SPLIT_EPS).float()
    for i in empties:
        donor = int(torch.argmax(counts))
        c = centroids[donor].clone()
        half = counts[donor] / 2.0
        centroids[i] = c * up
        centroids[donor] = c * dn
        counts[i] = half
        counts[donor] = half
    return centroids, counts


def _lloyd_loop(x: torch.Tensor, centroids: torch.Tensor, niter: int,
                empty_policy: str = "keep") -> Tuple[torch.Tensor, float]:
    """niter Lloyd iterations -> (centroids, the last assignment's
    objective; 0.0 for niter 0)."""
    x2 = _sum_squares(x)
    obj = None
    for _ in range(niter):
        sums, counts, score = _lloyd_stats(x, centroids)
        new = torch.where((counts > 0)[:, None],
                          sums / counts.clamp_min(1.0)[:, None], centroids)
        if empty_policy == "split_largest":
            new, _ = _split_empty_clusters(new, counts)
        centroids, obj = new, score
    return centroids, 0.0 if obj is None else float(obj + x2)


def _sq_dist_to(x: torch.Tensor, c: torch.Tensor,
                chunk: int = SUM_CHUNK) -> torch.Tensor:
    """||x_i - c||^2 for every row, ``chunk`` rows at a time."""
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], chunk):
        out[i : i + chunk] = ((x[i : i + chunk] - c) ** 2).sum(1)
    return out


def kmeans_plusplus_init(x, k: int, seed: int = 1234,
                         device: Optional[torch.device | str] = None
                         ) -> torch.Tensor:
    """Seeded k-means++ (D^2-weighted greedy) initialization on the points'
    device: the first row uniformly, then each next row with probability
    proportional to its squared distance to the nearest row chosen so far
    (a Gumbel-max draw over ``log D^2``, as ``jax.random.categorical``:
    rows at distance 0 are never drawn)."""
    x = _points(x, device)
    n = x.shape[0]
    if n < k:
        raise ValueError(f"need at least k={k} points, got {n}")
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    chosen = torch.empty(k, dtype=torch.long, device=x.device)
    chosen[0] = torch.randint(n, (1,), generator=gen, device=x.device)[0]
    min_d2 = _sq_dist_to(x, x[chosen[0]])
    for i in range(1, k):
        u = torch.rand(n, generator=gen, device=x.device)
        logits = torch.log(min_d2.clamp_min(0.0)) - torch.log(-torch.log(u))
        chosen[i] = torch.argmax(logits)
        min_d2 = torch.minimum(min_d2, _sq_dist_to(x, x[chosen[i]]))
    return x[chosen]


def kmeans_fit(
    x,
    k: int,
    niter: int = 20,
    *,
    seed: int = 1234,
    init_centroids=None,
    precision: str = "highest",
    max_points_per_centroid: Optional[int] = None,
    init: str = "random",
    empty_policy: str = "keep",
    device: Optional[torch.device | str] = None,
) -> Tuple[torch.Tensor, float]:
    """Fit K-means; returns (centroids (k, d) f32 tensor, final objective).

    ``x`` is numpy or a tensor of any float dtype, (n, d).  The fit and its
    result live on ``device``; without one, on the tensor's device, and a
    numpy input goes to ``cuda:0``.  Points already on that device are not
    copied.
    """
    precision_from_str(precision)
    if empty_policy not in EMPTY_POLICIES:
        raise ValueError(f"unknown empty_policy '{empty_policy}' "
                         f"(use {'|'.join(EMPTY_POLICIES)})")
    x = _points(x, device)
    n, d = x.shape
    rng = np.random.default_rng(seed)

    if max_points_per_centroid is not None and n > k * max_points_per_centroid:
        sel = rng.choice(n, size=k * max_points_per_centroid, replace=False)
        x = x[torch.from_numpy(np.sort(sel)).to(x.device)]
        n = x.shape[0]

    if init_centroids is None:
        if n < k:
            raise ValueError(f"need at least k={k} points, got {n}")
        if init == "kmeans++":
            init_centroids = kmeans_plusplus_init(x, k, seed=seed)
        elif init == "random":  # FAISS default: k distinct sample points
            init_centroids = x[torch.from_numpy(
                rng.choice(n, size=k, replace=False)).to(x.device)]
        else:
            raise ValueError(f"unknown init '{init}'")
    centroids = _points(init_centroids, x.device).reshape(k, d)
    return _lloyd_loop(x, centroids, niter, empty_policy)


class KMeans:
    """faiss.Kmeans-shaped wrapper with warm-start ``train`` semantics.

    Reference call pattern (processors/cluster_creator.py:42-56):

        km = KMeans(d, k, niter=20)
        km.train(batch0)
        km.train(batch1, init_centroids=km.centroids)
    """

    def __init__(
        self,
        d: int,
        k: int,
        niter: int = 20,
        seed: int = 1234,
        max_points_per_centroid: Optional[int] = None,
        precision: str = "highest",
        init: str = "random",
        empty_policy: str = "keep",
        device: Optional[torch.device | str] = None,
    ):
        self.d = d
        self.k = k
        self.niter = niter
        self.seed = seed
        self.max_points_per_centroid = max_points_per_centroid
        self.precision = precision
        self.init = init
        self.empty_policy = empty_policy
        self.device = device
        self.centroids: Optional[torch.Tensor] = None
        self.obj: float = float("nan")

    def train(self, x, init_centroids=None) -> float:
        self.centroids, self.obj = kmeans_fit(
            x,
            self.k,
            self.niter,
            seed=self.seed,
            init_centroids=init_centroids,
            precision=self.precision,
            max_points_per_centroid=self.max_points_per_centroid,
            init=self.init,
            empty_policy=self.empty_policy,
            device=self.device,
        )
        logger.info("kmeans objective: %.4f", self.obj)
        return self.obj
