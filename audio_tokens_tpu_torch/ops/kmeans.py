"""K-means (Lloyd's algorithm) on one device.

Counterpart of ``audio_tokens_tpu/ops/kmeans.py``: ``kmeans_fit``,
``_lloyd_stats``, the Lloyd loop, ``_split_empty_clusters``,
``kmeans_plusplus_init``, ``precision_from_str``, the warm-start ``KMeans``
class and ``kmeans_fit_streaming`` (a stream of super-batches through a
ring of pinned buffers, with device, host and disk caches, a bf16 wire and
mid-fit resume).  Replaces FAISS ``Kmeans`` (reference:
processors/cluster_creator.py:42-56).

Each Lloyd iteration makes two passes over the points:

* the assignment, ``argmin_k ||c_k||^2 - 2 x.c_k`` with the lowest index
  winning ties: kernel B2 with ``normalize=False`` (``ops/cuda_vq.py``) for
  CUDA tensors, its plain version for CPU tensors;
* the centroid sums, from the rows sorted by cluster (``tier_sums64``,
  ``ops/cuda_kmeans.py``): on the card one pass of ``csrc/kmeans.cu`` over
  the rows in sorted order, f64 sums a run of one cluster in a tile of
  sorted positions and the runs added in order; on the CPU f64 running
  sums in blocks of sorted rows and one small GEMM over the runs.  This
  moves O(N*d) bytes where the JAX package's one-hot GEMM does 2*N*K*d
  operations, as many as the assignment, and it uses no atomics, so two
  fits of the same points are bit-equal (``index_add_`` on CUDA adds with
  atomics, in an order that changes from run to run).

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

The streaming fit adds each super-batch's f64 sums and int64 counts on the
device and rounds the totals to f32 once an iteration, as the in-memory fit
rounds its f64 sums: a fit of one super-batch equals ``kmeans_fit`` bit for
bit, and any replay of the same stream (cache, spill, resume) equals
re-streaming it.  The JAX package adds f32 one-hot sums.

``precision`` is the Lloyd loop's matmul tier (``precision_from_str``):
``highest`` f32; ``high``, the TPU's ``Precision.HIGH``, is the bf16x3
split (``ops/tiers.py``) and ``default`` one bf16 pass.  At a bf16 tier B2
assigns on the tensor cores, and the centroid sums add the rows as the
JAX package's one-hot product at that tier sees them (the one-hot operand
is exact in bf16): ``bf16(x)`` at ``default``, ``hi(x) + lo(x)`` at
``high`` (the f64 sums of ``hi`` and of ``lo`` over the sorted rows, added).
The objective is the tier's assignment score, from those sums: ``n_k
||c_k||^2 - 2 c_k.S_k`` with the tier's product (``hi(c).(S_hi + S_lo) +
lo(c).S_hi`` at ``high``), plus ``sum ||x||^2`` of the f32 rows.

Multi-process: ``kmeans_fit_streaming(group=...)`` fits one corpus whose
streams are split over the ranks of a ``parallel/mesh.DataGroup`` (each
rank feeds its shard): rank 0 draws the init from its first super-batch and
broadcasts it, each rank adds its feeds' statistics into its own f64 sums
and int64 counts, and those are all-reduced once an iteration, so every
rank updates the same centroids; the point count is an exact int64 sum.
No collective runs inside the feed loop, so the ranks' feed counts need
not agree.  Meshes of devices within one process are not ported.

The wire meter (``utils/profiling.WIRE``) counts each host super-batch
whole, its padding included (the buffer the JAX feed puts), on the feed's
producer thread as its copy is queued; an iteration replayed from the
device cache counts as device time, from its start to the objective's host
read.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from audio_tokens_tpu_torch.ops.cuda_kmeans import SEGMENT_BLOCK, tier_sums64
from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
from audio_tokens_tpu_torch.ops.tiers import tier_operands
from audio_tokens_tpu_torch.utils.profiling import WIRE, span

logger = logging.getLogger(__name__)

SUM_CHUNK = 65536  # rows a pass of sum ||x||^2 and of the k-means++ distances
_SPLIT_EPS = 1.0 / 1024.0  # FAISS's symmetric perturbation magnitude
EMPTY_POLICIES = ("keep", "split_largest")


PRECISION_TIERS = {"highest": "highest", "high": "bf16x3",
                   "default": "default"}


def precision_from_str(name: str) -> str:
    """Config string -> the Lloyd loop's matmul tier (``ops/tiers.py``):
    ``highest`` -> ``highest``, ``high`` -> ``bf16x3`` (the TPU's
    Precision.HIGH), ``default`` -> ``default``."""
    key = name.lower()
    if key not in PRECISION_TIERS:
        raise ValueError(
            f"unknown kmeans_precision '{name}' (use highest|high|default)")
    return PRECISION_TIERS[key]


def _points(x, device: Optional[torch.device | str]) -> torch.Tensor:
    """numpy or tensor -> contiguous f32 tensor on ``device``; without one,
    on the tensor's own device, and numpy on ``cuda:0``."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda:0"
    return torch.as_tensor(x).to(device=device,
                                 dtype=torch.float32).contiguous()


def assign(x: torch.Tensor, centroids: torch.Tensor,
           tier: str = "highest") -> torch.Tensor:
    """Nearest centroid of every row (int32) at the tier: kernel B2 on the
    card."""
    return vq_argmin(x, centroids, normalize=False, tier=tier)


def cluster_sums64(x: torch.Tensor, ids: torch.Tensor, k: int,
                   block: int = SEGMENT_BLOCK) -> torch.Tensor:
    """(K, d) f64 sums of the rows of each cluster, in a fixed order on any
    device: ``tier_sums64`` at ``highest`` (the kernel on the card)."""
    return tier_sums64(x, ids, k, "highest", block)[0]


def cluster_sums(x: torch.Tensor, ids: torch.Tensor, k: int,
                 block: int = SEGMENT_BLOCK
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (K, d) f32, counts (K,) f32) of the rows of each cluster:
    ``cluster_sums64`` rounded to f32, and an integer bincount."""
    sums = cluster_sums64(x, ids, k, block).to(torch.float32)
    counts = torch.bincount(ids, minlength=k).to(torch.float32)
    return sums, counts


def _score(centroids: torch.Tensor, parts: torch.Tensor,
           counts: torch.Tensor, tier: str = "highest") -> torch.Tensor:
    """The assignment's summed score ``sum_k n_k ||c_k||^2 - 2 c_k.S_k``
    (f64) from the clusters' part sums (``tier_sums64``, each rounded to
    f32) and counts, the product at the tier: at bf16x3 ``hi(c).(S_hi +
    S_lo) + lo(c).S_hi``, the three passes summed over the rows."""
    c = centroids.double()
    s = parts.to(torch.float32).double()
    cp = [p.double() for p in tier_operands(centroids, tier)]
    dot = (cp[0] * s.sum(0)).sum()
    if len(cp) == 2:
        dot = dot + (cp[1] * s[0]).sum()
    return (counts.double() * (c * c).sum(1)).sum() - 2.0 * dot


def _lloyd_stats(x: torch.Tensor, centroids: torch.Tensor,
                 tier: str = "highest"):
    """One assignment pass at the tier: centroid sums (K, d), counts (K,)
    and the assignment's summed score ``sum_i ||c_a(i)||^2 - 2
    x_i.c_a(i)`` (f64; the ``||x||^2`` term is added once by the caller)."""
    k = centroids.shape[0]
    with span("lloyd.assign"):
        ids = assign(x, centroids, tier)
    with span("lloyd.sums"):
        parts = tier_sums64(x, ids, k, tier)
        counts = torch.bincount(ids, minlength=k).to(torch.float32)
        return (parts.sum(0).to(torch.float32), counts,
                _score(centroids, parts, counts, tier))


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
                empty_policy: str = "keep", tier: str = "highest"
                ) -> Tuple[torch.Tensor, float]:
    """niter Lloyd iterations at the tier -> (centroids, the last
    assignment's objective; 0.0 for niter 0)."""
    with span("kmeans.objective"):
        x2 = _sum_squares(x)
    obj = None
    for _ in range(niter):
        sums, counts, obj = _lloyd_stats(x, centroids, tier)
        with span("lloyd.update"):
            centroids = _update(centroids, sums, counts, empty_policy)
    if obj is None:
        return centroids, 0.0
    with span("kmeans.objective"):
        return centroids, float(obj + x2)


def _update(centroids: torch.Tensor, sums: torch.Tensor, counts: torch.Tensor,
            empty_policy: str) -> torch.Tensor:
    """The Lloyd update from f32 sums and counts: each nonempty cluster's
    mean; an empty one keeps its centroid or, under ``split_largest``,
    takes half of the largest cluster."""
    new = torch.where((counts > 0)[:, None],
                      sums / counts.clamp_min(1.0)[:, None], centroids)
    if empty_policy == "split_largest":
        new, _ = _split_empty_clusters(new, counts)
    return new


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
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, float]:
    """Fit K-means; returns (centroids (k, d) f32 tensor, final objective).

    ``x`` is numpy or a tensor of any float dtype, (n, d).  The fit and its
    result live on ``device``; without one, on the tensor's device, and a
    numpy input goes to ``cuda:0``.  Points already on that device are not
    copied.  ``n_valid``: fit only the first ``n_valid`` rows, a view of
    ``x`` (a capacity buffer with rows past its fill, as the fused device
    feed's), so the fit is ``kmeans_fit(x[:n_valid])``.
    """
    tier = precision_from_str(precision)
    if empty_policy not in EMPTY_POLICIES:
        raise ValueError(f"unknown empty_policy '{empty_policy}' "
                         f"(use {'|'.join(EMPTY_POLICIES)})")
    x = _points(x, device)
    if n_valid is not None:
        if not 0 < n_valid <= x.shape[0]:
            raise ValueError(f"n_valid={n_valid} outside (0, {x.shape[0]}]")
        x = x[:n_valid]
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
    return _lloyd_loop(x, centroids, niter, empty_policy, tier)


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


# --- the streaming fit ------------------------------------------------------

DEFAULT_CHUNK = 16384  # super-batch capacities are multiples of it
WIRES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _host_dtype(wire: torch.dtype) -> np.dtype:
    """numpy dtype of the wire's host buffers: f32, or bf16 as its raw
    uint16 bits."""
    return np.dtype(np.float32 if wire == torch.float32 else np.uint16)


def to_wire(rows, wire: torch.dtype) -> np.ndarray:
    """Frame rows -> the wire's host array: f32, or bf16 rounded to nearest
    even (``torch``'s f32 -> bf16 cast) kept as raw uint16 bits."""
    rows = np.asarray(rows, np.float32)
    if wire == torch.float32:
        return rows
    bf16 = torch.from_numpy(np.ascontiguousarray(rows)).to(torch.bfloat16)
    return bf16.view(torch.int16).numpy().view(np.uint16)


def _host_tensor(buf: np.ndarray) -> torch.Tensor:
    """A wire host array as a tensor of the wire's dtype (a view)."""
    if buf.dtype == np.uint16:
        return torch.from_numpy(buf.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(buf)


def _stats_accum(x: torch.Tensor, fill: int, centroids: torch.Tensor,
                 acc: tuple, tier: str = "highest") -> None:
    """One assignment pass at the tier over the first ``fill`` rows of a
    super-batch, ADDED into accumulators that stay on the device: ``acc =
    (part sums (parts, K, d) f64, counts (K,) int64, sum ||x||^2 f64 or
    None)``.

    B2 assigns (``assign``), ``tier_sums64`` adds the rows' f64 sums and
    an integer bincount the counts, so the accumulators hold the same
    values, in stream order, for any replay of the same stream; ``sum
    ||x||^2`` is added only where the caller passes its accumulator (the
    first pass).  A reduced-precision wire (bf16) is cast to f32 here, on
    the device, before B2 runs."""
    x = x[:fill]
    if x.dtype != torch.float32:
        x = x.float()
    sums, counts, x2 = acc
    with span("lloyd.assign"):
        ids = assign(x, centroids, tier)
    with span("lloyd.sums"):
        sums += tier_sums64(x, ids, centroids.shape[0], tier)
        counts += torch.bincount(ids, minlength=centroids.shape[0])
    if x2 is not None:
        with span("kmeans.objective"):
            x2 += _sum_squares(x)


class _SuperbatchFeeder:
    """Packs an iterator of (m_i, d) arrays into super-batches of a fixed
    ``capacity``, in the wire's host dtype (``to_wire``).

    ``feeds(batches, alloc)`` yields ``(buffer, fill)``; each buffer comes
    from ``alloc()`` (default: fresh zeros), which the streaming fit points
    at its ring of pinned buffers.  A CUDA tensor of exactly one capacity
    that arrives when no super-batch is half packed passes through
    untouched (a device-resident feed); any other tensor is packed on the
    host."""

    def __init__(self, capacity: int, d: int,
                 wire_dtype: torch.dtype = torch.float32):
        self.capacity = capacity
        self.d = d
        self.wire = wire_dtype

    def _zeros(self) -> np.ndarray:
        return np.zeros((self.capacity, self.d), _host_dtype(self.wire))

    def feeds(self, batches, alloc=None):
        alloc = alloc or self._zeros
        buf = None
        fill = 0
        for batch in batches:
            if isinstance(batch, torch.Tensor):
                if (batch.is_cuda and batch.shape[0] == self.capacity
                        and fill == 0):
                    yield batch, self.capacity
                    continue
                batch = batch.detach().to("cpu", torch.float32).numpy()
            batch = to_wire(batch, self.wire)
            if batch.ndim != 2 or batch.shape[1] != self.d:
                raise ValueError(
                    f"feed shape {batch.shape} != (rows, {self.d})")
            pos = 0
            while pos < len(batch):
                if buf is None:
                    buf = alloc()
                take = min(self.capacity - fill, len(batch) - pos)
                buf[fill : fill + take] = batch[pos : pos + take]
                fill += take
                pos += take
                if fill == self.capacity:
                    yield buf, fill
                    buf, fill = None, 0
        if fill:
            yield buf, fill


class _CacheReplay:
    """Feeder-shaped adapter: replays cached ``(rows, fill)`` entries (the
    trimmed tail too) into super-batch buffers from ``alloc()`` (the
    ring's), as the feeder packed them."""

    def feeds(self, cached, alloc):
        for arr, fill in cached:
            buf = alloc()
            buf[:fill] = arr[:fill]
            yield buf, fill


class _PinnedRing:
    """``n`` host buffers of one super-batch each and their copies to
    ``device``.

    On a CUDA device the buffers are pinned and each copy is issued with
    ``non_blocking=True`` on a side stream, followed by an event that the
    consumer's stream waits on; ``take`` hands a buffer out again only
    after its last copy's event has completed, so a buffer is never
    rewritten under a copy in flight.  ``n = depth + 2`` covers the
    feed pipeline: ``depth`` queued feeds, the one the consumer holds and
    the one being packed.  On the CPU the buffers are plain and the copy is
    a clone (no streams, no events)."""

    def __init__(self, n: int, capacity: int, d: int, wire: torch.dtype,
                 device: torch.device):
        self.shape = (capacity, d)
        self.wire = wire
        self.device = device
        self.cuda = device.type == "cuda"
        self._bufs: list = [None] * n  # (host tensor, numpy view)
        self._events: list = [None] * n
        self._i = -1
        self._stream = torch.cuda.Stream(device) if self.cuda else None

    def take(self) -> np.ndarray:
        self._i = (self._i + 1) % len(self._bufs)
        if self._events[self._i] is not None:
            self._events[self._i].synchronize()
        if self._bufs[self._i] is None:
            host = torch.empty(
                self.shape, pin_memory=self.cuda,
                dtype=torch.float32 if self.wire == torch.float32
                else torch.int16)
            self._bufs[self._i] = (host, host.numpy().view(
                _host_dtype(self.wire)))
        return self._bufs[self._i][1]

    def to_device(self, buf: np.ndarray, fill: int):
        """The first ``fill`` rows of the last buffer taken, on the device
        -> (tensor of the wire's dtype, the copy's event or None)."""
        host, view = self._bufs[self._i]
        if buf is not view:
            raise RuntimeError("a feed must be the ring's last buffer taken")
        src = host[:fill]
        event = None
        if self.cuda:
            with torch.cuda.stream(self._stream):
                x = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                x.copy_(src, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            self._events[self._i] = event
        else:
            x = src.clone()
        if self.wire == torch.bfloat16:
            x = x.view(torch.bfloat16)
        return x, event


def _FeedPipeline(feeder, source, ring: _PinnedRing, depth: int = 2):
    """Producer thread (``utils/worker.BoundedProducer``): packs the stream
    into the ring's buffers and starts each super-batch's copy to the
    device while the consumer computes on the previous ones, keeping
    ``depth`` feeds in flight.  Yields ``(x, fill, host buffer or the
    device feed, copy event or None)``."""
    from audio_tokens_tpu_torch.utils.worker import BoundedProducer

    def items():
        for buf, fill in feeder.feeds(source, ring.take):
            if isinstance(buf, torch.Tensor):  # device-resident feed
                yield buf, fill, buf, None
            else:
                WIRE.h2d(buf)  # the whole super-batch, as the JAX feed's
                x, event = ring.to_device(buf, fill)
                yield x, fill, buf, event

    return BoundedProducer(items(), depth=depth)


class _DiskSpill:
    """Disk tier of the stream cache: super-batches trimmed to their fill
    append to one sequential file during the first pass, in the wire's host
    dtype (bf16 as uint16 bits), and replay as ``np.memmap`` views.  The
    file is per-fit scratch: ``cleanup`` closes and deletes it."""

    def __init__(self, path, d: int, dtype: np.dtype, budget_mb: int):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.d = d
        self.dtype = np.dtype(dtype)
        self.budget = budget_mb << 20
        self.meta: list = []  # (row offset, fill)
        self.rows = 0
        self._f = open(self.path, "wb")
        self._mm = None

    def append(self, entry: np.ndarray, fill: int) -> bool:
        """Write one entry's first ``fill`` rows; False when the byte budget
        would overflow (the caller drops the spill)."""
        if (self.rows + fill) * self.d * self.dtype.itemsize > self.budget:
            return False
        entry[:fill].tofile(self._f)
        self.meta.append((self.rows, fill))
        self.rows += fill
        return True

    def seal(self) -> None:
        self._f.close()
        self._f = None
        self._mm = np.memmap(self.path, dtype=self.dtype, mode="r",
                             shape=(self.rows, self.d))

    def entries(self):
        """(view, fill) pairs, read on the feed pipeline's producer thread."""
        for off, fill in self.meta:
            yield self._mm[off : off + fill], fill

    def nbytes(self) -> int:
        return self.rows * self.d * self.dtype.itemsize

    def cleanup(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        self._mm = None
        self.path.unlink(missing_ok=True)


def kmeans_fit_streaming(
    batches_fn,
    k: int,
    niter: int = 20,
    *,
    d: Optional[int] = None,
    seed: int = 1234,
    init_centroids=None,
    superbatch_rows: int = 1 << 20,
    chunk: int = DEFAULT_CHUNK,
    precision: str = "highest",
    init: str = "random",
    empty_policy: str = "keep",
    cache_mb: int = 0,
    cache_spill_path=None,
    cache_spill_mb: int = 0,
    hbm_cache_mb: int = 0,
    pipeline_depth: int = 2,
    wire_dtype: torch.dtype = torch.float32,
    start_iter: int = 0,
    checkpoint_fn=None,
    device: Optional[torch.device | str] = None,
    group=None,
) -> Tuple[torch.Tensor, float, int]:
    """Lloyd over a stream of frames too large for host or device memory
    -> (centroids (k, d) f32 on ``device``, final objective, points seen).

    ``batches_fn()`` returns an iterator of (m_i, d) float arrays (numpy or
    tensors) and is called once per Lloyd iteration; the stream must be
    the same on every call.  Its rows are packed into super-batches of
    ``max(1, superbatch_rows // chunk) * chunk`` rows (the JAX package's
    capacity, so the same stream and seed draw the same ``random`` init
    rows), copied to ``device`` (``cuda:0`` unless given) by a producer
    thread through a ring of pinned buffers while the device computes, and
    each super-batch's statistics are added into f64 sums and int64 counts
    on the device (``_stats_accum``); the centroids are updated once an
    iteration, in f32, from those totals.  Replays of the same stream
    therefore give bit-equal fits.

    Caches, each engaged during the first pass and replayed after it:

    * ``hbm_cache_mb``: the copied super-batches stay on the device and
      later iterations run with no feeder and no copy.  Overflow drops
      them (logged) and falls back to the host tiers, else re-streams; once
      it seals, the host tiers are released.
    * ``cache_mb``: packed super-batches in host memory.  Overflow moves
      them to ``cache_spill_path`` (up to ``cache_spill_mb``; with
      ``cache_mb=0`` the cache lives on disk only), else drops the cache
      and re-streams every iteration (logged).  The spill file is deleted
      when the fit returns or fails.

    ``wire_dtype=torch.bfloat16`` rounds the frames to bf16 on the host
    (half the copy and cache bytes); they are cast back to f32 on the
    device.  Without ``init_centroids`` the init draws from the first
    super-batch with ``np.random.default_rng(seed)`` (``random``) or
    ``kmeans_plusplus_init``.  ``checkpoint_fn(completed_iters, centroids,
    obj)`` runs after every iteration; ``start_iter=j`` with those
    centroids as ``init_centroids`` resumes the fit bit-equal to an
    uninterrupted one (the ``sum ||x||^2`` term is collected again on the
    first resumed pass).  ``precision`` is the Lloyd tier, as in
    ``kmeans_fit``.

    ``group`` (a ``parallel/mesh.DataGroup``): each rank's ``batches_fn``
    streams its shard of one corpus.  Without ``init_centroids`` rank 0
    draws the init from its first super-batch and broadcasts it (refused
    where it holds fewer than k points); each iteration's f64 sums, int64
    counts and ``sum ||x||^2`` are all-reduced once, so every rank returns
    the same centroids, objective and global point count.  Every rank
    must pass ``init_centroids`` and ``start_iter`` alike; caches and
    spill files are each rank's own (give each rank its own
    ``cache_spill_path``).
    """
    tier = precision_from_str(precision)
    if empty_policy not in EMPTY_POLICIES:
        raise ValueError(f"unknown empty_policy '{empty_policy}' "
                         f"(use {'|'.join(EMPTY_POLICIES)})")
    if wire_dtype not in WIRES.values():
        raise ValueError(f"wire_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {wire_dtype}")
    device = (torch.device("cuda", 0) if device is None
              else torch.device(device))
    if d is None:
        probe = next(iter(batches_fn()), None)
        if probe is None:
            raise ValueError("empty stream")
        d = int(probe.shape[1])
    capacity = max(1, superbatch_rows // chunk) * chunk
    feeder = _SuperbatchFeeder(capacity, d, wire_dtype)
    ring = _PinnedRing(pipeline_depth + 2, capacity, d, wire_dtype, device)
    rng = np.random.default_rng(seed)

    centroids = None
    if init_centroids is not None:
        centroids = _points(init_centroids, device).reshape(k, d)
    if start_iter > 0 and centroids is None:
        raise ValueError(
            "start_iter > 0 resumes a prior fit and requires its "
            "checkpointed centroids as init_centroids")
    if start_iter >= niter:
        raise ValueError(f"start_iter {start_iter} >= niter {niter}")

    def init_from(buf, fill) -> torch.Tensor:
        if group is not None:
            return init_shared(buf, fill)
        return init_local(buf, fill)

    def init_shared(buf, fill) -> torch.Tensor:
        """Rank 0's init (from ``buf``, its first super-batch) on every
        rank; a rank whose stream is empty passes ``buf=None``."""
        n0 = int(group.all_reduce_(torch.tensor(
            [fill if group.rank == 0 else 0], dtype=torch.int64,
            device=device)))
        if n0 < k:
            raise ValueError(
                f"process 0's first super-batch has {n0} points < k={k}")
        c0 = (init_local(buf, fill) if group.rank == 0
              else torch.empty((k, d), dtype=torch.float32, device=device))
        group.broadcast_([c0])
        return c0

    def init_local(buf, fill) -> torch.Tensor:
        if fill < k:
            raise ValueError(f"first super-batch has {fill} points < k={k}")
        sample = (buf[:fill] if isinstance(buf, torch.Tensor)
                  else _host_tensor(buf[:fill])).float()
        if init == "kmeans++":
            return kmeans_plusplus_init(sample, k, seed=seed, device=device)
        if init == "random":
            rows = torch.from_numpy(rng.choice(fill, size=k, replace=False))
            return _points(sample[rows.to(sample.device)], device)
        raise ValueError(f"unknown init '{init}'")

    # a configured spill with cache_mb=0 caches on disk only: the host tier
    # overflows on its first entry and moves to the file
    want_spill = cache_spill_path is not None and cache_spill_mb > 0
    cache: Optional[list] = [] if (cache_mb > 0 or want_spill) else None
    spill: Optional[_DiskSpill] = None
    cache_sealed = False
    cache_bytes = 0
    hbm: Optional[list] = [] if hbm_cache_mb > 0 else None
    hbm_sealed = False
    hbm_bytes = 0
    n_total = 0
    obj = float("nan")
    x2_total = None  # sum ||x||^2, collected on the first pass
    try:
        for it in range(start_iter, niter):
            first_pass = it == start_iter
            t_iter = time.perf_counter()
            t_wait = 0.0
            parts = 2 if tier == "bf16x3" else 1
            acc = (torch.zeros((parts, k, d), dtype=torch.float64,
                               device=device),
                   torch.zeros(k, dtype=torch.int64, device=device),
                   torch.zeros((), dtype=torch.float64, device=device)
                   if x2_total is None else None)
            n_seen = 0
            from_hbm = hbm is not None and hbm_sealed
            from_cache = not from_hbm and cache_sealed
            if from_hbm:
                source = iter([(x, fill, None, None) for x, fill in hbm])
            elif from_cache:
                source = _FeedPipeline(
                    _CacheReplay(),
                    cache if cache is not None else spill.entries(),
                    ring, depth=pipeline_depth)
            else:
                source = _FeedPipeline(feeder, batches_fn(), ring,
                                       depth=pipeline_depth)
            try:
                feeds = iter(source)
                t_last = time.perf_counter()
                while (item := next(feeds, None)) is not None:
                    t_wait += time.perf_counter() - t_last
                    x, fill, buf, event = item
                    if event is not None:
                        stream = torch.cuda.current_stream(device)
                        stream.wait_event(event)
                        x.record_stream(stream)
                    if centroids is None:
                        centroids = init_from(buf, fill)
                    _stats_accum(x, fill, centroids, acc, tier)
                    n_seen += fill
                    if hbm is not None and not hbm_sealed:
                        hbm_bytes += x.numel() * x.element_size()
                        if hbm_bytes > hbm_cache_mb * (1 << 20):
                            logger.info(
                                "HBM corpus cache dropped: exceeds "
                                "hbm_cache_mb=%d (falling back to %s)",
                                hbm_cache_mb,
                                "host cache" if cache is not None
                                else "disk spill" if spill is not None
                                else "re-stream")
                            hbm = None
                        else:
                            hbm.append((x, fill))
                    if ((cache is not None or spill is not None)
                            and not cache_sealed and buf is not None):
                        if isinstance(buf, torch.Tensor):
                            logger.info(
                                "stream cache disabled: device-resident feeds")
                            if spill is not None:
                                spill.cleanup()
                            cache = spill = None
                        elif spill is not None:
                            if not spill.append(buf, fill):
                                logger.info(
                                    "stream spill dropped: corpus exceeds "
                                    "cache_spill_mb=%d (each Lloyd iteration "
                                    "re-streams)", cache_spill_mb)
                                spill.cleanup()
                                spill = None
                        else:
                            # the ring rewrites its buffers: keep a copy
                            entry = buf[:fill].copy()
                            cache_bytes += entry.nbytes
                            if cache_bytes <= cache_mb * (1 << 20):
                                cache.append((entry, fill))
                            elif want_spill:
                                # host overflow -> disk: move what is cached,
                                # append the rest to the file
                                spill = _DiskSpill(cache_spill_path, d,
                                                   entry.dtype, cache_spill_mb)
                                ok = all(spill.append(e, f)
                                         for e, f in cache + [(entry, fill)])
                                cache = None
                                if ok:
                                    logger.info(
                                        "stream cache spilled to disk: %s "
                                        "(exceeded cache_mb=%d)",
                                        cache_spill_path, cache_mb)
                                else:
                                    logger.info(
                                        "stream spill dropped: corpus exceeds "
                                        "cache_spill_mb=%d (each Lloyd "
                                        "iteration re-streams)",
                                        cache_spill_mb)
                                    spill.cleanup()
                                    spill = None
                            else:
                                logger.info(
                                    "stream cache dropped: corpus exceeds "
                                    "cache_mb=%d (each Lloyd iteration "
                                    "re-streams)", cache_mb)
                                cache = None
                    t_last = time.perf_counter()
            finally:
                if hasattr(source, "close"):
                    source.close()
            if centroids is None and group is not None:
                centroids = init_from(None, 0)  # this rank's shard is empty
            if first_pass:
                n_total = n_seen
                if group is not None:
                    n_total = int(group.all_reduce_(torch.tensor(
                        n_seen, dtype=torch.int64, device=device)))
                if n_total == 0:
                    raise ValueError("empty stream")
                if hbm is not None:
                    hbm_sealed = True
                    logger.info(
                        "HBM corpus cache sealed: %d super-batches, %.0f MB "
                        "on %s", len(hbm), hbm_bytes / (1 << 20), device)
                    if cache is not None or spill is not None:
                        logger.info("host stream cache released: HBM replay "
                                    "supersedes it")
                        if spill is not None:
                            spill.cleanup()
                        cache = spill = None
                    ring = None  # no host feed is left to copy
                if cache is not None:
                    cache_sealed = True
                    logger.info("stream cache sealed: %d super-batches, "
                                "%.0f MB", len(cache), cache_bytes / (1 << 20))
                elif spill is not None:
                    spill.seal()
                    cache_sealed = True
                    logger.info(
                        "stream cache sealed on disk: %d super-batches, %.0f "
                        "MB at %s", len(spill.meta),
                        spill.nbytes() / (1 << 20), spill.path)
            if group is not None:  # the one exchange of the iteration
                for t in acc:
                    if t is not None:
                        group.all_reduce_(t)
            parts64, counts64, x2 = acc
            sums = parts64.sum(0).to(torch.float32)
            counts = counts64.to(torch.float32)
            with span("kmeans.objective"):
                if x2 is not None:
                    x2_total = float(x2)
                obj = float(_score(centroids, parts64, counts, tier)
                            + x2_total)
            if from_hbm:  # no feed, no wire: the iteration is device work
                WIRE.device_add(time.perf_counter() - t_iter)
            with span("lloyd.update"):
                centroids = _update(centroids, sums, counts, empty_policy)
            logger.info(
                "streaming kmeans iter %d/%d: %d pts, obj=%.4f (%.2fs, "
                "waiting on stream %.3fs%s)", it + 1, niter, n_total, obj,
                time.perf_counter() - t_iter, t_wait,
                ", device-resident" if from_hbm
                else ", cached stream" if from_cache else "")
            if checkpoint_fn is not None:
                checkpoint_fn(it + 1, centroids, obj)
    finally:
        if spill is not None:
            spill.cleanup()
    return centroids, obj, n_total
