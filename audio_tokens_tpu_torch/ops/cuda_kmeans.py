"""The K-means centroid sums (``csrc/kmeans.cu``): the (parts, K, d) f64
sums of each cluster's rows at a precision tier, in one pass over the rows.

Replaces no Pallas kernel: the JAX package forms these sums as a one-hot
product inside ``_lloyd_stats`` (``audio_tokens_tpu/ops/kmeans.py:70``,
``:90-91``), which does as many operations as the assignment.  The port
sums the rows sorted by cluster, with no atomics, so that two fits of the
same points are bit-equal on the card.  The parts are the rows as the
tier's one-hot product sees them (``tier_operands``): x at ``highest``,
``bf16(x)`` at ``default``, ``hi(x)`` and ``lo(x)`` apart at ``bf16x3``.

``tier_sums64`` is the wrapper: for CUDA tensors it sorts the ids
(``torch.sort``, stable), finds each cluster's sorted positions
(``torch.searchsorted``) and launches the kernel's two passes (per-tile
runs, then each cluster's runs added in order), counting the call in
``tier_sums64.launches``; for CPU tensors it runs ``tier_sums64_plain``,
the f64 running sums in blocks of sorted rows and a one-hot product of the
runs.  ``sums_decomposition`` renders the kernel's own order of additions in
plain PyTorch (tiles of sorted positions, a sequential f64 sum a run,
runs added in order): the card tests hold the kernel to it bit for bit,
the CPU tests hold it to per-cluster numpy sums.
"""

from __future__ import annotations

import torch

from audio_tokens_tpu_torch.ops import _build
from audio_tokens_tpu_torch.ops.tiers import TIERS, check_tier, tier_operands

# sorted positions a block: the kernel's tile (a warp's runs,
# csrc/kmeans.cu), the plain version's block of running sums
SEGMENT_BLOCK = 256


def _sorted_sums64(xs: torch.Tensor, sid: torch.Tensor, k: int,
                   block: int = SEGMENT_BLOCK) -> torch.Tensor:
    """(K, d) f64 sums of rows already sorted by cluster (``sid`` their
    sorted ids): f64 running sums within blocks of ``block`` sorted rows,
    each run of one cluster inside a block the difference of two running
    sums, a cluster's runs added by an f64 product with their one-hot
    (K, runs) matrix.  A sort, a scan and a GEMM: no atomics."""
    n, d = xs.shape
    m = n - n % block
    run = torch.empty((n, d), dtype=torch.float64, device=xs.device)
    torch.cumsum(xs[:m].view(-1, block, d), 1, dtype=torch.float64,
                 out=run[:m].view(-1, block, d))
    torch.cumsum(xs[m:], 0, dtype=torch.float64, out=run[m:])
    del xs
    pos = torch.arange(n, device=run.device)
    last = pos % block == block - 1  # a run ends at its block's end ...
    last[:-1] |= sid[1:] != sid[:-1]  # ... or where the cluster changes
    last[-1] = True
    ends = last.nonzero().flatten()
    at_end = run[ends]
    runs = at_end.clone()
    same_block = (ends[1:] // block == ends[:-1] // block)[:, None]
    runs[1:] -= torch.where(same_block, at_end[:-1], 0.0)
    onehot = (sid[ends][None, :] == torch.arange(
        k, dtype=sid.dtype, device=run.device)[:, None]).to(torch.float64)
    return onehot @ runs


def tier_sums64_plain(x: torch.Tensor, ids: torch.Tensor, k: int,
                      tier: str = "highest",
                      block: int = SEGMENT_BLOCK) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (N, d) f32 rows and (N,) ids
    -> (parts, K, d) f64, over one sort and one gather of the rows."""
    check_tier(tier)
    if x.shape[0] == 0:
        return x.new_zeros((2 if tier == "bf16x3" else 1, k, x.shape[1]),
                           dtype=torch.float64)
    sid, order = torch.sort(ids, stable=True)
    xs = x[order]
    return torch.stack([_sorted_sums64(part, sid, k, block)
                        for part in tier_operands(xs, tier)])


def sums_decomposition(x: torch.Tensor, ids: torch.Tensor, k: int,
                       tier: str = "highest",
                       tile: int = SEGMENT_BLOCK) -> torch.Tensor:
    """The kernel's order of additions in plain PyTorch (for small inputs:
    a Python loop over the runs).  The sorted positions fall in tiles of
    ``tile``; a run (a cluster's rows inside one tile) is summed row by row
    in f64 from 0; a cluster inside one tile is its run, a cluster that
    spans tiles t0 < t1 is its tail run in t0 plus its head runs in t0 + 1
    .. t1, added in that order; an empty cluster is 0."""
    check_tier(tier)
    n, d = x.shape
    sid, order = torch.sort(ids.cpu(), stable=True)
    parts = torch.stack(tier_operands(x.cpu()[order], tier)).double()
    out = torch.zeros((parts.shape[0], k, d), dtype=torch.float64)
    pieces = {}  # cluster -> its runs' sums, in tile order
    for t0 in range(0, n, tile):
        stop = min(n, t0 + tile)
        p = t0
        while p < stop:
            c = int(sid[p])
            q = p
            while q < stop and int(sid[q]) == c:
                q += 1
            run = torch.zeros((parts.shape[0], d), dtype=torch.float64)
            for r in range(p, q):
                run += parts[:, r]
            pieces.setdefault(c, []).append(run)
            p = q
    for c, runs in pieces.items():
        if 0 <= c < k:
            total = torch.zeros_like(runs[0])
            for run in runs:
                total += run
            out[:, c] = total
    return out.to(x.device)


def _lib():
    lib = _build.load("kmeans")
    fn = lib.atk_tier_sums64
    if fn.argtypes is None:
        P, I, L = _build.P, _build.I, _build.L
        fn.argtypes = [P, L, I, L, P, P, I, P, I, I, P, P, P, P]
        fn.restype = I
    return lib


def _tier_sums64_cuda(x: torch.Tensor, ids: torch.Tensor, k: int,
                      tier: str, tile: int) -> torch.Tensor:
    if x.dim() != 2 or x.dtype != torch.float32 or x.stride(1) != 1:
        raise ValueError(f"x must be (N, d) float32 with unit column "
                         f"stride, got {x.dtype} {tuple(x.shape)} strides "
                         f"{x.stride()}")
    if ids.dim() != 1 or ids.shape[0] != x.shape[0] or ids.device != x.device:
        raise ValueError(f"ids {tuple(ids.shape)} on {ids.device} do not "
                         f"match x {tuple(x.shape)} on {x.device}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be int32 or int64, got {ids.dtype}")
    if k < 1 or tile < 1:
        raise ValueError(f"need k >= 1 and tile >= 1, got {k}, {tile}")
    n, d = x.shape
    sid, order = torch.sort(ids.to(torch.int32), stable=True)
    bounds = torch.searchsorted(
        sid, torch.arange(k + 1, dtype=torch.int32, device=x.device))
    parts = 2 if tier == "bf16x3" else 1
    tiles = -(-n // tile)
    out = torch.empty((parts, k, d), dtype=torch.float64, device=x.device)
    head = torch.empty((max(tiles, 1), parts, d), dtype=torch.float64,
                       device=x.device)
    tail = torch.empty_like(head)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.atk_tier_sums64(
            x.data_ptr(), n, d, x.stride(0), sid.data_ptr(),
            order.data_ptr(), tile, bounds.data_ptr(), k, TIERS.index(tier),
            head.data_ptr(), tail.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "tier_sums64")
    tier_sums64.launches += 1
    return out


def tier_sums64(x: torch.Tensor, ids: torch.Tensor, k: int,
                tier: str = "highest",
                block: int = SEGMENT_BLOCK) -> torch.Tensor:
    """(parts, K, d) f64 sums of the rows of each cluster as the tier's
    one-hot product sees them: x; bf16(x); or hi(x) and lo(x) apart
    (bf16x3).  The kernel for CUDA tensors (``block`` sorted positions a
    tile), the plain version for CPU tensors (``block`` rows a block of
    running sums)."""
    check_tier(tier)
    if x.device.type == "cuda":
        return _tier_sums64_cuda(x, ids, k, tier, block)
    return tier_sums64_plain(x, ids, k, tier, block)


tier_sums64.launches = 0
