"""Vector-quantization primitives: L2 normalize, 1-NN assign.

Counterpart of ``audio_tokens_tpu/ops/vq.py``:

    ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2

The ``||x||^2`` term is constant across centroids, so the argmin drops it.
Ties break toward the lowest centroid index (``torch.argmin`` returns the
first minimum), matching FAISS flat search.  Rows are scored in chunks so
the (N, K) distance matrix never exists in memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from audio_tokens_tpu_torch.ops.cuda_vq import (
    CHUNK,
    l2_normalize,
    vq_argmin,
    vq_argmin_plain,
)

__all__ = ["check_near_ties", "l2_normalize", "vq_assign", "vq_assign_fused"]


def vq_assign(x: torch.Tensor, centroids: torch.Tensor,
              chunk: Optional[int] = CHUNK) -> torch.Tensor:
    """Nearest-centroid id (int32) for every row of x, in plain PyTorch,
    ``chunk`` rows at a time (``None``: all at once)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    centroids = torch.as_tensor(centroids, dtype=torch.float32,
                                device=x.device)
    return vq_argmin_plain(x, centroids, normalize=False,
                           chunk=chunk or max(x.shape[0], 1))


NEAR_TIE_FRACTION = 1e-3  # at most 0.1% of rows may disagree ...
NEAR_TIE_GAP = 1e-4  # ... each by less than this float64 score gap


def check_near_ties(features: torch.Tensor, centroids: torch.Tensor,
                    ids_a: torch.Tensor, ids_b: torch.Tensor
                    ) -> Tuple[float, float]:
    """Hold two nearest-centroid assignments of the same unit features to
    each other up to near-ties: at most ``NEAR_TIE_FRACTION`` of the rows
    may disagree, and at each disagreeing row the float64 scores
    ``||c||^2 - 2 f.c`` of the two chosen centroids must differ by less
    than ``NEAR_TIE_GAP``.  Different summation orders may flip such rows
    and nothing else.  Returns (fraction disagreeing, largest gap); raises
    AssertionError past either bound."""
    a = ids_a.reshape(-1).long().cpu()
    b = ids_b.reshape(-1).long().cpu()
    rows = (a != b).nonzero().flatten()
    if rows.numel() == 0:
        return 0.0, 0.0
    f = features.reshape(a.numel(), -1)[rows.to(features.device)]
    f = f.double().cpu()
    c = centroids.double().cpu()

    def score(idx):
        return (c[idx] * c[idx]).sum(1) - 2.0 * (f * c[idx]).sum(1)

    frac = rows.numel() / a.numel()
    gap = float((score(a[rows]) - score(b[rows])).abs().max())
    if frac > NEAR_TIE_FRACTION or gap >= NEAR_TIE_GAP:
        raise AssertionError(
            f"{rows.numel()} of {a.numel()} ids disagree ({frac:.2e}); "
            f"largest score gap {gap:.3e} (near-tie bounds: "
            f"{NEAR_TIE_FRACTION}, {NEAR_TIE_GAP})")
    return frac, gap


def vq_assign_fused(frames: torch.Tensor, centroids: torch.Tensor,
                    normalize: bool = True) -> torch.Tensor:
    """Fused normalize + distance + argmin on one device: kernel B2 for CUDA
    tensors, its plain version for CPU tensors (the wrapper decides by the
    tensor's device, never by what is installed)."""
    return vq_argmin(frames.to(torch.float32).contiguous(),
                     centroids.to(torch.float32).contiguous(), normalize)
