"""The matmul precision tiers of kernels B1 and B2 and of the Lloyd loop,
in plain PyTorch.

Counterpart of ``audio_tokens_tpu/ops/pallas_tokenizer.py::_dot_tier`` (the
megakernel's DFT, mel and centroid-distance products) and of the TPU's
``Precision.HIGH`` / ``DEFAULT`` on float32 operands (the Lloyd loop's
``kmeans_precision``):

* ``highest``: float32 operands, float32 products;
* ``bf16x3``: each operand split into ``hi = bf16(x)`` and ``lo = bf16(x -
  hi)``, the product taken as ``hi.hi + (hi.lo + lo.hi)`` (``lo.lo``
  dropped), each pass accumulated in float32.  This is also what the TPU
  computes for ``Precision.HIGH`` (the K-means tier ``high``);
* ``default``: both operands rounded to bf16 once, one pass accumulated in
  float32.  On a TPU that is ``Precision.DEFAULT`` on float32 operands;
  XLA's CPU backend computes DEFAULT in float32, so the JAX package on the
  CPU does not show it.

A product of two bf16 values is exact in float32 (8 + 8 significant bits),
so a float32 matmul of bf16-rounded operands is the tier's arithmetic: bf16
operands with float32 accumulation, the sums in another order than the
kernels' ``mma.sync`` passes.  TF32 must be off (``ops.common.exact_f32``):
TF32 keeps 10 mantissa bits where the tiers are defined on bf16's 7, so a
tier run in TF32 is another function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

TIERS = ("highest", "bf16x3", "default")
# bf16 round-to-nearest unit roundoff, and the bf16x3 split's: a product's
# relative error is about twice it (both operands rounded)
UNIT_ROUNDOFF = {"highest": 0.0, "bf16x3": 2.0 ** -16, "default": 2.0 ** -8}


def check_tier(tier: str, what: str = "precision tier") -> str:
    if tier not in TIERS:
        raise ValueError(f"unknown {what} '{tier}' (use {'|'.join(TIERS)})")
    return tier


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (bf16(x), bf16(x - hi)) as float32 tensors."""
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def tier_operands(x: torch.Tensor, tier: str) -> Tuple[torch.Tensor, ...]:
    """The operand parts the tier multiplies: (x,), (hi, lo) or (bf16(x),)."""
    if tier == "bf16x3":
        return split_bf16(x)
    if tier == "default":
        return (round_bf16(x),)
    return (x,)


def tier_product(a_parts: Tuple[torch.Tensor, ...],
                 b_parts: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """a @ b from ``tier_operands`` of each side (split once, used often)."""
    if len(a_parts) == 2:
        (ah, al), (bh, bl) = a_parts, b_parts
        return ah @ bh + (ah @ bl + al @ bh)
    return a_parts[0] @ b_parts[0]


def tier_matmul(a: torch.Tensor, b: torch.Tensor, tier: str) -> torch.Tensor:
    """a @ b at the tier (float32 result)."""
    check_tier(tier)
    return tier_product(tier_operands(a, tier), tier_operands(b, tier))


# rows that may disagree between two computations of one tier (another
# summation order of the same rounded products): 1e-4 of them, and one row at
# any size.  The sound readings on the card are 9.1e-6 of B1's tokens and
# 4.6e-7 of B2's ids (PERF.md section 6); a kernel that computed another
# tier (float32 for default: ~1% of the rows) lies far above it.
TIE_FRACTION = 1e-4
# the share of rows a tier's answer may take away from the highest answer:
# the JAX package's agreement floors (tests/test_pallas_tokenizer.py) above,
# and for default a floor below, from the card's readings (0.40% of B2's
# Lloyd ids, 0.89-1.13% of B1's tokens): a kernel that ignored the tier and
# computed in float32 would sit at the f32 kernel's own near-ties (~1e-6)
HIGHEST_APART = {"bf16x3": (0.0, 1e-3), "default": (1e-3, 2e-2)}


def check_tier_ties(features: torch.Tensor, centroids: torch.Tensor,
                    ids_a: torch.Tensor, ids_b: torch.Tensor, tier: str
                    ) -> Tuple[float, float, float]:
    """Hold two nearest-centroid assignments of the same features, made at
    ``tier``, to each other up to the tier's near-ties: at most
    ``TIE_FRACTION`` of the rows (and at least one row) may disagree, and
    at each disagreeing row the float64 scores ``||c||^2 - 2 f.c`` of the
    two chosen centroids must differ by less than ``2 u sum_i |f_i| (|a_i|
    + |b_i|)``, u the tier's unit roundoff (2^-8 for ``default``, 2^-16 for
    ``bf16x3``; the ``highest`` tier takes ``ops.vq.check_near_ties``'
    fixed 1e-4).  Returns (fraction disagreeing, largest gap, largest gap /
    its bound); raises AssertionError past either bound."""
    a = ids_a.reshape(-1).long().cpu()
    b = ids_b.reshape(-1).long().cpu()
    rows = (a != b).nonzero().flatten()
    if rows.numel() == 0:
        return 0.0, 0.0, 0.0
    f = features.reshape(a.numel(), -1)[rows.to(features.device)]
    f = f.double().cpu()
    c = centroids.double().cpu()
    ca, cb = c[a[rows]], c[b[rows]]
    gap = ((ca * ca).sum(1) - 2.0 * (f * ca).sum(1)
           - (cb * cb).sum(1) + 2.0 * (f * cb).sum(1)).abs()
    u = UNIT_ROUNDOFF[check_tier(tier)]
    bound = (2.0 * u * (f.abs() * (ca.abs() + cb.abs())).sum(1)
             if u else torch.full_like(gap, 1e-4))
    frac = rows.numel() / a.numel()
    worst = float((gap / bound).max())
    if rows.numel() > max(1.0, TIE_FRACTION * a.numel()) or worst >= 1.0:
        raise AssertionError(
            f"{rows.numel()} of {a.numel()} ids disagree ({frac:.2e}) at "
            f"tier {tier}; largest score gap {worst:.3f} of its bound "
            f"(bounds: fraction {TIE_FRACTION} or one row, gap 1.0)")
    return frac, float(gap.max()), worst


def check_follows_tier(ids: torch.Tensor, plain: torch.Tensor,
                       highest: torch.Tensor, tier: str, min_rows: int = 50,
                       band: bool = True) -> Tuple[float, Optional[float]]:
    """Hold a kernel's ids at ``tier`` to that tier and not to float32:
    on the rows where the plain tier version leaves the ``highest`` answer,
    more than half must take the plain tier's answer (a float32 kernel
    keeps the highest answer on nearly all of them), where there are
    ``min_rows`` such rows.  With ``band`` (features of audio, where the
    band was read) their share apart from the highest answer must also lie
    in ``HIGHEST_APART[tier]``.  Returns (share apart from highest, share
    of those rows followed or None)."""
    ids, plain, highest = (t.reshape(-1).cpu() for t in (ids, plain, highest))
    apart = float((ids != highest).float().mean())
    lo, hi = HIGHEST_APART[check_tier(tier)]
    if band and not lo <= apart < hi:
        raise AssertionError(
            f"{apart:.3e} of the ids apart from highest at tier {tier}, "
            f"outside [{lo}, {hi})")
    moved = plain != highest
    n = int(moved.sum())
    if n < min_rows:
        return apart, None
    followed = float((ids[moved] == plain[moved]).float().mean())
    if followed <= 0.5:
        raise AssertionError(
            f"tier {tier}: the ids take the plain tier's answer on "
            f"{followed:.3f} of the {n} rows where it leaves highest")
    return apart, followed
