"""Training objective (counterpart of ``audio_tokens_tpu/train/objective.py``).

The multi-label BCE loss (reference: processors/model_trainer.py:37,116 —
``BCEWithLogitsLoss`` over sigmoid logits) as a global weighted mean: padded
batch rows carry weight 0, so the loss exactly matches ragged-batch
semantics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def weighted_bce(logits: torch.Tensor, labels: torch.Tensor,
                 row_w: torch.Tensor) -> torch.Tensor:
    """(bce * row_w).sum() / max(row_w.sum() * C, 1) for logits and labels
    (B, C) and row weights (B,)."""
    bce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    denom = torch.clamp(row_w.sum() * labels.shape[1], min=1.0)
    return (bce * row_w[:, None]).sum() / denom
