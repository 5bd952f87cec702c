"""Training objective (counterpart of ``audio_tokens_tpu/train/objective.py``).

The multi-label BCE loss (reference: processors/model_trainer.py:37,116 —
``BCEWithLogitsLoss`` over sigmoid logits) as a global weighted mean: padded
batch rows carry weight 0, so the loss exactly matches ragged-batch
semantics.  Batches may arrive in the device corpus's storage format
(``train/device_epoch.py``): uint16 token ids, uint8 labels, bf16 feature
rows; they are cast on the device, as the JAX loss does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def model_inputs(inputs: torch.Tensor) -> torch.Tensor:
    """Token ids as int32 (uint16 storage widened by its bits, which needs
    no uint16 kernel), feature rows as float32; int32/int64 ids and f32 rows
    pass through."""
    if inputs.dtype == torch.uint16:
        return inputs.view(torch.int16).to(torch.int32) & 0xFFFF
    if inputs.is_floating_point() and inputs.dtype != torch.float32:
        return inputs.float()  # bf16 corpus rows: the model sees f32
    return inputs


def weighted_bce(logits: torch.Tensor, labels: torch.Tensor,
                 row_w: torch.Tensor, denom=None) -> torch.Tensor:
    """(bce * row_w).sum() / max(row_w.sum() * C, 1) for logits and labels
    (B, C) (labels of any dtype, 0/1) and row weights (B,).  A data-parallel
    rank passes the global batch's ``denom``: its loss is then its rows'
    share of the global mean."""
    if not labels.is_floating_point():
        labels = labels.float()  # uint8 corpus labels
    bce = F.binary_cross_entropy_with_logits(logits, labels,
                                             reduction="none")
    if denom is None:
        denom = torch.clamp(row_w.sum() * labels.shape[1], min=1.0)
    return (bce * row_w[:, None]).sum() / denom
