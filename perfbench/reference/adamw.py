"""AdamW with decoupled weight decay, one step over a dict of leaves:
``p -= lr wd p``; ``m = b1 m + (1 - b1) g``; ``v = b2 v + (1 - b2) g^2``;
``p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``."""

from __future__ import annotations

from typing import Dict

import torch


def step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         state: Dict[str, list], t: int, lr: float, betas=(0.9, 0.999),
         eps: float = 1e-8, weight_decay: float = 0.01
         ) -> Dict[str, torch.Tensor]:
    """The leaves after step ``t`` (1-based); ``state`` holds each leaf's
    [m, v] and is updated in place."""
    b1, b2 = betas
    out = {}
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, [torch.zeros_like(p),
                                       torch.zeros_like(p)])
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v / (1 - b2 ** t)).sqrt() + eps
        out[name] = (p * (1 - lr * weight_decay)
                     - lr * (m / (1 - b1 ** t)) / denom)
    return out

