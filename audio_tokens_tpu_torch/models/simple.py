"""Mean-pool token classifier (counterpart of
``audio_tokens_tpu/models/simple.py``): embedding -> temporal mean pool ->
linear head.

With ``lengths=None`` the mean runs over the whole padded length, so pad
token 0 contributes its real embedding (the reference's ``AdaptiveAvgPool1d``
over the padded sequence); with lengths it is the masked mean, its
denominator clamped at 1.

One formulation at every vocabulary: a gather (``nn.Embedding``) and a
(masked) mean.  The JAX module's count GEMM below 2,048 tokens is a TPU
workaround for serial scatter-adds and has no counterpart here; both of its
routes compute this function.  Parameters: ``embedding.weight`` (V, E) and
the ``nn.Linear`` head ``classifier``; ``convert.simple_state_dict`` maps a
flax tree onto them.  Everything runs in float32, as in the JAX module.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from audio_tokens_tpu_torch.models.transformer import _init_linear


class SimpleTokenClassifier(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int, num_classes: int,
                 *, device: torch.device, generator: torch.Generator):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, hidden_size)
        with torch.no_grad():  # flax Embed's default scale
            self.embedding.weight.copy_(torch.randn(
                (vocab_size, hidden_size), generator=generator)
                / math.sqrt(hidden_size))
        self.classifier = _init_linear(nn.Linear(hidden_size, num_classes),
                                       generator)
        self.to(device)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T) int token ids -> (B, num_classes) logits.  The model
        has no dropout; ``generator`` is accepted for the trainer's call."""
        emb = self.embedding(x.long())  # (B, T, E)
        if lengths is None:
            pooled = emb.mean(dim=1)
        else:
            lengths = lengths.to(emb.device)
            pos = torch.arange(x.shape[1], device=emb.device)[None, :]
            mask = (pos < lengths[:, None]).to(emb.dtype)
            denom = torch.clamp(lengths.to(emb.dtype), min=1.0)[:, None]
            pooled = (emb * mask[..., None]).sum(dim=1) / denom
        return self.classifier(pooled)
