"""Baseline MLP over the flattened spectrogram (counterpart of
``audio_tokens_tpu/models/mlp.py``): (B, T * n_mels) -> 512 -> 256 ->
num_classes, ReLU between.

``compute_dtype`` casts the activations and the dense compute, as flax's
``Dense(dtype=...)`` does: each layer's input, weight and bias are cast,
the product is rounded to that dtype before the bias is added in it.  The
parameters stay float32 and the logits come back in float32.  Parameters are
``nn.Linear`` weights (out, in); ``convert.mlp_state_dict`` maps a flax tree
onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audio_tokens_tpu_torch.models.transformer import _dense, _init_linear


class BaselineMLPClassifier(nn.Module):
    def __init__(self, input_dim: int, num_classes: int,
                 compute_dtype: torch.dtype = torch.float32, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc1 = _init_linear(nn.Linear(input_dim, 512), generator)
        self.fc2 = _init_linear(nn.Linear(512, 256), generator)
        self.fc3 = _init_linear(nn.Linear(256, num_classes), generator)
        self.to(device)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T * n_mels) float -> (B, num_classes) float32 logits.
        ``lengths`` and ``generator`` are accepted for the trainer's call
        and unused, as in the JAX module."""
        cd = self.compute_dtype
        x = torch.relu(_dense(x, self.fc1, cd))
        x = torch.relu(_dense(x, self.fc2, cd))
        return _dense(x, self.fc3, cd).float()
