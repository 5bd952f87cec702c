"""Two-layer CNN over the 2-D spectrogram (counterpart of
``audio_tokens_tpu/models/cnn.py``): Conv3x3(32, SAME) -> ReLU -> MaxPool2 ->
Conv3x3(64, SAME) -> ReLU -> MaxPool2 -> flatten -> 256 -> num_classes.

Input (B, T, n_mels) becomes NCHW (B, 1, T, n_mels) for ``F.conv2d``
(cuDNN on the card).  SAME at 3x3, stride 1, pads one on each side;
pooling is VALID, so odd sizes floor, as flax's ``max_pool``.  Before the
flatten the activation is put in the JAX module's NHWC order, so the rows
of ``fc1`` run over (t, m, channel) with the channel fastest, as the rows of
the flax kernel do.

``compute_dtype`` casts activations and the conv/dense compute, as flax's
``Conv/Dense(dtype=...)``: input, weight and bias cast, the product rounded
to that dtype before the bias is added in it; ReLU and pooling run in it;
only the logits go back to float32.  Parameters stay float32: conv weights
(out, in, 3, 3), ``nn.Linear`` weights (out, in); ``convert.cnn_state_dict``
maps a flax tree onto them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audio_tokens_tpu_torch.models.transformer import _dense, _init_linear


def _init_conv(conv: nn.Conv2d, generator: torch.Generator) -> nn.Conv2d:
    """Normal weights of std 1/sqrt(fan_in), zero bias, as ``_init_linear``."""
    fan_in = conv.weight[0].numel()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator)
                          / math.sqrt(fan_in))
        conv.bias.zero_()
    return conv


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax ``Conv(dtype=dtype, padding="SAME")`` at 3x3, stride 1."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), padding=1)
    return y + conv.bias.to(dtype)[:, None, None]


class CNNClassifier(nn.Module):
    def __init__(self, max_seq_len: int, n_mels: int, num_classes: int,
                 compute_dtype: torch.dtype = torch.float32, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = _init_conv(nn.Conv2d(1, 32, 3), generator)
        self.conv2 = _init_conv(nn.Conv2d(32, 64, 3), generator)
        # two VALID 2x2 pools floor each size twice; 64 channels
        flat = (max_seq_len // 4) * (n_mels // 4) * 64
        self.fc1 = _init_linear(nn.Linear(flat, 256), generator)
        self.fc2 = _init_linear(nn.Linear(256, num_classes), generator)
        self.to(device)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T, n_mels) float -> (B, num_classes) float32 logits.
        ``lengths`` and ``generator`` are accepted for the trainer's call
        and unused, as in the JAX module."""
        cd = self.compute_dtype
        x = x[:, None]  # (B, 1, T, M)
        x = F.max_pool2d(torch.relu(_conv(x, self.conv1, cd)), 2)
        x = F.max_pool2d(torch.relu(_conv(x, self.conv2, cd)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = torch.relu(_dense(x, self.fc1, cd))
        return _dense(x, self.fc2, cd).float()
