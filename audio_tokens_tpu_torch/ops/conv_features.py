"""Random-weight Conv1d feature expansion of frame vectors.

Counterpart of ``audio_tokens_tpu/ops/conv_features.py::ConvFeatures``: the
reference's optional, untrained ``nn.Conv1d(1, num_kernels, kernel_size,
padding=kernel_size // 2)`` that widens each (n_mels,) frame to
(n_mels * num_kernels,) before clustering and tokenizing (reference:
processors/cluster_creator.py:28-34,68-81 and
processors/spec_tokenizer.py:92-104,115-121).  The output is mel-major,
``[m0k0, m0k1, ..., m0k{K-1}, m1k0, ...]``, the reference's reshape.

The weights come from ``utils/seeding.generator_for(seed,
"conv_features")``, one stream shared by the clustering and tokenize stages,
with torch Conv1d's distribution U(-1/sqrt(kernel_size), +1/sqrt(kernel_size))
for weight and bias; the JAX package draws the same distribution from
``jax.random``, whose bits torch cannot reproduce.  ``state_dict`` /
``load_state_dict`` use the ``.conv.npz`` layout the JAX package saves beside
the centroids (``weight`` (K, 1, w), ``bias`` (K,)), so an artifacts
directory of either package loads in the other.

The JAX package computes this product outside any Pallas kernel
(``jax.lax.conv_general_dilated`` at HIGHEST); here it is ``F.conv1d`` with
TF32 off (cuDNN would take TF32 by default).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_tokens_tpu_torch.utils.seeding import generator_for

CONV_STAGE_NAME = "conv_features"  # shared by the cluster and tokenize stages


class ConvFeatures(nn.Module):
    def __init__(self, num_kernels: int, kernel_size: int, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(
                "kernel_size must be odd (reference assumes 'same' length)")
        self.num_kernels = num_kernels
        self.kernel_size = kernel_size
        bound = 1.0 / np.sqrt(kernel_size)
        gen = generator_for(seed, CONV_STAGE_NAME)

        def uniform(*shape):
            return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound

        self.register_buffer("weight", uniform(num_kernels, 1, kernel_size).to(
            device))
        self.register_buffer("bias", uniform(num_kernels).to(device))

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, n_mels) -> (N, n_mels * num_kernels), mel-major."""
        x = frames.to(torch.float32)[:, None, :]
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            out = F.conv1d(x, self.weight, self.bias,
                           padding=self.kernel_size // 2)  # (N, K, n_mels)
        n, k, m = out.shape
        return out.transpose(1, 2).reshape(n, m * k)

    def load_state_dict(self, state, strict: bool = True, assign: bool = False):
        """Tensors or the ``.conv.npz`` numpy arrays (``dict(np.load(p))``)."""
        state = {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v) for k, v in state.items()}
        return super().load_state_dict(state, strict=strict, assign=assign)

    def save_npz(self, path) -> None:
        """The ``.conv.npz`` artifact (the JAX package's layout)."""
        np.savez(path, **{k: v.detach().cpu().numpy()
                          for k, v in self.state_dict().items()})
