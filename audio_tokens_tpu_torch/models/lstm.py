"""Bidirectional LSTM token classifier (counterpart of
``audio_tokens_tpu/models/lstm.py``): embedding -> biLSTM layers -> concat
last forward/backward hidden -> ReLU -> dropout -> linear.

Parameters keep the JAX layouts where they meet the kernel, so a JAX
checkpoint transplants as a copy (``convert.py``): per direction ``w_ih``
(E, 4H), ``w_hh`` (H, 4H) and one ``bias`` (4H,), gate order i, f, g, o.
The input-gate product ``x @ w_ih + bias`` is one large matmul outside the
recurrence (the JAX package leaves it to XLA as well); the recurrence is
kernels B3 forward and B4 backward (``ops/cuda_lstm.py::LSTMSequence``).

Dropout draws its keep-mask from a ``torch.Generator`` the caller passes
(the trainer derives one per step from its seed, as the JAX trainer folds
the step into its dropout key); training with dropout and no generator
raises rather than touch a global random stream.

Variable lengths are masked carries, not packing: past a sequence's end the
state passes through, so the final forward carry is the state at len-1 and
the backward direction ignores the padding it starts in.  With
``lengths=None`` the mask is all ones (the reference's behavior).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from audio_tokens_tpu_torch.ops.cuda_lstm import lstm_sequence


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class LSTMLayer(nn.Module):
    """One direction of one layer: (B, T, E), mask (B, T) -> (hs (B, T, H),
    h_last (B, H))."""

    def __init__(self, input_dim: int, hidden_dim: int, reverse: bool,
                 generator: torch.Generator):
        super().__init__()
        self.reverse = reverse
        # torch nn.LSTM init: U(-1/sqrt(H), 1/sqrt(H)) for weights and bias
        bound = 1.0 / math.sqrt(hidden_dim)
        self.w_ih = nn.Parameter(
            _uniform((input_dim, 4 * hidden_dim), bound, generator))
        self.w_hh = nn.Parameter(
            _uniform((hidden_dim, 4 * hidden_dim), bound, generator))
        self.bias = nn.Parameter(_uniform((4 * hidden_dim,), bound, generator))

    def forward(self, x: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        xg = torch.matmul(x, self.w_ih) + self.bias  # (B, T, 4H)
        hs, h_last = lstm_sequence(
            xg.transpose(0, 1).contiguous(), mask.t().contiguous(),
            self.w_hh.contiguous(), self.reverse)
        return hs.transpose(0, 1), h_last


class SimpleLSTMTokenClassifier(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, hidden_dim: int,
                 num_layers: int, num_classes: int, dropout: float = 0.0,
                 *, device: torch.device, generator: torch.Generator):
        super().__init__()
        self.num_layers = num_layers
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        with torch.no_grad():
            self.embedding.weight.copy_(
                torch.randn((vocab_size, embed_dim), generator=generator))
        for layer in range(num_layers):
            in_dim = embed_dim if layer == 0 else 2 * hidden_dim
            self.add_module(f"lstm_l{layer}_fwd",
                            LSTMLayer(in_dim, hidden_dim, False, generator))
            self.add_module(f"lstm_l{layer}_bwd",
                            LSTMLayer(in_dim, hidden_dim, True, generator))
        self.dropout = dropout
        self.fc = nn.Linear(2 * hidden_dim, num_classes)
        bound = 1.0 / math.sqrt(2 * hidden_dim)
        with torch.no_grad():
            self.fc.weight.copy_(
                _uniform(self.fc.weight.shape, bound, generator))
            self.fc.bias.copy_(_uniform(self.fc.bias.shape, bound, generator))
        self.to(device)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T) int token ids, or (B, T, E) float frames (the
        ``use_precomputed_embeddings`` path) -> (B, num_classes) logits.
        ``generator`` (on x's device) draws the dropout mask in training
        mode."""
        emb = x if x.is_floating_point() else self.embedding(x.long())
        b, t = emb.shape[:2]
        if lengths is None:
            mask = torch.ones((b, t), dtype=emb.dtype, device=emb.device)
        else:
            pos = torch.arange(t, device=emb.device)[None, :]
            mask = (pos < lengths.to(emb.device)[:, None]).to(emb.dtype)
        inp = emb
        h_fwd = h_bwd = None
        for layer in range(self.num_layers):
            fwd_hs, h_fwd = getattr(self, f"lstm_l{layer}_fwd")(inp, mask)
            bwd_hs, h_bwd = getattr(self, f"lstm_l{layer}_bwd")(inp, mask)
            inp = torch.cat([fwd_hs, bwd_hs], dim=-1)
        last = torch.relu(torch.cat([h_fwd, h_bwd], dim=-1))
        if self.training and self.dropout > 0.0:
            if generator is None:
                raise ValueError("dropout in training mode needs a generator")
            keep = torch.rand(last.shape, generator=generator,
                              device=last.device) >= self.dropout
            last = torch.where(keep, last / (1.0 - self.dropout),
                               torch.zeros_like(last))
        return self.fc(last)
