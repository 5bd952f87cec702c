"""Bidirectional LSTM token classifier (counterpart of
``audio_tokens_tpu/models/lstm.py``): embedding -> biLSTM layers -> concat
last forward/backward hidden -> ReLU -> dropout -> linear.  Built with a
``frame_dim`` (the ``use_precomputed_embeddings`` path), it takes float
frames (B, T, frame_dim) straight into layer 0, whose ``w_ih`` then has
``frame_dim`` rows, and has no embedding table: the JAX layer sizes ``w_ih``
by its input's width and creates no table for float inputs.

Parameters keep the JAX layouts where they meet the kernel, so a JAX
checkpoint transplants as a copy (``convert.py``): per direction ``w_ih``
(E, 4H), ``w_hh`` (H, 4H) and one ``bias`` (4H,), gate order i, f, g, o.
The input-gate product ``x @ w_ih + bias`` is one large matmul outside the
recurrence (the JAX package leaves it to XLA as well); the recurrence is
kernels B3 forward and B4 backward (``ops/cuda_lstm.py::lstm_sequence``).
Built with ``use_kernels=False`` (a serving program without kernels), the
recurrence is the plain step as one scan (``lstm_sequence_scan``), which
``torch.export`` keeps as one loop.

Dropout draws its keep-mask from a ``torch.Generator`` the caller passes
(the trainer derives one per step from its seed, as the JAX trainer folds
the step into its dropout key); training with dropout and no generator
raises rather than touch a global random stream.

Variable lengths are masked carries, not packing: past a sequence's end the
state passes through, so the final forward carry is the state at len-1 and
the backward direction ignores the padding it starts in.  With
``lengths=None`` the mask is all ones (the reference's behavior).

``remat_chunk > 0`` (``lstm_remat_chunk``, JAX ``LSTMLayer._remat_scan``)
recomputes the recurrence in time chunks of that size where a gradient is
taken: each chunk, its input-gate product included, runs under
``torch.utils.checkpoint``, so the backward keeps only the layer's input and
the (h, c) carries at chunk edges, and recomputes a chunk's forward (B3
from the carries) just before its B4.  The reverse direction walks the
chunks from the end; the last chunk is short.  The same arithmetic a step,
so the same numbers up to the chunked input-gate product's summation.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence,
                                                 lstm_sequence_carry,
                                                 lstm_sequence_scan)


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class LSTMLayer(nn.Module):
    """One direction of one layer: (B, T, E), mask (B, T) -> (hs (B, T, H),
    h_last (B, H))."""

    def __init__(self, input_dim: int, hidden_dim: int, reverse: bool,
                 generator: torch.Generator, use_kernels: bool = True,
                 remat_chunk: int = 0):
        super().__init__()
        self.reverse = reverse
        self.use_kernels = use_kernels
        self.remat_chunk = remat_chunk
        # torch nn.LSTM init: U(-1/sqrt(H), 1/sqrt(H)) for weights and bias
        bound = 1.0 / math.sqrt(hidden_dim)
        self.w_ih = nn.Parameter(
            _uniform((input_dim, 4 * hidden_dim), bound, generator))
        self.w_hh = nn.Parameter(
            _uniform((hidden_dim, 4 * hidden_dim), bound, generator))
        self.bias = nn.Parameter(_uniform((4 * hidden_dim,), bound, generator))

    def forward(self, x: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.remat_chunk > 0 and torch.is_grad_enabled():
            return self._remat(x, mask)
        xg = torch.matmul(x, self.w_ih) + self.bias  # (B, T, 4H)
        recurrence = lstm_sequence if self.use_kernels else lstm_sequence_scan
        hs, h_last = recurrence(
            xg.transpose(0, 1).contiguous(), mask.t().contiguous(),
            self.w_hh.contiguous(), self.reverse)
        return hs.transpose(0, 1), h_last

    def _chunk(self, x: torch.Tensor, mask: torch.Tensor,
               h0: Optional[torch.Tensor], c0: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One time chunk from its carries: x (B, s, E), mask (s, B) ->
        (hs (s, B, H), h_last, c_last)."""
        xg = torch.matmul(x, self.w_ih) + self.bias
        return lstm_sequence_carry(xg.transpose(0, 1).contiguous(), mask,
                                   self.w_hh.contiguous(), self.reverse, h0,
                                   c0)

    def _remat(self, x: torch.Tensor, mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = x.shape[1]
        s = min(self.remat_chunk, t)
        m = mask.t().contiguous()
        starts = range(0, t, s)
        h = c = None  # the first chunk starts from the zero state
        hs = {}
        for t0 in (reversed(starts) if self.reverse else starts):
            # the dropout generator is not drawn from here: no RNG state to
            # keep for the recompute
            hs[t0], h, c = checkpoint(
                self._chunk, x[:, t0:t0 + s], m[t0:t0 + s], h, c,
                use_reentrant=False, preserve_rng_state=False)
        return torch.cat([hs[t0] for t0 in starts]).transpose(0, 1), h


class SimpleLSTMTokenClassifier(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, hidden_dim: int,
                 num_layers: int, num_classes: int, dropout: float = 0.0,
                 frame_dim: Optional[int] = None, *, device: torch.device,
                 generator: torch.Generator, use_kernels: bool = True,
                 remat_chunk: int = 0):
        super().__init__()
        self.num_layers = num_layers
        if frame_dim is None:
            self.embedding = nn.Embedding(vocab_size, embed_dim)
            with torch.no_grad():
                self.embedding.weight.copy_(
                    torch.randn((vocab_size, embed_dim), generator=generator))
        else:
            self.embedding = None
            embed_dim = frame_dim
        for layer in range(num_layers):
            in_dim = embed_dim if layer == 0 else 2 * hidden_dim
            self.add_module(f"lstm_l{layer}_fwd", LSTMLayer(
                in_dim, hidden_dim, False, generator, use_kernels,
                remat_chunk))
            self.add_module(f"lstm_l{layer}_bwd", LSTMLayer(
                in_dim, hidden_dim, True, generator, use_kernels,
                remat_chunk))
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
        if x.is_floating_point():
            emb = x
        elif self.embedding is None:
            raise ValueError("this lstm takes float frames (B, T, frame_dim), "
                             f"got {x.dtype} input of shape {tuple(x.shape)}")
        else:
            emb = self.embedding(x.long())
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
