"""BERT-style transformer encoder classifier (counterpart of
``audio_tokens_tpu/models/transformer.py``): token (or frame) + learned
position embeddings with LayerNorm, post-LN encoder blocks (self-attention
-> Add&LN -> exact-erf GELU MLP x4 -> Add&LN), heads of 64, LayerNorm eps
1e-12, and a linear head on position 0 (no [CLS] token is inserted).

Attention has two routes over the same parameters (``query``, ``key``,
``value``, ``out``, as in flax ``MultiHeadDotProductAttention``):

  * ``"xla"``, the plain route: q prescaled by 1/sqrt(dh), matmul scores,
    keys past each row's length set to the dtype's finite minimum, softmax,
    dropout on the weights (one keep-mask shared by batch and heads, as
    flax's ``broadcast_dropout``), matmul with v;
  * ``"flash"``: lengths become segment ids (0 below ``min(len, T)``, else
    1) and the score/softmax/value contraction is kernel B5
    (``ops/cuda_attention.flash_attention``); the (B, nh, T, T) scores never
    reach device memory.  As in the JAX model it runs only when the model is
    deterministic (eval mode: serving, validation): a training step takes
    the plain route, which has the attention-weight dropout.

Dtypes follow the JAX module with explicit casts: the attention and MLP
dense layers cast their input and weights to ``compute_dtype``; LayerNorms,
the embeddings, ``frame_proj`` and the classifier run in float32.
Parameters are ``nn.Linear`` weights (out, in); ``convert.bert_state_dict``
maps a flax tree onto them.  Dropout draws from a ``torch.Generator`` the
caller passes, as in ``models/lstm.py``.

``remat=True`` (``transformer_remat``, JAX ``nn.remat`` of each block)
runs each encoder block under the recompute seam ``models/members.remat``
where a gradient is taken: the backward keeps the blocks' (B, T, H) inputs
and recomputes each block, its (B, nh, T, T) attention weights included.
The block's dropout draws from the caller's generator, so the seam puts
that generator's state back before its recompute and forward again after
it: the recomputed keep-masks are the forward's, and the gradients those
of the run without remat.  Dropout draws go through ``members.uniform``,
and the seam runs under an ensemble's member axis too (one recompute a
member, from the member's generator).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from audio_tokens_tpu_torch.models.members import remat, uniform
from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention

LN_EPS = 1e-12  # HF BertConfig layer_norm_eps, as the JAX module
HEAD_DIM = 64   # heads = hidden // 64, as the JAX module


def _init_linear(lin: nn.Linear, generator: torch.Generator) -> nn.Linear:
    """Normal weights of std 1/sqrt(fan_in) (flax's lecun-normal scale),
    zero bias."""
    with torch.no_grad():
        lin.weight.copy_(torch.randn(lin.weight.shape, generator=generator)
                         / math.sqrt(lin.in_features))
        lin.bias.zero_()
    return lin


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to dtype."""
    return (torch.matmul(x.to(dtype), lin.weight.to(dtype).t())
            + lin.bias.to(dtype))


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
             shape=None) -> torch.Tensor:
    """Inverted dropout with a keep-mask of ``shape`` (default x's) drawn
    from ``generator``."""
    keep = uniform(shape or x.shape, generator, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class SelfAttention(nn.Module):
    """Self-attention with flax MHDPA's parameters.  ``forward`` is the
    plain (``"xla"``) route, ``flash`` the B5 route."""

    def __init__(self, hidden_size: int, num_heads: int,
                 compute_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.compute_dtype = compute_dtype
        for name in ("query", "key", "value", "out"):
            self.add_module(name, _init_linear(
                nn.Linear(hidden_size, hidden_size), generator))

    def _heads(self, x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        """(B, T, H) -> (B, T, nh, dh) projection in compute_dtype."""
        b, t, _ = x.shape
        return _dense(x, lin, self.compute_dtype).view(
            b, t, self.num_heads, self.head_dim)

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        b, t = o.shape[:2]
        return _dense(o.reshape(b, t, -1), self.out, self.compute_dtype)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, H); key_mask (B, T) bool or None (attend everywhere).
        ``dropout`` > 0 drops attention weights, drawn from ``generator``."""
        dt = self.compute_dtype
        q = self._heads(x, self.query) / math.sqrt(self.head_dim)
        k, v = self._heads(x, self.key), self._heads(x, self.value)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if key_mask is not None:
            w = w.masked_fill(~key_mask[:, None, None, :],
                              torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1)
        if dropout > 0.0:
            t = x.shape[1]
            w = _dropout(w, dropout, generator, (1, 1, t, t))
        return self._out(torch.einsum("bhqk,bkhd->bqhd", w, v))

    def flash(self, x: torch.Tensor, lengths: Optional[torch.Tensor]
              ) -> torch.Tensor:
        """The B5 route: x (B, T, H), lengths (B,) or None."""
        b, t, _ = x.shape
        q, k, v = (self._heads(x, lin).transpose(1, 2).contiguous()
                   for lin in (self.query, self.key, self.value))
        pos = torch.arange(t, device=x.device)[None, :]
        if lengths is None:
            seg = torch.zeros((b, t), dtype=torch.int32, device=x.device)
        else:
            valid = pos < torch.clamp(lengths.to(x.device), max=t)[:, None]
            seg = torch.where(valid, 0, 1).to(torch.int32)
        o = flash_attention(q, k, v, seg, 1.0 / math.sqrt(self.head_dim))
        return self._out(o.transpose(1, 2))


class FlashSelfAttention(SelfAttention):
    """``SelfAttention`` whose forward is the B5 route: (x, lengths) -> out.
    The counterpart of the JAX ``FlashSelfAttention`` module."""

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.flash(x, lengths)


class EncoderBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, dropout: float,
                 compute_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.attention = SelfAttention(hidden_size, num_heads, compute_dtype,
                                       generator)
        self.attn_ln = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.mlp_in = _init_linear(nn.Linear(hidden_size, 4 * hidden_size),
                                   generator)
        self.mlp_out = _init_linear(nn.Linear(4 * hidden_size, hidden_size),
                                    generator)
        self.mlp_ln = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor],
                key_mask: Optional[torch.Tensor], flash: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        if flash:
            attn = self.attention.flash(x, lengths)
        else:
            attn = self.attention(x, key_mask, rate, generator)
        x = self.attn_ln(x + attn.float())
        h = F.gelu(_dense(x, self.mlp_in, self.compute_dtype))  # exact erf
        h = _dense(h, self.mlp_out, self.compute_dtype)
        if rate > 0.0:
            h = _dropout(h, rate, generator)
        return self.mlp_ln(x + h.float())


def _remat_block(block: EncoderBlock, x: torch.Tensor,
                 lengths: Optional[torch.Tensor],
                 key_mask: Optional[torch.Tensor], flash: bool,
                 generator) -> torch.Tensor:
    """``block`` under the recompute seam, its parameters passed in (a
    member's, under the member axis); the recompute replays ``generator``
    from the state the forward started at."""
    names, params = zip(*block.named_parameters())

    def run(gen, h, lengths, key_mask, *ps):
        return functional_call(block, dict(zip(names, ps)),
                               (h, lengths, key_mask, flash, gen))

    return remat(run, x, lengths, key_mask, *params, generator=generator)


class TransformerClassifier(nn.Module):
    """``attention_impl`` is ``"xla"`` or ``"flash"`` (flash in eval mode
    only).  ``frame_dim`` set: the model takes float frames (B, T,
    frame_dim) through ``frame_proj``; else int token ids through
    ``tok_embed``.  ``remat``: recompute each block in the backward."""

    def __init__(self, vocab_size: int, num_layers: int, num_classes: int,
                 hidden_size: int = 768, max_position: int = 512,
                 dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32,
                 attention_impl: str = "xla",
                 frame_dim: Optional[int] = None, remat: bool = False, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.remat = remat
        if attention_impl not in ("xla", "flash"):
            raise ValueError(f"attention_impl must be 'xla' or 'flash', got "
                             f"'{attention_impl}'")
        self.num_layers = num_layers
        self.max_position = max_position
        self.dropout = dropout
        self.attention_impl = attention_impl
        num_heads = max(1, hidden_size // HEAD_DIM)
        std = 1.0 / math.sqrt(hidden_size)  # flax Embed's default scale
        if frame_dim is None:
            self.tok_embed = nn.Embedding(vocab_size, hidden_size)
            with torch.no_grad():
                self.tok_embed.weight.copy_(torch.randn(
                    (vocab_size, hidden_size), generator=generator) * std)
        else:
            self.frame_proj = _init_linear(nn.Linear(frame_dim, hidden_size),
                                           generator)
        self.pos_embed = nn.Embedding(max_position, hidden_size)
        with torch.no_grad():
            self.pos_embed.weight.copy_(torch.randn(
                (max_position, hidden_size), generator=generator) * std)
        self.embed_ln = nn.LayerNorm(hidden_size, eps=LN_EPS)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderBlock(
                hidden_size, num_heads, dropout, compute_dtype, generator))
        self.classifier = _init_linear(nn.Linear(hidden_size, num_classes),
                                       generator)
        self.to(device)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T) int token ids, or (B, T, frame_dim) float frames ->
        (B, num_classes) logits, from the first ``max_position`` positions.
        ``lengths`` (B,) masks keys past each row's length (None: attend
        everywhere, the reference's all-ones masks).  ``generator`` (on x's
        device) draws the dropout masks in training mode."""
        x = x[:, : self.max_position]
        if x.is_floating_point():
            h = self.frame_proj(x.float())
        else:
            h = self.tok_embed(x.long())
        b, t = h.shape[:2]
        h = self.embed_ln(h + self.pos_embed.weight[:t][None])
        deterministic = not self.training
        rate = 0.0 if deterministic else self.dropout
        if rate > 0.0 and generator is None:
            raise ValueError("dropout in training mode needs a generator")
        if rate > 0.0:
            h = _dropout(h, rate, generator)
        key_mask = None
        if lengths is not None:
            lengths = lengths.to(h.device)
            key_mask = (torch.arange(t, device=h.device)[None, :]
                        < torch.clamp(lengths, max=t)[:, None])
        flash = self.attention_impl == "flash" and deterministic
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.num_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                h = _remat_block(block, h, lengths, key_mask, flash,
                                 generator)
            else:
                h = block(h, lengths, key_mask, flash, generator)
        return self.classifier(h[:, 0, :])
