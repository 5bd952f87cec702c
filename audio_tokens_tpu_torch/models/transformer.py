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

Tensor and sequence parallelism (``shard_(mesh)``, a mesh of
``parallel/mesh.make_mesh``, one process a card), with the JAX module's
semantics (``TP_RULES`` and the ``(data, sequence, None)`` constraint at
the embedding and after every block): the result is one process's.

  * Tensor parallelism is Megatron's split.  A model rank holds num_heads /
    tp heads of query, key, value and out and 4 hidden / tp columns of
    mlp_in and mlp_out (``TP_RULES``).  ``_CopyToModel`` (identity forward,
    all-reduce backward) sits at the input of the attention's and the
    MLP's column-parallel layers, ``_ReduceFromModel`` (all-reduce forward,
    identity backward) after out and mlp_out, before their whole biases:
    two all-reduces a block forward and two backward, none elsewhere.  B5
    runs as it is on the local heads.  The attention-weight dropout mask is
    (1, 1, T, T), the same on every model rank.
  * Sequence parallelism: a sequence rank holds rows [s T / sp, (s + 1) T /
    sp) of (B, T, H) (the caller passes the whole window; the model takes
    its rows, and their positions' embeddings).  LayerNorm, the MLP and
    dropout are local, dropout drawing the whole window's mask and keeping
    its rows, so that the generators stay in step and dropout > 0 equals
    one process.  Attention projects its rows' q, k and v, gathers k and v
    over the sequence ranks (``_GatherSequence``: its backward is an
    all-reduce and a slice), masks keys by global position and runs its
    query rows against every key: on the plain route, or on B5 with
    ``kv_segment_ids`` (eval mode; its backward gives the rank's dq and
    its share of dk and dv, which the gather's backward sums).
    Position 0 lives on sequence rank 0; ``_FromFirst`` gives its row to
    every sequence rank.
  * Gradient accounting.  Each sequence rank computes the same loss and
    passes back 1 / sp of its logits' gradient (``_ShareOfGrad``); the
    adjoints of the gather and of ``_FromFirst`` sum over the ranks.  So
    every parameter's gradient on a rank is its share, and the sum over
    the ranks of one model place (the mesh's ``replica`` group, data x
    sequence) is one process's gradient: the trainer sums there once,
    fused with the data all-reduce.  Nothing is summed over ``model``:
    replicated weights carry equal gradients on the model ranks, and
    split ones are each rank's own.

``full_state_dict`` joins the model ranks' slices into one process's
layout (checkpoints), ``load_full_state_dict`` takes this rank's slices of
one.
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
from audio_tokens_tpu_torch.parallel.mesh import (DataGroup, Mesh, tp_gather,
                                                  tp_param_specs,
                                                  tp_shardings)

LN_EPS = 1e-12  # HF BertConfig layer_norm_eps, as the JAX module
HEAD_DIM = 64   # heads = hidden // 64, as the JAX module

# Tensor-parallel rules: parameter-name substring -> the dimension split
# over the mesh's ``model`` axis (``parallel/mesh.tp_param_specs``); the JAX
# ``TP_RULES`` on ``nn.Linear``'s (out, in) weights.  Megatron's layout:
# column-parallel query/key/value (whole heads, rows h dh .. (h + 1) dh of
# head h) and mlp_in, their biases with them; row-parallel out and mlp_out,
# whose biases stay whole and are added once, after the all-reduce.
TP_RULES = (
    ("mlp_in.weight", 0),
    ("mlp_in.bias", 0),
    ("mlp_out.weight", 1),
    ("attention.query.weight", 0),
    ("attention.key.weight", 0),
    ("attention.value.weight", 0),
    ("attention.query.bias", 0),
    ("attention.key.bias", 0),
    ("attention.value.bias", 0),
    ("attention.out.weight", 1),
)


def _summed(group: DataGroup, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks, in f32 on the wire, out of
    place, in ``t``'s dtype."""
    s = t.to(torch.float32, copy=True)
    group.all_reduce_(s)
    return s.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the model ranks' gradients (each
    holds its own heads' or columns' share of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(ctx.group, g), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum of the model ranks' partial products; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(group, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSequence(torch.autograd.Function):
    """Every sequence rank's rows of ``x`` (B, T / sp, ...) joined along
    dim 1 in rank order; the backward sums the full gradient over the
    ranks and keeps this rank's rows (all-reduce and slice: gloo has no
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[1]
        return group.all_gather(x.contiguous(), dim=1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.group.rank * ctx.rows
        return _summed(ctx.group, g)[:, lo:lo + ctx.rows], None


class _FromFirst(torch.autograd.Function):
    """Sequence rank 0's ``x`` on every sequence rank (a broadcast, as a
    sum of rank 0's value and the others' zeros); the backward sums the
    ranks' gradients into rank 0's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(group, x if group.rank == 0 else torch.zeros_like(x))

    @staticmethod
    def backward(ctx, g):
        g = _summed(ctx.group, g)
        return (g if ctx.group.rank == 0 else torch.zeros_like(g)), None


class _ShareOfGrad(torch.autograd.Function):
    """Identity forward; the backward passes 1 / ``n`` of the gradient
    (each of the ``n`` sequence ranks computes the same loss)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


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
             shape=None, part=None) -> torch.Tensor:
    """Inverted dropout with a keep-mask of ``shape`` (default x's) drawn
    from ``generator``; ``part`` (an index) takes x's part of a larger
    mask, so that a sequence rank draws what one process draws."""
    keep = uniform(shape or x.shape, generator, x.device) < 1.0 - rate
    if part is not None:
        keep = keep[part]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _rows(mesh: Optional[Mesh], t_local: int):
    """(lo, hi) of this sequence rank's rows of the window, or None."""
    if mesh is None or mesh.sequence.size == 1:
        return None
    lo = mesh.sequence.rank * t_local
    return lo, lo + t_local


def _into_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x at the input of a column-parallel layer."""
    if mesh is None or mesh.model.size == 1:
        return x
    return _CopyToModel.apply(x, mesh.model)


def _row_dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype,
               mesh: Optional[Mesh]) -> torch.Tensor:
    """``_dense`` of a row-parallel layer: the model ranks' partial
    products summed, then the whole bias once."""
    if mesh is None or mesh.model.size == 1:
        return _dense(x, lin, dtype)
    y = torch.matmul(x.to(dtype), lin.weight.to(dtype).t())
    return _ReduceFromModel.apply(y, mesh.model) + lin.bias.to(dtype)


class SelfAttention(nn.Module):
    """Self-attention with flax MHDPA's parameters.  ``forward`` is the
    plain (``"xla"``) route, ``flash`` the B5 route."""

    def __init__(self, hidden_size: int, num_heads: int,
                 compute_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads  # this model rank's, under a mesh
        self.head_dim = hidden_size // num_heads
        self.compute_dtype = compute_dtype
        self.mesh: Optional[Mesh] = None
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
        return _row_dense(o.reshape(b, t, -1), self.out, self.compute_dtype,
                          self.mesh)

    def _qkv(self, x: torch.Tensor):
        """q, k, v (B, T, nh, dh); under sequence parallelism k and v of
        the whole window (every sequence rank's rows, gathered)."""
        x = _into_model(x, self.mesh)
        q, k, v = (self._heads(x, lin)
                   for lin in (self.query, self.key, self.value))
        if _rows(self.mesh, x.shape[1]) is not None:
            k = _GatherSequence.apply(k, self.mesh.sequence)
            v = _GatherSequence.apply(v, self.mesh.sequence)
        return q, k, v

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, H); key_mask (B, T) bool or None (attend everywhere).
        ``dropout`` > 0 drops attention weights, drawn from ``generator``.
        Under sequence parallelism x holds this rank's rows and key_mask
        the whole window's."""
        dt = self.compute_dtype
        q, k, v = self._qkv(x)
        q = q / math.sqrt(self.head_dim)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if key_mask is not None:
            w = w.masked_fill(~key_mask[:, None, None, :],
                              torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1)
        if dropout > 0.0:
            t = k.shape[1]
            rows = _rows(self.mesh, x.shape[1])
            w = _dropout(w, dropout, generator, (1, 1, t, t),
                         None if rows is None else
                         (slice(None), slice(None), slice(*rows)))
        return self._out(torch.einsum("bhqk,bkhd->bqhd", w, v))

    def flash(self, x: torch.Tensor, lengths: Optional[torch.Tensor]
              ) -> torch.Tensor:
        """The B5 route: x (B, T, H), lengths (B,) or None.  Under sequence
        parallelism B5 runs this rank's query rows against the whole
        window's keys."""
        q, k, v = (a.transpose(1, 2).contiguous() for a in self._qkv(x))
        b, t = k.shape[0], k.shape[2]
        pos = torch.arange(t, device=x.device)[None, :]
        if lengths is None:
            seg = torch.zeros((b, t), dtype=torch.int32, device=x.device)
        else:
            valid = pos < torch.clamp(lengths.to(x.device), max=t)[:, None]
            seg = torch.where(valid, 0, 1).to(torch.int32)
        scale = 1.0 / math.sqrt(self.head_dim)
        rows = _rows(self.mesh, x.shape[1])
        if rows is None:
            o = flash_attention(q, k, v, seg, scale)
        else:
            o = flash_attention(q, k, v, seg[:, rows[0]:rows[1]].contiguous(),
                                scale, kv_segment_ids=seg)
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
        self.mesh: Optional[Mesh] = None

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor],
                key_mask: Optional[torch.Tensor], flash: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        if flash:
            attn = self.attention.flash(x, lengths)
        else:
            attn = self.attention(x, key_mask, rate, generator)
        x = self.attn_ln(x + attn.float())
        h = F.gelu(_dense(_into_model(x, self.mesh), self.mlp_in,
                          self.compute_dtype))  # exact erf
        h = _row_dense(h, self.mlp_out, self.compute_dtype, self.mesh)
        if rate > 0.0:
            h = _sequence_dropout(h, rate, generator, self.mesh)
        return self.mlp_ln(x + h.float())


def _sequence_dropout(h: torch.Tensor, rate: float, generator,
                      mesh: Optional[Mesh]) -> torch.Tensor:
    """Dropout on (B, T, H) activations; under sequence parallelism the
    whole window's mask is drawn and this rank's rows kept."""
    rows = _rows(mesh, h.shape[1])
    if rows is None:
        return _dropout(h, rate, generator)
    b, t, d = h.shape
    return _dropout(h, rate, generator, (b, t * mesh.sequence.size, d),
                    (slice(None), slice(*rows)))


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
        self.num_heads = num_heads
        self.mesh: Optional[Mesh] = None
        self.tp_specs: dict = {}
        self.to(device)

    def shard_(self, mesh: Mesh) -> "TransformerClassifier":
        """Run on ``mesh``, in place: the ``TP_RULES`` weights become this
        model rank's slices (``parallel/mesh.tp_shardings``: num_heads / tp
        heads, 4 hidden / tp MLP columns), and the window is split over the
        sequence ranks.  Every rank must hold the same full weights first."""
        tp = mesh.model.size
        if self.num_heads % tp:
            raise ValueError(f"num_heads ({self.num_heads}) must be divisible "
                             f"by model_parallel ({tp})")
        if tp > 1:
            self.tp_specs = tp_param_specs(self)
            for name, t in tp_shardings(mesh, self).items():
                if self.tp_specs[name] is not None:
                    module, leaf = name.rsplit(".", 1)
                    setattr(self.get_submodule(module), leaf,
                            nn.Parameter(t.detach().clone()))
        self.mesh = mesh
        for i in range(self.num_layers):
            block = getattr(self, f"layer_{i}")
            block.mesh = block.attention.mesh = mesh
            block.attention.num_heads = self.num_heads // tp
        return self

    def full_state_dict(self) -> dict:
        """The ``state_dict`` of one process: under tensor parallelism every
        model rank's slices joined (a collective: every rank calls it)."""
        state = self.state_dict()
        if self.mesh is None or self.mesh.model.size == 1:
            return state
        return tp_gather(self.mesh, state, self.tp_specs)

    def load_full_state_dict(self, state: dict) -> None:
        """Load one process's ``state_dict``: under tensor parallelism this
        model rank's slices of it."""
        if self.mesh is not None and self.mesh.model.size > 1:
            state = tp_shardings(self.mesh, state)
        self.load_state_dict(state)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T) int token ids, or (B, T, frame_dim) float frames ->
        (B, num_classes) logits, from the first ``max_position`` positions.
        ``lengths`` (B,) masks keys past each row's length (None: attend
        everywhere, the reference's all-ones masks).  ``generator`` (on x's
        device) draws the dropout masks in training mode."""
        x = x[:, : self.max_position]
        b, t = x.shape[:2]
        sp = 1 if self.mesh is None else self.mesh.sequence.size
        if t % sp:
            raise ValueError(f"window {t} not divisible by "
                             f"sequence_parallel ({sp})")
        rows = _rows(self.mesh, t // sp) or (0, t)
        x = x[:, rows[0]:rows[1]]
        if x.is_floating_point():
            h = self.frame_proj(x.float())
        else:
            h = self.tok_embed(x.long())
        h = self.embed_ln(h + self.pos_embed.weight[rows[0]:rows[1]][None])
        deterministic = not self.training
        rate = 0.0 if deterministic else self.dropout
        if rate > 0.0 and generator is None:
            raise ValueError("dropout in training mode needs a generator")
        if rate > 0.0:
            h = _sequence_dropout(h, rate, generator, self.mesh)
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
        if sp == 1:
            return self.classifier(h[:, 0, :])
        # position 0 lives on sequence rank 0; each sequence rank computes
        # the same logits and takes 1 / sp of their gradient
        cls = _FromFirst.apply(h[:, 0, :], self.mesh.sequence)
        return _ShareOfGrad.apply(self.classifier(cls), sp)
