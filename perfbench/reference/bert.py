"""The BERT-style encoder classifier, in eval mode.

Token and learned position embeddings, LayerNorm (eps 1e-12); per layer
post-LN blocks: multi-head self-attention over every position (heads of
64, scores scaled by 1/8, softmax, no mask: the reference's all-ones
attention mask), out projection, ``LN(x + attention)``, an exact-erf GELU
MLP of 4 H, ``LN(x + mlp)``; then a linear head on position 0.  Weights
are named as the classifier's ``state_dict`` (``nn.Linear`` weights are
(out, in)): ``tok_embed.weight``, ``pos_embed.weight``, ``embed_ln.*``,
``layer_{n}.attention.{query,key,value,out}.*``, ``layer_{n}.attn_ln.*``,
``layer_{n}.mlp_in.*``, ``layer_{n}.mlp_out.*``, ``layer_{n}.mlp_ln.*``,
``classifier.*``.

``precision`` sets every product (the dense layers and the two attention
products); LayerNorm, softmax and GELU run in the precision's dtype.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.precision import dtype_of, matmul

LN_EPS = 1e-12
HEAD_DIM = 64


def _ln(x, w, name):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"].to(x.dtype),
                        w[name + ".bias"].to(x.dtype), LN_EPS)


def _dense(x, w, name, precision):
    return (matmul(x, w[name + ".weight"].t(), precision)
            + w[name + ".bias"].to(dtype_of(precision)))


def logits(tokens: torch.Tensor, w: Dict[str, torch.Tensor], num_layers: int,
           window: int, precision: str = "float64",
           block: int = 4) -> torch.Tensor:
    """(B, >= window) token ids -> (B, C) logits, ``block`` rows at a time
    (the (rows, heads, T, T) scores of a block at once)."""
    return torch.cat([_logits(tokens[i:i + block, :window], w, num_layers,
                              precision)
                      for i in range(0, tokens.shape[0], block)])


def _logits(tokens, w, num_layers, precision):
    dt = dtype_of(precision)
    b, t = tokens.shape
    h = w["tok_embed.weight"].to(dt)[tokens.long()] + w[
        "pos_embed.weight"].to(dt)[:t][None]
    h = _ln(h, w, "embed_ln")
    hidden = h.shape[-1]
    heads = hidden // HEAD_DIM
    for n in range(num_layers):
        p = f"layer_{n}."

        def split(name):
            return _dense(h, w, p + "attention." + name, precision).view(
                b, t, heads, HEAD_DIM).transpose(1, 2)

        q, k, v = split("query"), split("key"), split("value")
        s = matmul(q / math.sqrt(HEAD_DIM), k.transpose(-1, -2), precision)
        o = matmul(torch.softmax(s, dim=-1), v, precision)
        o = o.transpose(1, 2).reshape(b, t, hidden)
        x = _ln(h + _dense(o, w, p + "attention.out", precision), w,
                p + "attn_ln")
        m = F.gelu(_dense(x, w, p + "mlp_in", precision))
        h = _ln(x + _dense(m, w, p + "mlp_out", precision), w, p + "mlp_ln")
    return _dense(h[:, 0], w, "classifier", precision)
