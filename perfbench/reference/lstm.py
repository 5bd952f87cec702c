"""The bidirectional LSTM token classifier, stepped in a Python loop.

Embedding -> per direction ``g = x w_ih + b + h w_hh`` with gates
(i, f, g, o), ``c = sig(f) c + sig(i) tanh(g)``, ``h = sig(o) tanh(c)``,
from a zero state; the forward direction runs t = 0 .. T-1 and the
backward direction T-1 .. 0, each over every position (the served and
trained model sees no lengths: the reference's all-ones mask) -> the two
last hidden states joined -> ReLU -> linear.  The two directions of a
layer step together, as one batched product a step.  Weights are named as
the classifier's ``state_dict``: ``embedding.weight`` (V, E); per layer
and direction ``lstm_l{n}_{fwd|bwd}.w_ih`` (in, 4H), ``.w_hh`` (H, 4H),
``.bias`` (4H,); ``fc.weight`` (C, 2H), ``fc.bias`` (C,).
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.precision import dtype_of, matmul


def _layer(x: torch.Tensor, w: Dict[str, torch.Tensor], layer: int,
           precision: str):
    """(B, T, in) -> (hidden states (B, T, 2H), last states (B, 2H))."""
    dt = dtype_of(precision)
    b, t, _ = x.shape
    p = [f"lstm_l{layer}_{d}." for d in ("fwd", "bwd")]
    w_hh = torch.stack([w[q + "w_hh"].to(dt) for q in p])  # (2, H, 4H)
    hidden = w_hh.shape[1]
    xg = [matmul(x, w[q + "w_ih"], precision) + w[q + "bias"].to(dt)
          for q in p]
    # (2, T, B, 4H): the backward direction's inputs in its own order
    xg = torch.stack([xg[0], xg[1].flip(1)]).transpose(1, 2)
    h = torch.zeros((2, b, hidden), dtype=dt, device=x.device)
    c = torch.zeros_like(h)
    out = []
    for s in range(t):
        g = xg[:, s] + matmul(h, w_hh, precision)
        i, f, gg, o = g.split(hidden, dim=2)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    hs = torch.stack(out, dim=2)  # (2, B, T, H)
    hs = torch.cat([hs[0], hs[1].flip(1)], dim=-1)
    return hs, torch.cat([h[0], h[1]], dim=-1)


def logits(tokens: torch.Tensor, w: Dict[str, torch.Tensor], num_layers: int,
           precision: str = "float64") -> torch.Tensor:
    """(B, T) token ids -> (B, C) logits."""
    dt = dtype_of(precision)
    x = w["embedding.weight"].to(dt)[tokens.long()]
    last = None
    for layer in range(num_layers):
        x, last = _layer(x, w, layer, precision)
    return (matmul(torch.relu(last), w["fc.weight"].t(), precision)
            + w["fc.bias"].to(dt))
