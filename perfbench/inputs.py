"""Weights and centroids made from ``--seed`` on the device, in a few large
calls, in the type they are served in (float32 leaves), and handed the
same to the program and to the reference.

The leaves are named and shaped as the classifiers' ``state_dict``; the
scales follow the program's own initialization (normal embeddings, the
lstm's uniform bounds, lecun-normal dense layers), with small random
biases and LayerNorm parameters so that every term of the math is
exercised.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, float]  # name, shape, kind, scale

STREAMS = {"weights": 1, "centroids": 2, "traffic": 3, "init": 4}


def generator(seed: int, stream: str, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for one stream of one seed."""
    mixed = (int(seed) * 6364136223846793005 + STREAMS[stream]) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def lstm_specs(cfg: dict) -> List[Spec]:
    v, e = cfg["vocab_size"], cfg["lstm_embed_dim"]
    h, c = cfg["lstm_hidden_dim"], cfg["num_classes"]
    specs: List[Spec] = [("embedding.weight", (v, e), "normal", 1.0)]
    bound = 1.0 / math.sqrt(h)
    for layer in range(cfg["num_layers"]):
        width = e if layer == 0 else 2 * h
        for d in ("fwd", "bwd"):
            p = f"lstm_l{layer}_{d}."
            specs += [(p + "w_ih", (width, 4 * h), "uniform", bound),
                      (p + "w_hh", (h, 4 * h), "uniform", bound),
                      (p + "bias", (4 * h,), "uniform", bound)]
    bound = 1.0 / math.sqrt(2 * h)
    return specs + [("fc.weight", (c, 2 * h), "uniform", bound),
                    ("fc.bias", (c,), "uniform", bound)]


def bert_specs(cfg: dict) -> List[Spec]:
    v, hid = cfg["vocab_size"], cfg["hidden_size"]
    c, p = cfg["num_classes"], cfg["transformer_max_position"]
    std = 1.0 / math.sqrt(hid)

    def dense(name, out, inp):
        return [(name + ".weight", (out, inp), "normal", 1.0 / math.sqrt(inp)),
                (name + ".bias", (out,), "normal", 0.02)]

    def ln(name):
        return [(name + ".weight", (hid,), "one_normal", 0.02),
                (name + ".bias", (hid,), "normal", 0.02)]

    specs = [("tok_embed.weight", (v, hid), "normal", std),
             ("pos_embed.weight", (p, hid), "normal", std)] + ln("embed_ln")
    for n in range(cfg["num_layers"]):
        q = f"layer_{n}."
        for name in ("query", "key", "value", "out"):
            specs += dense(q + "attention." + name, hid, hid)
        specs += ln(q + "attn_ln") + dense(q + "mlp_in", 4 * hid, hid)
        specs += dense(q + "mlp_out", hid, 4 * hid) + ln(q + "mlp_ln")
    return specs + dense("classifier", c, hid)


SPECS = {"lstm": lstm_specs, "bert": bert_specs}


def make_weights(cfg: dict, seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """The classifier's leaves: one normal and one uniform draw for all of
    them, cut and scaled."""
    specs = SPECS[cfg["model_type"]](cfg)
    gen = generator(seed, "weights", device)
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in specs
                       if (k == "uniform") == (kind == "uniform"))
             for kind in ("normal", "uniform")}
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    uniform = torch.rand(sizes["uniform"], generator=gen,
                         device=device) * 2.0 - 1.0
    out, at = {}, {"normal": 0, "uniform": 0}
    for name, shape, kind, scale in specs:
        src = "uniform" if kind == "uniform" else "normal"
        n = math.prod(shape)
        leaf = (uniform if src == "uniform" else normal)[at[src]:at[src] + n]
        at[src] += n
        leaf = leaf.view(shape) * scale
        out[name] = leaf + 1.0 if kind == "one_normal" else leaf
    return out


def unit_centroids(k: int, d: int, seed: int, device: torch.device
                   ) -> torch.Tensor:
    """(k, d) unit-norm normals: a vocabulary of L2-normalized frames."""
    c = torch.randn((k, d), generator=generator(seed, "centroids", device),
                    device=device)
    return c / torch.linalg.vector_norm(c, dim=1, keepdim=True)
