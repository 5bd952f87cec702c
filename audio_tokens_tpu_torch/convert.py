"""Carry parameters of the JAX package's models over to the port.

``lstm_state_dict(params)`` maps a ``SimpleLSTMTokenClassifier`` parameter
tree (nested dicts of arrays, as ``model.init(...)["params"]`` gives, after
``jax.device_get`` / ``np.asarray``) to the port model's ``state_dict``:

    embedding/embedding          -> embedding.weight
    lstm_l{i}_{fwd,bwd}/w_ih     -> lstm_l{i}_{fwd,bwd}.w_ih     (E, 4H), copied
    lstm_l{i}_{fwd,bwd}/w_hh     -> lstm_l{i}_{fwd,bwd}.w_hh     (H, 4H), copied
    lstm_l{i}_{fwd,bwd}/bias     -> lstm_l{i}_{fwd,bwd}.bias     (4H,), copied
    fc/kernel                    -> fc.weight                    transposed
    fc/bias                      -> fc.bias

The LSTM weights keep the JAX layouts at the kernel boundary, so they are
copies; only the ``nn.Linear`` head is transposed.  Takes numpy, not jax:
this package never imports jax.  The same map carries a JAX gradient tree
(``jax.grad`` of the classifier) to the port's parameter names: the
transplanted model's gradients equal JAX's
(``tests/test_torch_train_lstm.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "/"))
        else:
            out[name] = np.asarray(val, dtype=np.float32)
    return out


def lstm_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``SimpleLSTMTokenClassifier`` params -> port ``state_dict``."""
    flat = _flatten(params)
    out = {}
    for name, arr in flat.items():
        module, leaf = name.rsplit("/", 1)
        if name == "embedding/embedding":
            out["embedding.weight"] = arr
        elif name == "fc/kernel":
            out["fc.weight"] = arr.T
        elif name == "fc/bias":
            out["fc.bias"] = arr
        elif module.startswith("lstm_l") and leaf in ("w_ih", "w_hh", "bias"):
            out[f"{module}.{leaf}"] = arr
        else:
            raise KeyError(f"unexpected parameter {name}")
    return {k: torch.tensor(v) for k, v in out.items()}
