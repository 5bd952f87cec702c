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
copies; only the ``nn.Linear`` head is transposed.

``bert_state_dict(params)`` does the same for a ``TransformerClassifier``
tree.  Every dense layer is an ``nn.Linear`` in the port, weight (out, in):

    tok_embed/embedding, pos_embed/embedding -> {tok,pos}_embed.weight
    {embed_ln,layer_i/attn_ln,layer_i/mlp_ln}/{scale,bias} -> .weight, .bias
    layer_i/attention/{query,key,value}/kernel (H, nh, dh) -> reshaped (H, H),
                                                              transposed
    layer_i/attention/{query,key,value}/bias (nh, dh)      -> reshaped (H,)
    layer_i/attention/out/kernel (nh, dh, H)               -> reshaped (H, H),
                                                              transposed
    {layer_i/mlp_in,layer_i/mlp_out,classifier,frame_proj}/kernel -> transposed

``simple_state_dict``, ``cnn_state_dict`` and ``mlp_state_dict`` map the
``SimpleTokenClassifier``, ``CNNClassifier`` and ``BaselineMLPClassifier``
trees:

    embedding/embedding              -> embedding.weight  (V, E), copied
    {conv1,conv2}/kernel (3, 3, I, O) -> .weight (O, I, 3, 3)  (HWIO -> OIHW)
    {classifier,fc1,fc2,fc3}/kernel  -> .weight             transposed
    */bias                           -> .bias

The port's cnn flattens its activation in the JAX module's NHWC order, so
``fc1``'s rows need no permutation.  ``state_dict_for(model_type, params)``
picks the map of a family.

Takes numpy, not jax:
this package never imports jax.  The same map carries a JAX gradient tree
(``jax.grad`` of the classifier) to the port's parameter names: the
transplanted model's gradients equal JAX's
(``tests/test_torch_train_lstm.py``, ``tests/test_torch_bert.py``,
``tests/test_torch_families.py``).
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


def bert_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``TransformerClassifier`` params -> port ``state_dict``."""
    out = {}
    for name, arr in _flatten(params).items():
        module, leaf = name.rsplit("/", 1)
        dst = module.replace("/", ".")
        if leaf == "embedding" and module in ("tok_embed", "pos_embed"):
            out[f"{dst}.weight"] = arr
        elif leaf == "scale":
            out[f"{dst}.weight"] = arr
        elif leaf == "kernel":  # (in..., out...) -> (in, out) -> (out, in)
            if module.endswith("attention/out"):
                arr = arr.reshape(-1, arr.shape[-1])
            out[f"{dst}.weight"] = arr.reshape(arr.shape[0], -1).T
        elif leaf == "bias":
            out[f"{dst}.bias"] = arr.reshape(-1)
        else:
            raise KeyError(f"unexpected parameter {name}")
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in out.items()}


def _layers_state_dict(params: Mapping, modules) -> Dict[str, torch.Tensor]:
    """Embedding, conv and dense layers named ``modules`` -> ``state_dict``."""
    out = {}
    for name, arr in _flatten(params).items():
        module, leaf = name.rsplit("/", 1)
        if module not in modules:
            raise KeyError(f"unexpected parameter {name}")
        if leaf == "embedding":
            out[f"{module}.weight"] = arr
        elif leaf == "kernel" and arr.ndim == 4:  # HWIO -> OIHW
            out[f"{module}.weight"] = arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            out[f"{module}.weight"] = arr.T
        elif leaf == "bias":
            out[f"{module}.bias"] = arr
        else:
            raise KeyError(f"unexpected parameter {name}")
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in out.items()}


def simple_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``SimpleTokenClassifier`` params -> port ``state_dict``."""
    return _layers_state_dict(params, ("embedding", "classifier"))


def cnn_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``CNNClassifier`` params -> port ``state_dict``."""
    return _layers_state_dict(params, ("conv1", "conv2", "fc1", "fc2"))


def mlp_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``BaselineMLPClassifier`` params -> port ``state_dict``."""
    return _layers_state_dict(params, ("fc1", "fc2", "fc3"))


_STATE_DICTS = {
    "lstm": lstm_state_dict,
    "bert": bert_state_dict,
    "simple": simple_state_dict,
    "cnn": cnn_state_dict,
    "baseline": mlp_state_dict,
}


def state_dict_for(model_type: str, params: Mapping
                   ) -> Dict[str, torch.Tensor]:
    """The map of ``model_type``'s family applied to ``params``."""
    if model_type not in _STATE_DICTS:
        raise ValueError(f"Unknown model type: {model_type}")
    return _STATE_DICTS[model_type](params)
