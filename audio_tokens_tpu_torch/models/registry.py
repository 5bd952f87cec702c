"""Model factory (counterpart of ``audio_tokens_tpu/models/registry.py``).

Only ``model_type="lstm"`` is ported so far; the other four families raise
``NotImplementedError`` naming their ROADMAP item rather than building
something else.
"""

from __future__ import annotations

import torch
from torch import nn

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.models.lstm import SimpleLSTMTokenClassifier

# What each model consumes: 'tokens' (int IDs), 'spec' (B,T,M), 'flat' (B,D)
_INPUT_KINDS = {
    "lstm": "tokens",
    "simple": "tokens",
    "bert": "tokens",
    "cnn": "spec",
    "baseline": "flat",
}

_NOT_PORTED = {
    "simple": "ROADMAP A, the other model families",
    "bert": "ROADMAP A, the other model families (and B: flash attention)",
    "cnn": "ROADMAP A, the other model families",
    "baseline": "ROADMAP A, the other model families",
}


def model_input_kind(config: AudioTokensConfig) -> str:
    if config.model_type in ("lstm", "bert") and config.use_precomputed_embeddings:
        return "spec"  # raw-frame embeddings path (reference lstm :26-31)
    try:
        return _INPUT_KINDS[config.model_type]
    except KeyError:
        raise ValueError(f"Unknown model type: {config.model_type}") from None


def get_model(config: AudioTokensConfig, device: torch.device,
              generator: torch.Generator) -> nn.Module:
    """The classifier for ``config.model_type``, randomly initialized from
    ``generator`` and placed on ``device``."""
    if config.model_type == "lstm":
        if config.lstm_remat_chunk > 0:
            raise NotImplementedError(
                "lstm_remat_chunk > 0 (chunked recompute of the recurrence) "
                "is not ported yet: ROADMAP A7")
        return SimpleLSTMTokenClassifier(
            vocab_size=config.vocab_size,
            embed_dim=config.lstm_embed_dim,
            hidden_dim=config.lstm_hidden_dim,
            num_layers=config.num_layers,
            num_classes=config.num_classes,
            dropout=config.dropout,
            device=device,
            generator=generator,
        )
    if config.model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type='{config.model_type}' is not ported yet: "
            f"{_NOT_PORTED[config.model_type]}")
    raise ValueError(f"Unknown model type: {config.model_type}")
