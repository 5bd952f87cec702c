"""Model factory (counterpart of ``audio_tokens_tpu/models/registry.py``):
the same five ``model_type`` strings build the same architectures from the
same config fields.  The spec and flat families are sized by the inputs the
trainer and the serving program give them (``max_seq_len`` frames of
``n_mels``), where flax infers the width from the first input.
"""

from __future__ import annotations

import torch
from torch import nn

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.models.cnn import CNNClassifier
from audio_tokens_tpu_torch.models.lstm import SimpleLSTMTokenClassifier
from audio_tokens_tpu_torch.models.mlp import BaselineMLPClassifier
from audio_tokens_tpu_torch.models.simple import SimpleTokenClassifier
from audio_tokens_tpu_torch.models.transformer import TransformerClassifier

# What each model consumes: 'tokens' (int IDs), 'spec' (B,T,M), 'flat' (B,D)
_INPUT_KINDS = {
    "lstm": "tokens",
    "simple": "tokens",
    "bert": "tokens",
    "cnn": "spec",
    "baseline": "flat",
}


def model_input_kind(config: AudioTokensConfig) -> str:
    if config.model_type in ("lstm", "bert") and config.use_precomputed_embeddings:
        return "spec"  # raw-frame embeddings path (reference lstm :26-31)
    try:
        return _INPUT_KINDS[config.model_type]
    except KeyError:
        raise ValueError(f"Unknown model type: {config.model_type}") from None


def _resolve_transformer_attention(config: AudioTokensConfig) -> str:
    """'auto' -> the plain ('xla') route; 'flash' (kernel B5, eval passes
    only) and 'xla' pass through; anything else raises, so a typo cannot
    silently run another route.  The JAX package's 'auto' rule was measured
    on a TPU; which route 'auto' takes on the card is still to be decided
    from the card's in-model times (PERF.md)."""
    impl = getattr(config, "transformer_attention", "auto")
    if impl in ("xla", "flash"):
        return impl
    if impl != "auto":
        raise ValueError(
            f"transformer_attention must be 'auto', 'xla' or 'flash', "
            f"got '{impl}'")
    return "xla"


def _compute_dtype(config: AudioTokensConfig) -> torch.dtype:
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    try:
        return dtypes[config.compute_dtype]
    except KeyError:
        raise ValueError(f"compute_dtype must be one of {sorted(dtypes)}, "
                         f"got '{config.compute_dtype}'") from None


def get_model(config: AudioTokensConfig, device: torch.device,
              generator: torch.Generator,
              use_kernels: bool = True) -> nn.Module:
    """The classifier for ``config.model_type``, randomly initialized from
    ``generator`` and placed on ``device``.  ``use_kernels=False`` builds
    the lstm's recurrence as a scan of its plain step (a portable serving
    export); bert's attention is ``config.transformer_attention``'s, which
    ``export.ServingProgram`` sets to the plain one when it runs no
    kernels."""
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
            frame_dim=(config.n_mels if model_input_kind(config) == "spec"
                       else None),
            device=device,
            generator=generator,
            use_kernels=use_kernels,
        )
    if config.model_type == "bert":
        if config.transformer_remat:
            raise NotImplementedError(
                "transformer_remat=True (recompute each encoder block in the "
                "backward) is not ported yet: ROADMAP A7")
        return TransformerClassifier(
            vocab_size=config.vocab_size,
            num_layers=config.num_layers,
            num_classes=config.num_classes,
            hidden_size=config.hidden_size,
            max_position=config.transformer_max_position,
            dropout=config.dropout,
            compute_dtype=_compute_dtype(config),
            attention_impl=_resolve_transformer_attention(config),
            frame_dim=(config.n_mels if model_input_kind(config) == "spec"
                       else None),
            device=device,
            generator=generator,
        )
    if config.model_type == "simple":
        return SimpleTokenClassifier(
            vocab_size=config.vocab_size,
            hidden_size=config.hidden_size,
            num_classes=config.num_classes,
            device=device,
            generator=generator,
        )
    if config.model_type == "cnn":
        return CNNClassifier(
            max_seq_len=config.max_seq_len,
            n_mels=config.n_mels,
            num_classes=config.num_classes,
            compute_dtype=_compute_dtype(config),
            device=device,
            generator=generator,
        )
    if config.model_type == "baseline":
        return BaselineMLPClassifier(
            input_dim=config.max_seq_len * config.n_mels,
            num_classes=config.num_classes,
            compute_dtype=_compute_dtype(config),
            device=device,
            generator=generator,
        )
    raise ValueError(f"Unknown model type: {config.model_type}")
