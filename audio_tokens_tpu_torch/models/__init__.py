"""Classifiers of the port."""

from audio_tokens_tpu_torch.models.registry import get_model, model_input_kind

__all__ = ["get_model", "model_input_kind"]
