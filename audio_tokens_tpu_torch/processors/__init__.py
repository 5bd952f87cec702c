"""Pipeline stages of the port, in the order a run takes them."""

from audio_tokens_tpu_torch.processors.cluster_creator import ClusterCreator
from audio_tokens_tpu_torch.processors.model_trainer import ModelTrainer
from audio_tokens_tpu_torch.processors.spec_tokenizer import SpecTokenizer
from audio_tokens_tpu_torch.processors.spectrogram_generator import (
    SpectrogramGenerator,
)

__all__ = [
    "SpectrogramGenerator",
    "ClusterCreator",
    "SpecTokenizer",
    "ModelTrainer",
]
