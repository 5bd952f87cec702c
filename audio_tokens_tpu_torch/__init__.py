"""audio_tokens_tpu_torch — the PyTorch + CUDA port of ``audio_tokens_tpu``.

The JAX package beside this one is the reference; this package computes the
same functions with PyTorch on the host and hand-written CUDA C++ kernels
(``csrc/``, built for ``sm_90a`` at first use) on an NVIDIA Hopper card.

It covers the pipeline's stages (``run_pipeline``), training of the five
classifiers (lstm, bert, simple, cnn, baseline) and serving from their
checkpoints, waveforms -> (tokens, n_valid, probs):

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.export import ServingProgram
    from audio_tokens_tpu_torch.infer import ManualTester, Predictor
    from audio_tokens_tpu_torch.processors.model_trainer import ModelTrainer

Importing the package imports nothing heavy: no jax, no compiler, no build.
"""

from audio_tokens_tpu_torch.config import AudioTokensConfig

__version__ = "0.1.0"

__all__ = ["AudioTokensConfig", "__version__"]
