"""Fused wav -> token-id program (counterpart of ``audio_tokens_tpu/tokenizer.py``).

Two routes, chosen by the same gate as the JAX package:

* no conv front-end, no per-clip min-max normalization (``config.normalize``
  False) and hop | n_fft: kernel B1, the wav -> tokens megakernel
  (``ops/cuda_tokenizer.py``);
* otherwise: mel frontend (plain PyTorch) -> kernel B2, the fused
  normalize + nearest-centroid kernel (``ops/cuda_vq.py``).

Each kernel's wrapper takes its plain PyTorch version for CPU tensors and
launches the CUDA kernel (or raises) for CUDA tensors, so the device the
tokenizer is built on decides; nothing is detected.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
from audio_tokens_tpu_torch.ops.mel import MelFrontend, decode_wire, num_frames
from audio_tokens_tpu_torch.ops.vq import vq_assign_fused


def _check_ported(config: AudioTokensConfig) -> None:
    """Refuse the tokenizer options this package has not ported yet (see
    ROADMAP.md) instead of running something else in their place."""
    if config.use_convolution:
        raise NotImplementedError(
            "use_convolution (ConvFeatures) is not ported yet: ROADMAP A")
    for name in ("tokenizer_precision", "tokenizer_vq_precision"):
        if getattr(config, name) != "highest":
            raise NotImplementedError(
                f"{name}='{getattr(config, name)}' is not ported yet; only "
                "'highest' (float32) is: ROADMAP A")


class FusedTokenizer:
    def __init__(self, config: AudioTokensConfig, centroids: np.ndarray,
                 device: torch.device):
        _check_ported(config)
        self.config = config
        self.device = torch.device(device)
        self.frontend = MelFrontend(
            self.device,
            sample_rate=config.common_sr,
            n_mels=config.n_mels,
            n_fft=config.n_fft,
            hop_length=config.hop_length,
            clip_samples=config.clip_samples,
        )
        centroids = np.asarray(centroids, np.float32)
        self.centroids = torch.from_numpy(centroids).to(self.device)
        # the megakernel gate of audio_tokens_tpu/tokenizer.py: per-clip
        # min-max normalization needs clip-global statistics, so it runs
        # the staged mel -> B2 route
        self.kernel = None
        if not config.normalize and config.n_fft % config.hop_length == 0:
            self.kernel = TokenizerKernel(
                config.common_sr, config.n_mels, config.n_fft,
                config.hop_length, self.frontend.frames_max, centroids,
                self.device)

    def tokens_from_padded(self, padded_batch: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """(B, pad+T+pad) waveforms (float32 or int16 PCM) -> (B, frames_max)
        int32 token ids.  ``lengths`` (true sample counts) is required when
        ``config.normalize``: min-max scaling runs over each clip's valid
        frames."""
        if self.config.normalize and lengths is None:
            raise ValueError("config.normalize=True requires lengths")
        return self._tokens_dispatch(decode_wire(padded_batch), lengths)

    def _tokens_dispatch(self, padded_batch: torch.Tensor,
                         lengths: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Megakernel when engaged and the rows are long enough, else the
        staged route."""
        if (self.kernel is not None
                and padded_batch.shape[1] >= self.kernel.padded_len):
            return self.kernel(padded_batch)
        return self._tokens_impl(padded_batch, lengths)

    def _tokens_impl(self, padded_batch: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.config.normalize:
            # min-max over valid frames, like the saved artifacts
            mel = self.frontend.normalized(padded_batch, lengths)
            mel = mel.transpose(1, 2)
        else:
            mel = self.frontend.mel_frames(padded_batch)  # (B, T, M)
        b, t, m = mel.shape
        frames = mel.reshape(b * t, m)
        return vq_assign_fused(frames, self.centroids,
                               normalize=True).reshape(b, t)

    def tokenize_waveforms(self, waves: List[np.ndarray]) -> List[np.ndarray]:
        """Host convenience: list of 1-D float arrays -> per-clip token arrays
        (trimmed to each clip's valid frame count)."""
        batch, lengths = self.frontend.prepare_batch(waves)
        tokens = self.tokens_from_padded(
            torch.from_numpy(batch).to(self.device),
            torch.from_numpy(lengths).to(self.device)
            if self.config.normalize else None,
        ).cpu().numpy()
        out = []
        for i, w in enumerate(waves):
            n_valid = num_frames(
                min(len(w), self.config.clip_samples), self.config.hop_length)
            out.append(tokens[i, :n_valid].astype(np.int64))
        return out

    @classmethod
    def from_artifacts(cls, config: AudioTokensConfig,
                       device: torch.device) -> "FusedTokenizer":
        """Load centroids from the pipeline's artifacts
        (``config.centroids_path``)."""
        centroids = np.load(config.centroids_path).astype(np.float32)
        return cls(config, centroids, device)
