"""Fused wav -> token-id program (counterpart of ``audio_tokens_tpu/tokenizer.py``).

Two routes, chosen by the same gate as the JAX package:

* no conv front-end, no per-clip min-max normalization (``config.normalize``
  False) and hop | n_fft: kernel B1, the wav -> tokens megakernel
  (``ops/cuda_tokenizer.py``), at the precision tiers
  ``config.tokenizer_precision`` (DFT and mel products) and
  ``config.tokenizer_vq_precision`` (the centroid distances);
* otherwise: mel frontend (plain PyTorch) -> [the conv front-end
  ``ops/conv_features.ConvFeatures``] -> kernel B2, the fused normalize +
  nearest-centroid kernel (``ops/cuda_vq.py``), in f32: the tiers are B1's,
  as in the JAX package.

Each kernel's wrapper takes its plain PyTorch version for CPU tensors and
launches the CUDA kernel (or raises) for CUDA tensors, so the device the
tokenizer is built on decides; nothing is detected.  ``use_kernels=False``
(the counterpart of the JAX ``use_pallas=False``) asks for the plain route
on any device: the mel frontend, then the plain nearest-centroid search,
with no kernel's op in between, as a portable serving export needs; where
B1's gate holds and a tier is not ``highest``, the plain version of B1 at
the tiers (``TokenizerKernel.plain``), so that a portable program computes
what the kernel form does.

``FusedTokenizer`` is an ``nn.Module``: its centroids, the frontend's and
the kernel's tensors are buffers, so that a traced serving program owns
them.  ``tokens_sharded`` splits a batch over the ranks of a mesh (one
process a card) and gathers the tokens.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.ops.conv_features import ConvFeatures
from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin_plain
from audio_tokens_tpu_torch.ops.mel import MelFrontend, decode_wire, num_frames
from audio_tokens_tpu_torch.ops.tiers import check_tier
from audio_tokens_tpu_torch.ops.vq import vq_assign_fused
from audio_tokens_tpu_torch.parallel.mesh import data_axis


class FusedTokenizer(nn.Module):
    def __init__(self, config: AudioTokensConfig, centroids: np.ndarray,
                 device: torch.device, use_kernels: bool = True,
                 conv: Optional[ConvFeatures] = None):
        super().__init__()
        tier = check_tier(config.tokenizer_precision,
                          "tokenizer precision tier")
        vq_tier = check_tier(config.tokenizer_vq_precision,
                             "VQ precision tier")
        self.config = config
        self.device = torch.device(device)
        self.use_kernels = use_kernels
        self.conv = None if conv is None else conv.to(self.device)
        self.frontend = MelFrontend(
            self.device,
            sample_rate=config.common_sr,
            n_mels=config.n_mels,
            n_fft=config.n_fft,
            hop_length=config.hop_length,
            clip_samples=config.clip_samples,
        )
        centroids = np.asarray(centroids, np.float32)
        self.register_buffer("centroids",
                             torch.from_numpy(centroids).to(self.device))
        # the megakernel gate of audio_tokens_tpu/tokenizer.py: a conv
        # front-end, or per-clip min-max normalization (clip-global
        # statistics), runs the staged mel -> [conv] -> B2 route
        self.kernel = self.plain_kernel = None
        if (conv is None and not config.normalize
                and config.n_fft % config.hop_length == 0
                and (use_kernels or (tier, vq_tier) != ("highest",
                                                        "highest"))):
            kernel = TokenizerKernel(
                config.common_sr, config.n_mels, config.n_fft,
                config.hop_length, self.frontend.frames_max, centroids,
                self.device, tier, vq_tier)
            if use_kernels:
                self.kernel = kernel
            else:  # B1's plain version at the tiers, no op
                self.plain_kernel = kernel

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

    def tokens_sharded(self, padded_batch: torch.Tensor, mesh,
                       lengths: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """``tokens_from_padded`` with the batch split over the ranks of
        ``mesh`` (``parallel/mesh``'s ``Mesh``, its data axis, or a
        ``DataGroup``: one process a card, so the mesh is the process
        group).  Every rank passes the whole batch, takes its contiguous
        rows, tokenizes them (B1, or the mel frontend and B2) and gathers
        the ranks' tokens in rank order: every rank returns the whole
        batch's, equal to one process's.  The int16 wire is decoded before
        any compute."""
        group = data_axis(mesh)
        b = padded_batch.shape[0]
        if b % group.size:
            raise ValueError(f"batch {b} not divisible by data={group.size}")
        padded_batch = decode_wire(padded_batch)
        if self.config.normalize and lengths is None:
            raise ValueError("config.normalize=True requires lengths")
        lo, hi = group.row_bounds(b)
        rows = padded_batch[lo:hi].to(self.device)
        if self.config.normalize:
            tokens = self._tokens_impl(rows, lengths[lo:hi].to(self.device))
        else:
            tokens = self._tokens_dispatch(rows)
        return group.all_gather(tokens, 0)

    def _tokens_dispatch(self, padded_batch: torch.Tensor,
                         lengths: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Megakernel when engaged and the rows are long enough, else the
        staged route."""
        if (self.kernel is not None
                and padded_batch.shape[1] >= self.kernel.padded_len):
            return self.kernel(padded_batch)
        if (self.plain_kernel is not None
                and padded_batch.shape[1] >= self.plain_kernel.padded_len):
            return self.plain_kernel.plain(padded_batch)
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
        if self.conv is not None:
            frames = self.conv(frames)
        if not self.use_kernels:
            return vq_argmin_plain(frames, self.centroids,
                                   normalize=True).reshape(b, t)
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
    def from_artifacts(cls, config: AudioTokensConfig, device: torch.device,
                       use_kernels: bool = True) -> "FusedTokenizer":
        """Load centroids (and, under ``use_convolution``, the conv weights
        saved beside them, ``<centroids>.conv.npz``) from the pipeline's
        artifacts (``config.centroids_path``)."""
        from pathlib import Path

        from audio_tokens_tpu_torch.processors.cluster_creator import (
            make_conv_features,
        )

        centroids = np.load(config.centroids_path).astype(np.float32)
        conv = make_conv_features(config)
        if conv is not None:
            state = Path(config.centroids_path).with_suffix(".conv.npz")
            if state.exists():
                conv.load_state_dict(dict(np.load(state)))
        return cls(config, centroids, device, use_kernels, conv)
