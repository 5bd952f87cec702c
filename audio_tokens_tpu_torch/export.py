"""Serving program: padded waveforms -> (tokens, n_valid, probs) in one call.

Counterpart of ``audio_tokens_tpu/export.py::ServingProgram``.  On a CUDA
device the call runs kernel B1 (or, with ``config.normalize``, the mel
frontend and kernel B2), then the classifier: the lstm with kernel B3 for
each direction, bert with kernel B5 (flash attention) in every layer when
``transformer_attention="flash"``, or the simple, cnn or baseline families,
with nothing fetched to the host in between.  ``serve`` runs the model in
eval mode under ``inference_mode``, so no kernel stores what only a
backward would read.

``ServingProgram(config, checkpoint_name, device=...)`` loads the
pipeline's artifacts: the centroids (``config.centroids_path``) and the
trained weights (``{config.checkpoint_dir}/{checkpoint_name}``);
``from_components`` builds from live pieces.

Semantics are the JAX program's: a token classifier sees each clip's valid
tokens zero-padded (token 0, the reference's pad collision) to
``max_seq_len``; a spec or flat classifier sees the clip's mel frames
(min-max normalized when ``config.normalize``), truncated or zero-padded to
``max_seq_len`` frames and, for flat, flattened; with ``reference_compat``
(the default) the model gets ``lengths=None``, otherwise the valid frame
counts.  The tokens are computed and returned for every family.

Not ported yet (ROADMAP A5): ``export_serving`` / ``load_serving``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.models import get_model, model_input_kind
from audio_tokens_tpu_torch.ops.mel import decode_wire
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer
from audio_tokens_tpu_torch.train.checkpoint import load_params


class ServingProgram:
    """(padded_batch (B, >= padded_len) f32 or int16, lengths (B,) int) ->
    tokens (B, frames_max) int32, n_valid (B,) int32, probs (B, C) f32."""

    def __init__(self, config: AudioTokensConfig,
                 checkpoint_name: str = "no-wandb-best", *,
                 device: torch.device | str = "cuda:0"):
        """Centroids from ``config.centroids_path``, weights from the
        checkpoint ``checkpoint_name`` under ``config.checkpoint_dir``."""
        device = torch.device(device)
        self._wire(config, FusedTokenizer.from_artifacts(config, device),
                   device, torch.Generator().manual_seed(config.random_seed))
        load_params(config.checkpoint_dir, checkpoint_name, self.model)

    @classmethod
    def from_components(cls, config: AudioTokensConfig,
                        tokenizer: FusedTokenizer,
                        state_dict: Optional[dict] = None, *,
                        device: torch.device,
                        generator: Optional[torch.Generator] = None
                        ) -> "ServingProgram":
        """Build from live pieces.  ``state_dict`` (e.g. from
        ``convert.state_dict_for``) overrides the random init, which is
        drawn from ``generator`` (default: seeded with
        ``config.random_seed``)."""
        device = torch.device(device)
        if tokenizer.device != device:
            raise ValueError(f"tokenizer on {tokenizer.device}, program on "
                             f"{device}")
        if generator is None:
            generator = torch.Generator().manual_seed(config.random_seed)
        self = cls.__new__(cls)
        self._wire(config, tokenizer, device, generator)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        return self

    def _wire(self, config: AudioTokensConfig, tokenizer: FusedTokenizer,
              device: torch.device, generator: torch.Generator) -> None:
        self.config = config
        self.device = device
        self.tokenizer = tokenizer
        self.input_kind = model_input_kind(config)
        self.model = get_model(config, device, generator).eval()

    @torch.inference_mode()
    def serve(self, padded_batch: torch.Tensor, lengths: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.config
        padded_batch = decode_wire(padded_batch.to(self.device))
        # clamp before any consumer: normalized()'s valid-frame mask would
        # otherwise count padding frames for clips longer than the window
        lengths = torch.clamp(lengths.to(self.device, torch.int32),
                              max=cfg.clip_samples)
        norm_lengths = lengths if cfg.normalize else None
        tokens = self.tokenizer._tokens_dispatch(padded_batch, norm_lengths)
        n_valid = self.tokenizer.frontend.frame_counts(lengths)
        T = cfg.max_seq_len
        seq_lens = torch.clamp(n_valid, max=T)
        if self.input_kind == "tokens":
            frames_max = tokens.shape[1]
            if frames_max >= T:
                x = tokens[:, :T]
            else:
                x = F.pad(tokens, (0, T - frames_max))
            # zero (= pad token, reference compat) beyond each clip's frames
            pos = torch.arange(T, device=self.device)[None, :]
            x = torch.where(pos < seq_lens[:, None], x, 0)
        else:
            frontend = self.tokenizer.frontend
            if cfg.normalize:
                mel = frontend.normalized(padded_batch, lengths).transpose(1, 2)
            else:
                mel = frontend.mel_frames(padded_batch)  # (B, T', M)
            b, t, m = mel.shape
            # every frame of the window, valid or not, as Predictor copies
            # them; zero frames past the window's end
            x = mel[:, :T] if t >= T else F.pad(mel, (0, 0, 0, T - t))
            if self.input_kind == "flat":
                x = x.reshape(b, T * m)
        logits = self.model(
            x, lengths=None if cfg.reference_compat else seq_lens)
        return tokens, n_valid, torch.sigmoid(logits)

    def __call__(self, padded_batch, lengths):
        return self.serve(padded_batch, lengths)

    def predict_waveforms(self, waves) -> Tuple[list, np.ndarray]:
        """Host convenience: trimmed per-clip tokens + probs (numpy)."""
        batch, lengths = self.tokenizer.frontend.prepare_batch(waves)
        tokens, n_valid, probs = self.serve(torch.from_numpy(batch),
                                            torch.from_numpy(lengths))
        tokens, n_valid = tokens.cpu().numpy(), n_valid.cpu().numpy()
        out = [tokens[i, : n_valid[i]].astype(np.int64)
               for i in range(len(waves))]
        return out, probs.cpu().numpy()


def export_serving(config: AudioTokensConfig, out_dir, batch_size: int = 64,
                   checkpoint_name: str = "no-wandb-best",
                   portable: bool = True):
    raise NotImplementedError(
        "export_serving is not ported yet (ROADMAP A5): torch.export cannot "
        "trace the kernels' ctypes bindings; they must first become "
        "torch.library custom ops with fake implementations")
