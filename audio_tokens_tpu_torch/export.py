"""Serving program: padded waveforms -> (tokens, n_valid, probs) in one call.

Counterpart of ``audio_tokens_tpu/export.py::ServingProgram``.  On a CUDA
device the call runs kernel B1 (or, with ``config.normalize``, the mel
frontend and kernel B2), then the classifier: the lstm with kernel B3 for
each direction, or bert with kernel B5 (flash attention) in every layer
when ``transformer_attention="flash"``, with nothing fetched to the host in
between.  ``serve`` runs the model in eval mode under ``inference_mode``,
so neither kernel stores what only a backward would read.

Semantics are the JAX program's: the token classifier sees each clip's
valid tokens zero-padded (token 0, the reference's pad collision) to
``max_seq_len``; with ``reference_compat`` (the default) it gets
``lengths=None`` and so an all-ones mask over all ``max_seq_len``
positions, otherwise the valid frame counts.

Not ported yet (ROADMAP A): building from a saved checkpoint
(``ServingProgram(config)``), ``export_serving`` (will be ``torch.export``),
and the spec/flat input families.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.models import get_model, model_input_kind
from audio_tokens_tpu_torch.ops.mel import decode_wire
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer


class ServingProgram:
    """(padded_batch (B, >= padded_len) f32 or int16, lengths (B,) int) ->
    tokens (B, frames_max) int32, n_valid (B,) int32, probs (B, C) f32."""

    def __init__(self, config: AudioTokensConfig,
                 checkpoint_name: str = "no-wandb-best"):
        raise NotImplementedError(
            "ServingProgram from a saved checkpoint is not ported yet "
            "(ROADMAP A: infer.py with checkpoints); build it with "
            "ServingProgram.from_components")

    @classmethod
    def from_components(cls, config: AudioTokensConfig,
                        tokenizer: FusedTokenizer,
                        state_dict: Optional[dict] = None, *,
                        device: torch.device,
                        generator: Optional[torch.Generator] = None
                        ) -> "ServingProgram":
        """Build from live pieces.  ``state_dict`` (e.g. from
        ``convert.lstm_state_dict``) overrides the random init, which is
        drawn from ``generator`` (default: seeded with
        ``config.random_seed``)."""
        device = torch.device(device)
        if tokenizer.device != device:
            raise ValueError(f"tokenizer on {tokenizer.device}, program on "
                             f"{device}")
        input_kind = model_input_kind(config)
        if input_kind != "tokens":
            raise NotImplementedError(
                f"'{input_kind}' model inputs are not ported yet: ROADMAP A")
        if generator is None:
            generator = torch.Generator().manual_seed(config.random_seed)
        self = cls.__new__(cls)
        self.config = config
        self.device = device
        self.tokenizer = tokenizer
        self.model = get_model(config, device, generator)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.eval()
        return self

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
        frames_max = tokens.shape[1]
        if frames_max >= T:
            x = tokens[:, :T]
        else:
            x = torch.nn.functional.pad(tokens, (0, T - frames_max))
        # zero (= pad token, reference compat) beyond each clip's frames
        pos = torch.arange(T, device=self.device)[None, :]
        x = torch.where(pos < seq_lens[:, None], x, 0)
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
        "export_serving is not ported yet (ROADMAP A: torch.export of the "
        "serving program)")
