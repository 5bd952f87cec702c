"""Serving program: padded waveforms -> (tokens, n_valid, probs) in one call,
and its export to one saved program (``torch.export``).

Counterpart of ``audio_tokens_tpu/export.py``.  On a CUDA device the call
runs kernel B1 (or, with ``config.normalize``, the mel frontend and kernel
B2), then the classifier: the lstm with kernel B3 for each direction, bert
with kernel B5 (flash attention) in every layer when
``transformer_attention="flash"``, or the simple, cnn or baseline families,
with nothing fetched to the host in between.  ``serve`` runs the model in
eval mode under ``inference_mode``, so no kernel stores what only a
backward would read.

``ServingProgram(config, checkpoint_name, device=...)`` loads the
pipeline's artifacts: the centroids (``config.centroids_path``) and the
trained weights (``{config.checkpoint_dir}/{checkpoint_name}``);
``from_components`` builds from live pieces.  ``use_kernels=False`` (the
JAX ``use_pallas=False``) runs the plain versions on any device: the mel
frontend and the plain nearest-centroid search, the lstm's recurrence as a
scan of its plain step, bert's plain attention.

Semantics are the JAX program's: a token classifier sees each clip's valid
tokens zero-padded (token 0, the reference's pad collision) to
``max_seq_len``; a spec or flat classifier sees the clip's mel frames
(min-max normalized when ``config.normalize``), truncated or zero-padded to
``max_seq_len`` frames and, for flat, flattened; with ``reference_compat``
(the default) the model gets ``lengths=None``, otherwise the valid frame
counts.  The tokens are computed and returned for every family.

``export_serving`` traces ``ServingModule`` (the tokenizer's tensors as
buffers, the classifier as a submodule) with ``torch.export`` at static
shapes and saves it with a manifest.  ``portable=True`` traces the plain
versions: the program holds ATen and higher-order ops only, so
``torch.export.load`` alone loads it, on the CPU or a card.
``portable=False`` keeps the kernels as their custom ops (``atk::tokenize``
or ``atk::vq_argmin``, ``atk::lstm_fwd``, ``atk::flash_fwd``): the fastest
program, for the exporting device type, loaded after the ops are
registered (importing this package registers them).  ``load_serving``
returns the callable program and the manifest.  From a shell:

    python -m audio_tokens_tpu_torch.export --out DIR [--batch 64]
        [--checkpoint no-wandb-best] [--portable true] [--device cuda:0]
        <config flags>

``ServingProgram.serve_sharded`` splits a batch over the ranks of a mesh
(one process a card) and gathers the answers.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.export.passes import move_to_device_pass

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.models import get_model, model_input_kind
from audio_tokens_tpu_torch.ops.mel import decode_wire
from audio_tokens_tpu_torch.parallel.mesh import data_axis
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer
from audio_tokens_tpu_torch.train.checkpoint import load_params
from audio_tokens_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

MANIFEST_NAME = "serving.json"
PROGRAM_NAME = "serving.pt2"


def _portable_config(config: AudioTokensConfig) -> AudioTokensConfig:
    """The config of a program without kernels: bert's plain attention
    (JAX ``_portable_config``)."""
    return dataclasses.replace(config, transformer_attention="xla")


class ServingModule(nn.Module):
    """The serving program as one module, the one definition that
    ``ServingProgram.serve`` runs and ``export_serving`` traces:
    (padded_batch (B, >= padded_len) f32 or int16, lengths (B,) int) on the
    module's device -> (tokens (B, frames_max) int32, n_valid (B,) int32,
    probs (B, C) f32)."""

    def __init__(self, config: AudioTokensConfig, tokenizer: FusedTokenizer,
                 model: nn.Module):
        super().__init__()
        self.config = config
        self.tokenizer = tokenizer
        self.model = model
        self.input_kind = model_input_kind(config)

    def forward(self, padded_batch: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.config
        with span("serve.tokenize"):
            padded_batch = decode_wire(padded_batch)
            # clamp before any consumer: normalized()'s valid-frame mask
            # would otherwise count padding frames for clips longer than the
            # window
            lengths = torch.clamp(lengths.to(torch.int32),
                                  max=cfg.clip_samples)
            norm_lengths = lengths if cfg.normalize else None
            tokens = self.tokenizer._tokens_dispatch(padded_batch,
                                                     norm_lengths)
            n_valid = self.tokenizer.frontend.frame_counts(lengths)
        with span("serve.classify"):
            T = cfg.max_seq_len
            seq_lens = torch.clamp(n_valid, max=T)
            if self.input_kind == "tokens":
                frames_max = tokens.shape[1]
                if frames_max >= T:
                    x = tokens[:, :T]
                else:
                    x = F.pad(tokens, (0, T - frames_max))
                # zero (= pad token, reference compat) past each clip's frames
                pos = torch.arange(T, device=tokens.device)[None, :]
                x = torch.where(pos < seq_lens[:, None], x, 0)
            else:
                frontend = self.tokenizer.frontend
                if cfg.normalize:
                    mel = frontend.normalized(padded_batch,
                                              lengths).transpose(1, 2)
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


class ServingProgram:
    """(padded_batch (B, >= padded_len) f32 or int16, lengths (B,) int) ->
    tokens (B, frames_max) int32, n_valid (B,) int32, probs (B, C) f32."""

    def __init__(self, config: AudioTokensConfig,
                 checkpoint_name: str = "no-wandb-best", *,
                 device: torch.device | str = "cuda:0",
                 use_kernels: bool = True):
        """Centroids from ``config.centroids_path``, weights from the
        checkpoint ``checkpoint_name`` under ``config.checkpoint_dir``."""
        device = torch.device(device)
        if not use_kernels:
            config = _portable_config(config)
        self._wire(config, FusedTokenizer.from_artifacts(config, device,
                                                         use_kernels),
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
        ``config.random_seed``).  The tokenizer's ``use_kernels`` is the
        program's."""
        device = torch.device(device)
        if tokenizer.device != device:
            raise ValueError(f"tokenizer on {tokenizer.device}, program on "
                             f"{device}")
        if not tokenizer.use_kernels:
            config = _portable_config(config)
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
        self.model = get_model(config, device, generator,
                               tokenizer.use_kernels).eval()
        self.module = ServingModule(config, tokenizer, self.model).eval()

    @torch.inference_mode()
    def serve(self, padded_batch: torch.Tensor, lengths: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        with span("serve.h2d"):
            padded_batch = padded_batch.to(self.device)
            lengths = lengths.to(self.device)
        return self.module(padded_batch, lengths)

    def __call__(self, padded_batch, lengths):
        return self.serve(padded_batch, lengths)

    @torch.inference_mode()
    def serve_sharded(self, padded_batch: torch.Tensor, lengths: torch.Tensor,
                      mesh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``serve`` with the batch split over the ranks of ``mesh``
        (``parallel/mesh``'s ``Mesh``, its data axis, or a ``DataGroup``:
        one process a card, so the mesh is the process group).  Every rank
        passes the whole batch, serves its contiguous rows (the kernels of
        ``serve``, no collective in the compute) and gathers the three
        outputs in rank order: every rank returns the whole batch's
        (tokens, n_valid, probs), equal to ``serve`` in one process.  A
        mesh of one rank is ``serve``."""
        group = data_axis(mesh)
        b = padded_batch.shape[0]
        if b % group.size:
            raise ValueError(f"batch {b} not divisible by data={group.size}")
        if group.size == 1:
            return self.serve(padded_batch, lengths)
        lo, hi = group.row_bounds(b)
        out = self.serve(padded_batch[lo:hi], lengths[lo:hi])
        return tuple(group.all_gather(t, 0) for t in out)

    def predict_waveforms(self, waves) -> Tuple[list, np.ndarray]:
        """Host convenience: trimmed per-clip tokens + probs (numpy)."""
        batch, lengths = self.tokenizer.frontend.prepare_batch(waves)
        tokens, n_valid, probs = self.serve(torch.from_numpy(batch),
                                            torch.from_numpy(lengths))
        tokens, n_valid = tokens.cpu().numpy(), n_valid.cpu().numpy()
        out = [tokens[i, : n_valid[i]].astype(np.int64)
               for i in range(len(waves))]
        return out, probs.cpu().numpy()


def _graph_ops(program: torch.export.ExportedProgram,
               namespace: str = "atk::") -> list:
    """Sorted names of the ops of ``namespace`` (the ``atk::`` custom ops,
    or the ``profiler::`` ops a traced span would leave) anywhere in the
    program's graphs (a scan's body included)."""
    names = set()
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                schema = getattr(node.target, "_schema", None)
                if schema is not None and schema.name.startswith(namespace):
                    names.add(schema.name)
    return sorted(names)


def export_serving(config: AudioTokensConfig, out_dir, batch_size: int = 64,
                   checkpoint_name: str = "no-wandb-best",
                   portable: bool = True, *,
                   device: torch.device | str = "cuda:0") -> Path:
    """Trace the serving program of ``config``'s artifacts on ``device`` at
    (batch_size, padded_len) f32 waveforms and (batch_size,) int32 lengths,
    and save it with its manifest into ``out_dir``.  ``portable=True``
    traces the plain versions (no custom op: the artifact runs on the CPU
    and on a card); ``portable=False`` the kernels' ops (the artifact runs
    on ``device``'s type)."""
    device = torch.device(device)
    prog = ServingProgram(config, checkpoint_name, device=device,
                          use_kernels=not portable)
    frontend = prog.tokenizer.frontend
    args = (torch.zeros((batch_size, frontend.padded_len),
                        dtype=torch.float32, device=device),
            torch.full((batch_size,), config.clip_samples,
                       dtype=torch.int32, device=device))
    with torch.no_grad():
        program = torch.export.export(prog.module, args, strict=False)
    # the zeros it was traced on are no part of the program (56 MB at batch
    # 64); the manifest gives the input shapes
    program.example_inputs = None
    custom_ops = _graph_ops(program)
    if portable and custom_ops:
        raise AssertionError(f"a portable program holds {custom_ops}")
    if _graph_ops(program, "profiler::"):  # spans stay out of the program
        raise AssertionError(f"the program holds "
                             f"{_graph_ops(program, 'profiler::')}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, out_dir / PROGRAM_NAME)
    manifest = {
        "format": "torch.export.save",
        "platforms": ["cpu", "cuda"] if portable else [device.type],
        "portable": portable,
        "batch_size": batch_size,
        "alloc_len": int(frontend.padded_len),
        "inputs": {
            "padded_batch": ["float32", [batch_size, int(frontend.padded_len)]],
            "lengths": ["int32", [batch_size]],
        },
        "outputs": ["tokens int32 (B, frames_max)", "n_valid int32 (B,)",
                    "probs float32 (B, num_classes)"],
        "sample_rate": config.common_sr,
        "clip_samples": int(config.clip_samples),
        "hop_length": config.hop_length,
        "n_fft": config.n_fft,
        "n_mels": config.n_mels,
        "frames_max": int(frontend.frames_max),
        "padded_len": int(frontend.padded_len),
        "vocab_size": config.vocab_size,
        "num_classes": config.num_classes,
        "model_type": config.model_type,
        "checkpoint": checkpoint_name,
        "custom_ops": custom_ops,
        # class index -> label name, so that a serving host renders
        # predictions without this package or the ontology files
        "class_names": _class_names(config),
    }
    (out_dir / MANIFEST_NAME).write_text(json.dumps(manifest, indent=2))
    logger.info("exported serving program (%d bytes, ops %s) to %s",
                (out_dir / PROGRAM_NAME).stat().st_size, custom_ops, out_dir)
    return out_dir


def _class_names(config: AudioTokensConfig):
    """index -> label-name list (``metadata.load_class_names``); None when
    the ontology is unavailable."""
    try:
        from audio_tokens_tpu_torch.data.metadata import load_class_names

        return load_class_names(config)
    except Exception as e:  # metadata optional for serving artifacts
        logger.info("class names omitted from manifest (%s)", e)
        return None


def load_serving(out_dir, device: torch.device | str = "cuda:0"
                 ) -> Tuple[nn.Module, dict]:
    """(program, manifest) from ``export_serving``'s ``out_dir``, the
    program moved to ``device``: ``program(padded_batch, lengths)`` ->
    (tokens, n_valid, probs) at the manifest's input shapes.  A kernel-form
    program loads only onto its exporting device type; its ops are
    registered by this module's imports."""
    out_dir = Path(out_dir)
    device = torch.device(device)
    manifest = json.loads((out_dir / MANIFEST_NAME).read_text())
    if device.type not in manifest["platforms"]:
        raise ValueError(f"the program at {out_dir} runs on "
                         f"{manifest['platforms']}, not {device}")
    program = torch.export.load(out_dir / PROGRAM_NAME)
    program = move_to_device_pass(program, device)
    module = program.module()
    for p in module.parameters():  # serving records no autograd graph
        p.requires_grad_(False)
    return module, manifest


def main(argv: Optional[Sequence[str]] = None) -> Path:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--checkpoint", default="no-wandb-best")
    parser.add_argument("--portable", default="true",
                        choices=("true", "false"))
    parser.add_argument("--device", default="cuda:0")
    args, rest = parser.parse_known_args(argv)
    cfg = AudioTokensConfig.from_args(rest)
    return export_serving(cfg, args.out, args.batch, args.checkpoint,
                          portable=args.portable == "true",
                          device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
