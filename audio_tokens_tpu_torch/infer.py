"""Single-clip inference: wav file -> top-k label predictions (counterpart of
``audio_tokens_tpu/infer.py``).

``Predictor`` loads the pipeline's artifacts (centroids and a trained
checkpoint) and answers one waveform at a time in two steps with the host
between them, as the JAX one does: the tokenizer (kernel B1 on a card, or
the mel frontend and B2 with ``config.normalize``) gives the clip's tokens,
which come to the host; the classifier's input is assembled there and goes
back to the device.  Token classifiers see the valid tokens zero-padded to
``max_seq_len``; spec and flat classifiers see the clip's mel frames
(min-max normalized when ``config.normalize``) copied into a zero buffer of
``max_seq_len`` frames.  ``ServingProgram`` computes the same answer in one
call.  ``ManualTester`` prints the reference's report: the top-k classes
with their scores, ``*`` marking the clip's true labels.

Runs on ``cuda:0`` unless another device is given; without a card it fails
rather than run somewhere else.  From a shell:

    python -m audio_tokens_tpu_torch.infer --ytid YTID [--top_k 30] \\
        [--checkpoint no-wandb-best] [--device cpu] <config flags>
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.data.audio_io import decode_audio, find_audio_file
from audio_tokens_tpu_torch.data.metadata import AudiosetMetadataProcessor
from audio_tokens_tpu_torch.models import get_model, model_input_kind
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer
from audio_tokens_tpu_torch.train.checkpoint import load_params


class Predictor:
    """wav -> (token sequence, per-class probabilities)."""

    def __init__(self, config: AudioTokensConfig,
                 checkpoint_name: str = "no-wandb-best",
                 device: torch.device | str = "cuda:0"):
        self.config = config
        self.device = torch.device(device)
        self.tokenizer = FusedTokenizer.from_artifacts(config, self.device)
        self.input_kind = model_input_kind(config)
        self.model = get_model(
            config, self.device,
            torch.Generator().manual_seed(config.random_seed)).eval()
        load_params(config.checkpoint_dir, checkpoint_name, self.model)

    def _inputs(self, wave: np.ndarray, tokens: np.ndarray) -> np.ndarray:
        """The classifier's (1, ...) input for one clip, on the host."""
        T = self.config.max_seq_len
        if self.input_kind == "tokens":
            inputs = np.zeros((1, T), np.int32)
            inputs[0, : min(len(tokens), T)] = tokens[:T]
            return inputs
        frontend = self.tokenizer.frontend
        batch, wav_lens = frontend.prepare_batch([wave])
        batch = torch.from_numpy(batch).to(self.device)
        if self.config.normalize:  # the spec artifacts' scaling
            mel = frontend.normalized(
                batch, torch.from_numpy(wav_lens).to(self.device))[0].T
        else:
            mel = frontend.mel_frames(batch)[0]  # (T', M)
        mel = mel.cpu().numpy()
        buf = np.zeros((T, self.config.n_mels), np.float32)
        n = min(len(mel), T)
        buf[:n] = mel[:n]
        return buf.reshape(1, -1) if self.input_kind == "flat" else buf[None]

    @torch.inference_mode()
    def predict_waveform(self, wave: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens (n_valid,) int64, probs (num_classes,) float32)."""
        tokens = self.tokenizer.tokenize_waveforms([wave])[0]
        inputs = torch.from_numpy(self._inputs(wave, tokens)).to(self.device)
        lengths = torch.tensor([min(len(tokens), self.config.max_seq_len)],
                               dtype=torch.int32, device=self.device)
        logits = self.model(
            inputs, lengths=None if self.config.reference_compat else lengths)
        return tokens, torch.sigmoid(logits[0]).cpu().numpy()

    def predict_file(self, path) -> Tuple[np.ndarray, np.ndarray]:
        wave, _ = decode_audio(path, target_sr=self.config.common_sr)
        return self.predict_waveform(wave)


class ManualTester:
    """Reference-shaped report: ranked predictions annotated with truth."""

    def __init__(self, config: AudioTokensConfig,
                 checkpoint_name: str = "no-wandb-best",
                 device: torch.device | str = "cuda:0"):
        self.config = config
        self.metadata = AudiosetMetadataProcessor(config)
        self.predictor = Predictor(config, checkpoint_name, device)

    def find_audio_file(self, ytid: str) -> Optional[Path]:
        return find_audio_file(self.config, ytid)

    def run(self, ytid: str, top_k: int = 30) -> List[dict]:
        path = self.find_audio_file(ytid)
        if path is None:
            raise FileNotFoundError(f"no audio for ytid {ytid}")
        tokens, probs = self.predictor.predict_file(path)
        true_labels = set(self.metadata.get_ytid_labels(ytid))

        order = np.argsort(-probs)[:top_k]
        rows = []
        for rank, idx in enumerate(order, start=1):
            label_id = self.metadata.index_label.get(int(idx), "?")
            rows.append({
                "rank": rank,
                "class_index": int(idx),
                "score": float(probs[idx]),
                "name": self.metadata.label_name.get(label_id, label_id),
                "is_true": int(idx) in true_labels,
            })
        self._print(ytid, tokens, rows)
        return rows

    @staticmethod
    def _print(ytid: str, tokens: np.ndarray, rows: List[dict]) -> None:
        print(f"ytid: {ytid}  ({len(tokens)} tokens)")
        for r in rows:
            star = "*" if r["is_true"] else " "
            print(f"{star} {r['rank']:>3}  {r['score']:.4f}  {r['name']}")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ytid", required=True)
    parser.add_argument("--top_k", type=int, default=30)
    parser.add_argument("--checkpoint", default="no-wandb-best")
    parser.add_argument("--device", default="cuda:0")
    args, rest = parser.parse_known_args()
    config = AudioTokensConfig.from_args(rest)
    ManualTester(config, args.checkpoint, args.device).run(args.ytid,
                                                            args.top_k)
