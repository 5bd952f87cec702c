"""Stage 1: audio files -> per-clip mel-spectrogram ``.npy`` artifacts.

Counterpart of the staged path of
``audio_tokens_tpu/processors/spectrogram_generator.py``, with the same
artifact contract (reference: processors/spectrogram_generator.py:39-61):
``{dest_spec_path}/{split}/{ytid}.npy`` each holding a float32
``(n_mels, frames)`` array, trimmed to the clip's valid frames; output dirs
are wiped per run (or, with ``incremental=True``, kept and completed under
a ``_signature.json`` of the signal chain); missing, undecodable, non-finite
or extreme-amplitude clips are skipped with a log line; NaN/Inf
spectrograms and, under ``normalize=True``, constant ones are dropped.

Clips are decoded on the host (a thread pool, bounded decode-ahead), packed
into ``device_batch_size`` padded batches and sent through the port's
``MelFrontend`` on the stage's device (``cuda:0`` unless the caller passes
another), or its per-clip min-max ``.normalized`` under ``normalize=True``.

Not ported: the native C++ decoder (``audio_backend='native'``, ROADMAP A6;
``'auto'`` takes the python decode), the decode-only wave batches of the
fused mode (``iter_wave_batches``, ROADMAP A3), stage traces
(``profile_dir``) and multi-process runs (ROADMAP A7).
"""

from __future__ import annotations

import json
import logging
import shutil
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.data.audio_io import decode_clip, find_audio_file
from audio_tokens_tpu_torch.ops.mel import MelFrontend, num_frames
from audio_tokens_tpu_torch.utils.npy_io import atomic_save_npy
from audio_tokens_tpu_torch.utils.profiling import StageTimer, maybe_trace

logger = logging.getLogger(__name__)

# Waveform amplitude sanity bound (the JAX stage's AMPLITUDE_LIMIT): a finite
# waveform with |s| ~ 1e17 overflows f32 in |spec|^2; sane decoded audio is
# |s| <= ~1, overflow needs |s| > ~3e16.
AMPLITUDE_LIMIT = 1e8


def refuse_multiprocess(config: AudioTokensConfig) -> None:
    """The stages run in one process on one device."""
    if config.distributed:
        raise NotImplementedError(
            "distributed=True (multi-process stages) is not ported yet: "
            "ROADMAP A7")


class SpectrogramGenerator:
    def __init__(self, config: AudioTokensConfig,
                 device: Optional[torch.device | str] = None):
        if config.audio_backend == "native":
            raise NotImplementedError(
                "audio_backend='native' (the C++ decoder) is not ported yet: "
                "ROADMAP A6; 'auto' takes the python decode")
        refuse_multiprocess(config)
        self.config = config
        self.device = torch.device("cuda", 0) if device is None else \
            torch.device(device)
        self.frontend = MelFrontend(
            self.device,
            sample_rate=config.common_sr,
            n_mels=config.n_mels,
            n_fft=config.n_fft,
            hop_length=config.hop_length,
            clip_samples=config.clip_samples,
        )
        with open(config.split_file, "r") as f:
            self.data_split = json.load(f)

    def _signature(self) -> dict:
        """Signal-chain signature persisted next to each split's artifacts:
        every config field that changes the VALUES in a spectrogram (the
        JAX stage's fields, so either package reads the other's corpus as
        current).  ``incremental=True`` runs re-render the whole split when
        the stored signature mismatches."""
        cfg = self.config
        return {
            "common_sr": cfg.common_sr,
            "n_mels": cfg.n_mels,
            "n_fft": cfg.n_fft,
            "hop_length": cfg.hop_length,
            "normalize": bool(cfg.normalize),
            "clip_samples": cfg.clip_samples,
            "pcm_wire": cfg.pcm_wire,
        }

    SIGNATURE_NAME = "_signature.json"

    def _write_signature(self, output_dir: Path) -> None:
        tmp = output_dir / (self.SIGNATURE_NAME + ".tmp")
        tmp.write_text(json.dumps(self._signature(), sort_keys=True))
        tmp.replace(output_dir / self.SIGNATURE_NAME)

    def run(self) -> None:
        for split in ["train", "validation"]:
            logger.info("Creating %s spectrograms", split)
            output_dir = Path(self.config.dest_spec_path) / split
            ytids = self.data_split[split]
            if self.config.incremental:
                output_dir.mkdir(parents=True, exist_ok=True)
                sig_path = output_dir / self.SIGNATURE_NAME
                try:
                    stored = json.loads(sig_path.read_text())
                except (FileNotFoundError, json.JSONDecodeError):
                    stored = None
                has_artifacts = any(output_dir.glob("*.npy"))
                if (stored == self._signature() or not has_artifacts
                        or stored is None):
                    # artifacts without a signature predate it: adopt them
                    # under the current config; only a RECORDED mismatching
                    # signature proves staleness
                    if stored != self._signature():
                        self._write_signature(output_dir)
                    before = len(ytids)
                    ytids = [y for y in ytids
                             if not (output_dir / f"{y}.npy").exists()]
                    logger.info("incremental: %d/%d clips already done",
                                before - len(ytids), before)
                else:
                    logger.info(
                        "incremental: signal-chain signature changed "
                        "(%s -> %s); re-rendering the whole %s split",
                        stored, self._signature(), split)
                    shutil.rmtree(output_dir, ignore_errors=True)
                    output_dir.mkdir(parents=True)
                    self._write_signature(output_dir)
            else:  # reference semantics: destructive restart
                shutil.rmtree(output_dir, ignore_errors=True)
                output_dir.mkdir(parents=True)
                self._write_signature(output_dir)
            with maybe_trace(self.config.profile_dir), \
                    StageTimer(f"spectrograms/{split}") as timer:
                n_ok = self.populate_specs(ytids, output_dir)
                timer.count("clips", n_ok)
            logger.info("%s: %d/%d spectrograms saved to %s",
                        split.capitalize(), n_ok, len(ytids), output_dir)

    # ------------------------------------------------------------------
    def populate_specs(self, ytids: List[str], output_dir: Path) -> int:
        """Decode (threaded) -> batch -> device frontend -> save. Returns count."""
        n_ok = 0
        for ytid, spec in self.iter_specs(ytids):
            atomic_save_npy(output_dir / f"{ytid}.npy", spec)
            n_ok += 1
        return n_ok

    def iter_specs(self, ytids: List[str]):
        """Yield (ytid, (n_mels, frames) float32 spec) without touching
        disk, in ``ytids`` order (the frontend math is row-independent, so
        batch composition does not change a clip's spectrogram)."""
        bs = self.config.device_batch_size
        pending: List[Tuple[str, np.ndarray]] = []
        for ytid, wave in self._decoded_waves(ytids):
            pending.append((ytid, wave))
            if len(pending) == bs:
                yield from self._specs_for_batch(pending)
                pending = []
        if pending:
            yield from self._specs_for_batch(pending)

    def _decoded_waves(self, ytids: List[str]):
        """Threaded decode with bounded decode-ahead: yields (ytid, wave)
        for decodable, finite, sane-amplitude clips.  A sliding window of
        in-flight futures keeps O(window) waveforms alive instead of the
        whole corpus."""
        window = max(2 * self.config.device_batch_size,
                     2 * self.config.num_workers)
        with ThreadPoolExecutor(max_workers=self.config.num_workers) as pool:
            inflight: deque = deque()
            it = iter(ytids)
            while True:
                while len(inflight) < window:
                    y = next(it, None)
                    if y is None:
                        break
                    inflight.append((y, pool.submit(self._decode_one, y)))
                if not inflight:
                    break
                ytid, fut = inflight.popleft()
                wave = fut.result()
                if wave is None:
                    continue
                amax = float(np.max(np.abs(wave))) if wave.size else 0.0
                if not np.isfinite(amax) or amax > AMPLITUDE_LIMIT:
                    logger.info("skipping %s: non-finite or extreme samples "
                                "(max |s| = %.3g)", ytid, amax)
                    continue
                yield ytid, wave

    def _decode_one(self, ytid: str) -> Optional[np.ndarray]:
        path = self.find_audio_file(ytid)
        if path is None:
            return None
        return decode_clip(self.config, path)

    def find_audio_file(self, ytid: str) -> Optional[Path]:
        path = find_audio_file(self.config, ytid)
        if path is None:
            logger.debug("Audio file not found: %s", ytid)
        return path

    def _specs_for_batch(self, items: List[Tuple[str, np.ndarray]]):
        """One frontend pass over a padded batch -> (ytid, trimmed spec)."""
        bs = self.config.device_batch_size
        batch, lengths = self.frontend.prepare_batch([w for _, w in items])
        if len(items) < bs:  # pad to the batch shape; extra rows ignored
            pad = np.zeros((bs - len(items), batch.shape[1]), np.float32)
            batch = np.concatenate([batch, pad], axis=0)
            lengths = np.concatenate([lengths, np.zeros(bs - len(items),
                                                        np.int32)])
        x = torch.from_numpy(batch).to(self.device)
        with torch.inference_mode():
            if self.config.normalize:
                specs = self.frontend.normalized(
                    x, torch.from_numpy(lengths).to(self.device))
            else:
                specs = self.frontend(x)
            specs = specs.cpu().numpy()

        for i, (ytid, wave) in enumerate(items):
            n_valid = num_frames(min(len(wave), self.config.clip_samples),
                                 self.config.hop_length)
            spec = specs[i, :, :n_valid]
            if not np.isfinite(spec).all():
                logger.debug("Warning: NaN/Inf values found in spectrogram %s", ytid)
                continue
            if self.config.normalize and spec.size and spec.min() == spec.max():
                # digital silence: the reference's normalize made NaN here
                # and its screen dropped the clip
                logger.debug("skipping %s: constant spectrogram", ytid)
                continue
            yield ytid, spec


if __name__ == "__main__":
    import argparse

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0")
    ns, rest = parser.parse_known_args()
    SpectrogramGenerator(AudioTokensConfig.from_args(rest), ns.device).run()
