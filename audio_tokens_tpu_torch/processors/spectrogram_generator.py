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

Clips are decoded on the host and packed into ``device_batch_size``
padded batches for the port's ``MelFrontend`` on the stage's device
(``cuda:0`` unless the caller passes another), or its per-clip min-max
``.normalized`` under ``normalize=True``.  Two decoders, chosen by
``audio_backend`` (``data/native_loader.select_backend``): the native C++
decoder (``"native"``, and ``"auto"`` where it builds) decodes a batch in
its thread pool straight into the padded layout, in f32 or, under
``pcm_wire="i16"``, as int16 PCM that the frontend reconstructs on the card
(half the host-to-card bytes); rows it cannot decode (length -1) are
skipped and logged.  The python decode (``"python"``) runs a thread pool
of ``decode_clip`` with bounded decode-ahead.  The two differ by up to
1e-7 on WAV (more on resampled clips).  The fused mode reads the same
decode through ``iter_specs`` (specs without files) and
``iter_wave_batches`` (padded waveform batches, no DSP: the clustering
stage's device feed).

Multi-process runs (``parallel/distributed.py``): every rank reads the same
split file and renders its strided shard of each split; rank 0 alone makes,
wipes or re-renders the output dirs and writes the signature, with barriers
around, and every rank waits for every shard before it goes on.

Each batch counts its waveforms up and its spectrograms down on the wire
meter (``utils/profiling.WIRE``); with a ``profile_dir`` each split's
rendering is traced (``utils/profiling.maybe_trace``).
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
from audio_tokens_tpu_torch.data import native_loader
from audio_tokens_tpu_torch.data.audio_io import decode_clip, find_audio_file
from audio_tokens_tpu_torch.ops.mel import MelFrontend, num_frames
from audio_tokens_tpu_torch.parallel import distributed
from audio_tokens_tpu_torch.utils.npy_io import atomic_save_npy
from audio_tokens_tpu_torch.utils.profiling import (WIRE, StageTimer,
                                                    maybe_trace)

logger = logging.getLogger(__name__)

# Waveform amplitude sanity bound (the JAX stage's AMPLITUDE_LIMIT): a finite
# waveform with |s| ~ 1e17 overflows f32 in |spec|^2; sane decoded audio is
# |s| <= ~1, overflow needs |s| > ~3e16.
AMPLITUDE_LIMIT = 1e8


class SpectrogramGenerator:
    def __init__(self, config: AudioTokensConfig,
                 device: Optional[torch.device | str] = None):
        self.config = config
        distributed.maybe_initialize(config)
        self.device = (distributed.default_device() if device is None
                       else torch.device(device))
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
        self.use_native = native_loader.select_backend(config)

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
            coordinator = distributed.is_coordinator()
            if self.config.incremental:
                if coordinator:
                    output_dir.mkdir(parents=True, exist_ok=True)
                distributed.barrier(f"spec-mkdir-{split}")
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
                    if coordinator and stored != self._signature():
                        self._write_signature(output_dir)
                    before = len(ytids)
                    ytids = [y for y in ytids
                             if not (output_dir / f"{y}.npy").exists()]
                    logger.info("incremental: %d/%d clips already done",
                                before - len(ytids), before)
                    # no rank writes before every rank has listed what is
                    # left, or the ranks would shard different lists
                    distributed.barrier(f"spec-todo-{split}")
                else:
                    # every rank read the same file after the barrier, so
                    # every rank decides alike
                    logger.info(
                        "incremental: signal-chain signature changed "
                        "(%s -> %s); re-rendering the whole %s split",
                        stored, self._signature(), split)
                    if coordinator:
                        shutil.rmtree(output_dir, ignore_errors=True)
                        output_dir.mkdir(parents=True)
                        self._write_signature(output_dir)
                    distributed.barrier(f"spec-rerender-{split}")
            else:  # reference semantics: destructive restart (by rank 0)
                if coordinator:
                    shutil.rmtree(output_dir, ignore_errors=True)
                    output_dir.mkdir(parents=True)
                    self._write_signature(output_dir)
                distributed.barrier(f"spec-wipe-{split}")
            local_ytids = distributed.process_shard(ytids)
            with maybe_trace(self.config.profile_dir, self.device), \
                    StageTimer(f"spectrograms/{split}") as timer:
                n_ok = self.populate_specs(local_ytids, output_dir)
                timer.count("clips", n_ok)
            distributed.barrier(f"spec-done-{split}")
            logger.info(
                "%s: %d/%d spectrograms saved to %s%s", split.capitalize(),
                n_ok, len(local_ytids), output_dir,
                f" (rank {distributed.process_index()}'s shard of "
                f"{len(ytids)})" if distributed.is_multiprocess() else "")

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
        if self.use_native:
            yield from self._iter_specs_native(ytids)
            return
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

    def iter_wave_batches(self, ytids: List[str]):
        """Decode-only batches of ``device_batch_size`` rows, in ``ytids``
        order: (padded (B, padded_len) f32 waveforms, lengths (B,) int32,
        row ytids).  Padding rows have length -1 and ytid None.  The same
        decode and screens as ``iter_specs``; no DSP, so the clustering
        stage's device feed sends only waveforms to the card.  Native
        decode: rows it fails or screens out carry length -1, and
        ``pcm_wire="i16"`` ships int16 PCM (the frontend decodes it)."""
        bs = self.config.device_batch_size
        if self.use_native:
            for chunk, batch, lengths in self._native_batches(ytids):
                for r in np.flatnonzero(lengths == -2):
                    lengths[r] = -1  # screened above, logged there
                row_ytids = [y for y, _ in chunk] + [None] * (bs - len(chunk))
                yield batch, lengths, row_ytids
            return

        def flush(waves, wave_ytids):
            batch, lengths = self.frontend.prepare_batch(waves)
            pad = bs - len(waves)
            if pad:
                batch = np.concatenate(
                    [batch, np.zeros((pad, batch.shape[1]), np.float32)])
                lengths = np.concatenate(
                    [lengths, np.full(pad, -1, np.int32)])
            return batch, lengths, wave_ytids + [None] * pad

        waves: List[np.ndarray] = []
        wave_ytids: List[str] = []
        for ytid, wave in self._decoded_waves(ytids):
            waves.append(wave)
            wave_ytids.append(ytid)
            if len(waves) == bs:
                yield flush(waves, wave_ytids)
                waves, wave_ytids = [], []
        if waves:
            yield flush(waves, wave_ytids)

    def _native_batches(self, ytids: List[str]):
        """The native decode of ``ytids`` (those with a file) in
        ``device_batch_size`` chunks -> (chunk of (ytid, path), padded
        batch (bs rows; f32, or int16 under ``pcm_wire="i16"``), lengths):
        padding rows and failed decodes have length -1, f32 rows with
        non-finite or extreme samples -2 (logged here; int16 PCM is safe
        by construction)."""
        cfg = self.config
        bs = cfg.device_batch_size
        found = [(y, p) for y in ytids
                 if (p := self.find_audio_file(y)) is not None]
        dtype = np.int16 if cfg.pcm_wire == "i16" else np.float32
        for i in range(0, len(found), bs):
            chunk = found[i : i + bs]
            batch, lengths = native_loader.decode_batch(
                [p for _, p in chunk], cfg.common_sr, cfg.clip_samples,
                cfg.n_fft, n_threads=cfg.num_workers, dtype=dtype)
            if len(chunk) < bs:  # keep the batch shape
                batch = np.concatenate([batch, np.zeros(
                    (bs - len(chunk), batch.shape[1]), batch.dtype)])
                lengths = np.concatenate(
                    [lengths, np.full(bs - len(chunk), -1, np.int32)])
            if batch.dtype == np.float32:
                amax = np.abs(batch).max(axis=1)
                for r in np.flatnonzero(
                        (~np.isfinite(amax) | (amax > AMPLITUDE_LIMIT))
                        & (lengths >= 0)):
                    logger.info("skipping %s: non-finite or extreme "
                                "samples", chunk[r][1])
                    lengths[r] = -2
            for r in np.flatnonzero(lengths[:len(chunk)] == -1):
                logger.info("skipping %s: %s", chunk[r][1],
                            native_loader.last_error())
            yield chunk, batch, lengths

    def _iter_specs_native(self, ytids: List[str]):
        """``iter_specs`` over the native decode: one frontend pass a
        batch, decoded rows only, with the python route's spectrogram
        screens."""
        cfg = self.config
        for chunk, batch, lengths in self._native_batches(ytids):
            x = torch.from_numpy(batch).to(self.device)
            with torch.inference_mode():
                if cfg.normalize:
                    specs = self.frontend.normalized(
                        x, torch.from_numpy(np.maximum(lengths, 0)).to(
                            self.device))
                else:
                    specs = self.frontend(x)
                specs = specs.cpu().numpy()
            WIRE.h2d(batch)  # wave batch up / mel batch down: the staged
            WIRE.d2h(specs)  # stage's wire (the fused mode has no d2h)
            for row, (ytid, _) in enumerate(chunk):
                if lengths[row] < 0:  # failed or screened, logged
                    continue
                n_valid = num_frames(int(lengths[row]), cfg.hop_length)
                spec = specs[row, :, :n_valid]
                if not np.isfinite(spec).all():
                    logger.debug("Warning: NaN/Inf values found in "
                                 "spectrogram %s", ytid)
                    continue
                if cfg.normalize and spec.size and spec.min() == spec.max():
                    logger.debug("skipping %s: constant spectrogram", ytid)
                    continue
                yield ytid, spec

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
        WIRE.h2d(batch)
        WIRE.d2h(specs)

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
    parser.add_argument("--device", default=None,
                        help="default: this rank's card (cuda:0 in one "
                        "process)")
    ns, rest = parser.parse_known_args()
    SpectrogramGenerator(AudioTokensConfig.from_args(rest), ns.device).run()
