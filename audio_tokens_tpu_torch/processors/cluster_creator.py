"""Stage 2: cluster training-set STFT frames into a centroid vocabulary.

Counterpart of ``audio_tokens_tpu/processors/cluster_creator.py``, with the
same artifact contract (reference: processors/cluster_creator.py:36-62):
reads ``{source_spec_path}/train/*.npy`` in sorted order, writes
L2-normalized ``centroids.npy`` (f32 ``x / (||x|| + 1e-10)`` rows, shape
``(vocab_size, feature_dim)``) and, where matplotlib is installed, a 2-D
PCA scatter at ``output/centroids_visualization.png``.

The fit is ``ops/kmeans.py`` on the stage's device (``cuda:0`` unless the
caller passes another).  Two modes (``config.kmeans_mode``):

  * ``batch_warm_start`` (the default) — the reference's schedule: each
    ``clustering_batch_size``-file batch, L2-normalized on the device,
    re-trains ``niter`` Lloyd iterations from the previous batch's
    centroids;
  * ``full`` — one Lloyd fit over every frame: held in device memory, or,
    when the frames exceed ``kmeans_inmemory_budget_mb`` (or
    ``kmeans_streaming='always'``), ``kmeans_fit_streaming`` over a host
    stream of the files (L2-normalized on the host, so the stream is the
    same on any device) with its device, host and disk caches, its wire
    (``kmeans_wire``), a seeded init from a sample of the whole train list,
    and a checkpoint after every iteration
    (``centroids_path`` + ``.kmeans_ckpt.npz``) that an ``incremental``
    rerun resumes bit-equal to an uninterrupted fit.

Under ``fused_pipeline=True`` no spectrogram file exists: the same frames
come from the audio through ``SpectrogramGenerator.iter_specs`` (clips in
sorted order, as the files), or, in ``full`` mode when the whole corpus
fits ``kmeans_hbm_cache_mb``, from the device feed
(``_fused_frames_device``): waveforms go to the device, where mel frames,
L2 normalization and the valid-row prefix land in one preallocated buffer
that the fit reads as a view and ``take_resident_frames`` hands to the
tokenize stage.

``use_convolution``: every route widens the frames with the conv front-end
(``make_conv_features``, weights from ``(random_seed, "conv_features")``)
before the L2 normalization on the stage's device, as the JAX stage does:
in the staged batches, the device feed, and the streaming fit's stream and
its init sample (whose rows then come back to the host); the weights are
saved beside the centroids as ``<centroids>.conv.npz`` for the tokenize
stage and serving.
``kmeans_precision`` is the Lloyd tier (``ops/kmeans.precision_from_str``).

Not ported, and refused with ``NotImplementedError``: multi-process runs and
stage traces (ROADMAP A7).
"""

from __future__ import annotations

import io
import json
import logging
import zipfile
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.ops.conv_features import ConvFeatures
from audio_tokens_tpu_torch.ops.kmeans import (
    DEFAULT_CHUNK,
    WIRES,
    KMeans,
    kmeans_fit,
    kmeans_fit_streaming,
    kmeans_plusplus_init,
    precision_from_str,
)
from audio_tokens_tpu_torch.ops.mel import MelFrontend, num_frames
from audio_tokens_tpu_torch.ops.vq import l2_normalize
from audio_tokens_tpu_torch.processors.spectrogram_generator import (
    SpectrogramGenerator,
    refuse_multiprocess,
)
from audio_tokens_tpu_torch.utils.npy_io import atomic_save_bytes
from audio_tokens_tpu_torch.utils.seeding import set_seed

logger = logging.getLogger(__name__)


def make_conv_features(config: AudioTokensConfig,
                       device: torch.device | str = "cpu"
                       ) -> Optional[ConvFeatures]:
    """The conv front-end the cluster and tokenize stages share (its
    weights drawn from ``(random_seed, "conv_features")``), or None."""
    if not config.use_convolution:
        return None
    return ConvFeatures(config.num_kernels, config.kernel_size,
                        config.random_seed, device)


class ClusterCreator:
    def __init__(self, config: AudioTokensConfig,
                 device: Optional[torch.device | str] = None):
        refuse_multiprocess(config)
        precision_from_str(config.kmeans_precision)
        self.config = config
        self.device = torch.device("cuda", 0) if device is None else \
            torch.device(device)
        self.conv = make_conv_features(config, self.device)
        self._stream_sig: Optional[str] = None
        self._gen: Optional[SpectrogramGenerator] = None
        self.resident_frames: Optional[torch.Tensor] = None
        self.resident_manifest: Optional[dict] = None
        set_seed(config.random_seed)

    def run(self) -> np.ndarray:
        logger.info("starting clustering (mode=%s)", self.config.kmeans_mode)
        cfg = self.config
        # the fused device feed goes first: it fits the device budget even
        # where the host budget would stream
        self.used_device_feed = (cfg.kmeans_mode == "full"
                                 and self._use_fused_device_feed())
        if (cfg.kmeans_mode == "full" and not self.used_device_feed
                and self._should_stream()):
            centroids = self._fit_streaming()
        elif cfg.kmeans_mode == "full":
            n_valid = None
            if self.used_device_feed:  # the fit reads the buffer in place
                frames, n_valid = self._fused_frames_device()
            else:
                frames = torch.cat(list(self._batch_generator(
                    cfg.clustering_batch_size)))
            centroids, obj = kmeans_fit(
                frames,
                cfg.vocab_size,
                cfg.niter,
                seed=cfg.random_seed,
                max_points_per_centroid=cfg.max_points_per_centroid,
                init=cfg.kmeans_init,
                empty_policy=cfg.kmeans_empty_policy,
                precision=cfg.kmeans_precision,
                n_valid=n_valid,
            )
            logger.info("full kmeans over %d frames: obj=%.2f",
                        n_valid or frames.shape[0], obj)
            del frames
        else:  # batch_warm_start (reference schedule)
            km = KMeans(
                self.feature_dim,
                cfg.vocab_size,
                niter=cfg.niter,
                seed=cfg.random_seed,
                max_points_per_centroid=cfg.max_points_per_centroid,
                init=cfg.kmeans_init,
                empty_policy=cfg.kmeans_empty_policy,
                precision=cfg.kmeans_precision,
                device=self.device,
            )
            for i, batch in enumerate(
                    self._batch_generator(cfg.clustering_batch_size)):
                if i == 0:
                    km.train(batch)
                else:
                    km.train(batch, init_centroids=km.centroids)
            centroids = km.centroids
            if centroids is None:
                raise RuntimeError("no training spectrograms found")

        centroids = l2_normalize(torch.as_tensor(centroids)).cpu().numpy()
        logger.info("Centroids shape: %s", centroids.shape)
        out_path = Path(cfg.centroids_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        np.save(out_path, centroids)
        if self.conv is not None:
            self.conv.save_npz(out_path.with_suffix(".conv.npz"))
        # the artifact exists: the streaming fit's checkpoint has served
        self._kmeans_ckpt_path().unlink(missing_ok=True)
        self.visualize_centroids(centroids)
        return centroids

    @property
    def feature_dim(self) -> int:
        return self.config.feature_dim

    def _should_stream(self) -> bool:
        """Whether full-mode k-means would need the streaming fit: the JAX
        stage's rule (spectrogram bytes on disk, or under the fused mode
        every train clip at its most frames, against
        ``kmeans_inmemory_budget_mb``, or the subsample's bytes when
        ``max_points_per_centroid`` caps the fit)."""
        mode = self.config.kmeans_streaming
        if mode in ("always", "never"):
            return mode == "always"
        if mode != "auto":
            raise ValueError(f"unknown kmeans_streaming '{mode}'")
        budget = self.config.kmeans_inmemory_budget_mb * (1 << 20)
        if self.config.max_points_per_centroid is not None:
            cap_bytes = (self.config.vocab_size
                         * self.config.max_points_per_centroid
                         * self.feature_dim * 4)
            if cap_bytes <= budget:
                return False
        if self.config.fused_pipeline:
            est = (self._n_train_clips() * self.config.frames_per_clip
                   * self.feature_dim * 4)
        else:
            spec_dir = Path(self.config.source_spec_path) / "train"
            est = sum(f.stat().st_size for f in spec_dir.glob("*.npy"))
            est *= self.feature_dim // self.config.n_mels  # the conv's width
        if est > budget:
            logger.info(
                "full kmeans: ~%.1f GB of frames exceeds the %.1f GB in-memory "
                "budget", est / 2**30, budget / 2**30)
            return True
        return False

    def _train_files(self) -> list:
        spec_dir = Path(self.config.source_spec_path) / "train"
        files = sorted(spec_dir.glob("*.npy"))
        if not files:
            raise FileNotFoundError(f"no spectrograms under {spec_dir}")
        return files

    def _file_frames(self, batch_size: int) -> Iterator[np.ndarray]:
        """(frames, n_mels) f32 matrices, per ``batch_size`` files in
        sorted order — the reference's frame pipeline (:83-102); under the
        fused mode the same frames from the audio."""
        if self.config.fused_pipeline:
            yield from self._fused_file_frames(batch_size)
            return
        files = self._train_files()
        for i in range(0, len(files), batch_size):
            yield np.concatenate(
                [np.load(f).T for f in files[i : i + batch_size]],
                axis=0).astype(np.float32)

    def _fused_file_frames(self, batch_size: int) -> Iterator[np.ndarray]:
        """The fused mode's host-mediated frames: ``iter_specs`` over the
        sorted train clips (the spectrogram files' order), per
        ``batch_size`` decodable clips.  ``_batch_generator`` normalizes
        them on the device, ``_host_batches`` on the host (the streaming
        fit, which calls this once an iteration)."""
        gen = self._spec_gen()
        specs: list = []
        produced = False
        for _, spec in gen.iter_specs(sorted(gen.data_split["train"])):
            specs.append(spec.T)
            if len(specs) == batch_size:
                produced = True
                yield np.concatenate(specs, axis=0).astype(np.float32)
                specs = []
        if specs:
            produced = True
            yield np.concatenate(specs, axis=0).astype(np.float32)
        if not produced:
            raise FileNotFoundError("no decodable training audio under "
                                    f"{self.config.audio_source_path}")

    def _spec_gen(self) -> SpectrogramGenerator:
        """The fused mode's decode and mel frontend, made once a stage."""
        if self._gen is None:
            self._gen = SpectrogramGenerator(self.config, self.device)
        return self._gen

    # -- the fused device feed and the resident-frames handoff -------------

    def _use_fused_device_feed(self) -> bool:
        """Whether the full-mode fit takes the device feed
        (``_fused_frames_device``): the JAX stage's rule — fused mode, no
        min-max normalization (its constant-clip screen runs on the host),
        not ``kmeans_streaming='always'`` (an explicit bound on device
        memory), and the feed's capacity buffer within
        ``kmeans_hbm_cache_mb``."""
        cfg = self.config
        if (not cfg.fused_pipeline or cfg.normalize
                or cfg.kmeans_streaming == "always"):
            return False
        budget = cfg.kmeans_hbm_cache_mb * (1 << 20)
        if budget <= 0:
            return False
        est = (self._feed_capacity_rows(self._n_train_clips())
               * self.feature_dim * 4)
        if est > budget:
            logger.info(
                "fused device feed declined: ~%.1f GB of frames exceeds "
                "kmeans_hbm_cache_mb=%d", est / 2**30, cfg.kmeans_hbm_cache_mb)
            return False
        return True

    def _n_train_clips(self) -> int:
        """Train-split clip count: sizes the device feed's buffer."""
        with open(self.config.split_file) as f:
            return len(json.load(f)["train"])

    def _feed_capacity_rows(self, n_clips: int) -> int:
        """Rows of the device feed's buffer for ``n_clips``: every clip at
        its most frames plus one decode batch, rounded up to whole
        ``DEFAULT_CHUNK`` rows — the JAX stage's estimate on one device, so
        the routing decides as the JAX stage does at any budget."""
        cfg = self.config
        rows = (n_clips + cfg.device_batch_size) * cfg.frames_per_clip
        return -(-rows // DEFAULT_CHUNK) * DEFAULT_CHUNK

    def _fused_frames_device(self):
        """The device feed -> (capacity buffer, rows filled).

        Waveform batches (``iter_wave_batches``, sorted train clips) are the
        only host-to-device traffic: each batch's mel frames, L2
        normalization and valid-row prefix are written in place into one
        preallocated ``(capacity, feature_dim)`` f32 buffer on the device
        (``_feed_batch``).  The rows equal the host-mediated route's
        (``_batch_generator``) bit for bit, in clip and frame order.  The
        filled rows stay resident for ``take_resident_frames`` as a view."""
        gen = self._spec_gen()
        ytids = sorted(gen.data_split["train"])
        buffer = torch.empty(
            (self._feed_capacity_rows(len(ytids)), self.feature_dim),
            dtype=torch.float32, device=self.device)
        offset = 0
        manifest: dict = {}
        for batch, lengths, row_ytids in gen.iter_wave_batches(ytids):
            offset = self._feed_batch(gen.frontend, buffer, offset, batch,
                                      lengths, row_ytids, manifest)
        if offset == 0:
            raise FileNotFoundError(
                "fused cluster feed found no decodable training audio")
        self.resident_frames = buffer[:offset]
        self.resident_manifest = manifest
        return buffer, offset

    def _feed_batch(self, frontend: MelFrontend, buffer: torch.Tensor,
                    offset: int, batch: np.ndarray, lengths: np.ndarray,
                    row_ytids: list, manifest: dict) -> int:
        """One decode batch of the device feed: its rows' valid frames,
        L2-normalized, written into ``buffer[offset:]`` in row order, each
        clip recorded in ``manifest`` as ``{ytid: (row, frames)}``; rows
        of length < 0 are padding.  Returns the new offset."""
        cfg = self.config
        t_max = frontend.frames_max
        idx, fill = [], 0
        for c, ln in enumerate(lengths):
            if ln < 0:
                continue
            nv = num_frames(min(int(ln), cfg.clip_samples), cfg.hop_length)
            idx.append(np.arange(c * t_max, c * t_max + nv))
            manifest[row_ytids[c]] = (offset + fill, nv)
            fill += nv
        if not fill:
            return offset
        rows = torch.from_numpy(np.concatenate(idx)).to(self.device)
        x = torch.from_numpy(batch).to(self.device)
        frames = frontend.mel_frames(x).reshape(-1, cfg.n_mels)
        if self.conv is not None:
            frames = self.conv(frames)
        frames = l2_normalize(frames)
        buffer[offset : offset + fill] = frames.index_select(0, rows)
        return offset + fill

    def take_resident_frames(self):
        """(frames, {ytid: (row, frames)}) from the device feed, or None if
        the fit did not take it: the filled rows as a view of the feed's
        buffer (no copy).  The creator drops its references, so the
        buffer lives as long as the caller holds the view."""
        frames = self.resident_frames
        if frames is None:
            return None
        manifest = self.resident_manifest
        self.resident_frames = self.resident_manifest = None
        return frames, manifest

    def _batch_generator(self, batch_size: int) -> Iterator[torch.Tensor]:
        """The file batches as f32 tensors on the stage's device, through
        the conv front-end there and L2-normalized there."""
        for frames in self._file_frames(batch_size):
            x = torch.from_numpy(frames).to(self.device)
            if self.conv is not None:
                x = self.conv(x)
            yield l2_normalize(x)

    def _host_frames(self, frames: np.ndarray) -> np.ndarray:
        """The streaming fit's stream and its init sample as host rows:
        L2-normalized on the host, or under the conv front-end widened and
        normalized on the stage's device (as the JAX stage runs its conv)
        and brought back."""
        if self.conv is None:
            return l2_normalize(torch.from_numpy(frames)).numpy()
        x = self.conv(torch.from_numpy(frames).to(self.device))
        return l2_normalize(x).cpu().numpy()

    def _host_batches(self, batch_size: int) -> Iterator[np.ndarray]:
        """The file batches through ``_host_frames``."""
        for frames in self._file_frames(batch_size):
            yield self._host_frames(frames)

    # -- the streaming fit and its mid-fit checkpoint ------------------------
    # The per-iteration centroid update is the fit's only state across
    # iterations, so one small npz after each iteration makes the stage
    # resumable to the exact iteration (the stream is the same every pass).

    def _fit_streaming(self):
        cfg = self.config
        if cfg.max_points_per_centroid is not None:
            logger.warning(
                "kmeans streaming uses every frame: max_points_per_centroid"
                "=%d is ignored in the streaming path",
                cfg.max_points_per_centroid)
        wire = WIRES.get(cfg.kmeans_wire)
        if wire is None:
            raise ValueError(
                f"kmeans_wire must be 'f32' or 'bf16', got '{cfg.kmeans_wire}'")
        start_iter, init_c = self._load_kmeans_checkpoint()
        if init_c is None:
            init_c = self._global_init_centroids()
        if start_iter >= cfg.niter:
            # the fit finished but the run died before centroids.npy was
            # saved: the checkpoint is the result
            logger.info("streaming kmeans checkpoint already complete (%d "
                        "iterations); skipping the fit", start_iter)
            return init_c
        spill_path = None
        if cfg.kmeans_stream_spill_mb > 0:
            spill_path = (Path(cfg.base_dir) / "output"
                          / "kmeans_stream_spill.p0.bin")
        centroids, obj, n = kmeans_fit_streaming(
            lambda: self._host_batches(cfg.clustering_batch_size),
            cfg.vocab_size,
            cfg.niter,
            d=self.feature_dim,
            seed=cfg.random_seed,
            init_centroids=init_c,
            start_iter=start_iter,
            checkpoint_fn=self._save_kmeans_checkpoint,
            superbatch_rows=cfg.kmeans_superbatch_rows,
            init=cfg.kmeans_init,
            empty_policy=cfg.kmeans_empty_policy,
            precision=cfg.kmeans_precision,
            cache_mb=cfg.kmeans_stream_cache_mb,
            cache_spill_path=spill_path,
            cache_spill_mb=cfg.kmeans_stream_spill_mb,
            hbm_cache_mb=cfg.kmeans_hbm_cache_mb,
            wire_dtype=wire,
            device=self.device,
        )
        logger.info("streaming kmeans over %d frames: obj=%.2f", n, obj)
        return centroids

    def _kmeans_ckpt_path(self) -> Path:
        return Path(self.config.centroids_path).with_suffix(".kmeans_ckpt.npz")

    def _stream_signature(self) -> str:
        """Everything that shapes the Lloyd trajectory, as the JAX stage
        writes it: a checkpoint of another corpus or config is not
        resumed.  Computed once (the writer runs every iteration)."""
        if self._stream_sig is None:
            cfg = self.config
            n_src = (self._n_train_clips() if cfg.fused_pipeline
                     else len(self._train_files()))
            self._stream_sig = json.dumps([
                cfg.vocab_size, self.feature_dim, cfg.niter, cfg.random_seed,
                cfg.kmeans_init, cfg.kmeans_empty_policy,
                cfg.kmeans_precision, cfg.kmeans_wire,
                cfg.clustering_batch_size, cfg.kmeans_superbatch_rows,
                n_src,
            ])
        return self._stream_sig

    def _save_kmeans_checkpoint(self, completed: int, centroids,
                                obj: float) -> None:
        buf = io.BytesIO()
        np.savez(buf,
                 centroids=torch.as_tensor(centroids).cpu().numpy().astype(
                     np.float32),
                 iter=np.int64(completed), obj=np.float64(obj),
                 signature=np.str_(self._stream_signature()))
        atomic_save_bytes(self._kmeans_ckpt_path(), buf.getvalue())

    def _load_kmeans_checkpoint(self):
        """(start_iter, init centroids): (0, None) unless ``incremental``
        finds a resumable fit of this exact stream; without
        ``incremental`` a checkpoint is deleted (destructive rerun)."""
        path = self._kmeans_ckpt_path()
        if not path.exists():
            return 0, None
        if not self.config.incremental:
            path.unlink(missing_ok=True)
            return 0, None
        try:
            z = np.load(path, allow_pickle=False)
            if str(z["signature"]) != self._stream_signature():
                logger.info("kmeans checkpoint ignored: stream/config changed")
                return 0, None
            completed = int(z["iter"])
            c = np.asarray(z["centroids"], np.float32)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            logger.warning("kmeans checkpoint unreadable (%s); restarting", e)
            return 0, None
        if c.shape != (self.config.vocab_size, self.feature_dim):
            return 0, None
        logger.info("resuming streaming kmeans from checkpoint: %d/%d "
                    "iterations already done", completed, self.config.niter)
        return completed, c

    def _global_init_centroids(self):
        """The streaming fit's init, from a seeded sample of the whole
        sorted train list (``_global_init_sample``) rather than the first
        super-batch: ``random`` draws the JAX stage's rows,
        ``kmeans++`` runs the port's draw on the stage's device."""
        cfg = self.config
        k = cfg.vocab_size
        sample = self._global_init_sample()
        if sample.shape[0] < k:
            raise ValueError(f"init sample has {sample.shape[0]} frames < k={k}")
        if cfg.kmeans_init == "kmeans++":
            return kmeans_plusplus_init(sample, k, seed=cfg.random_seed,
                                        device=self.device)
        if cfg.kmeans_init == "random":
            rng = np.random.default_rng(cfg.random_seed)
            return sample[rng.choice(sample.shape[0], size=k, replace=False)]
        raise ValueError(f"unknown kmeans_init '{cfg.kmeans_init}'")

    def _global_init_sample(self) -> np.ndarray:
        """L2-normalized frames (host) of a seeded subset of the sorted
        train files (under the fused mode: clips, through ``iter_specs``),
        enough for a k-sized draw."""
        cfg = self.config
        rng = np.random.default_rng(cfg.random_seed)
        target = max(4 * cfg.vocab_size, 2048)
        n_pick = min(-(-target // max(1, cfg.frames_per_clip)) + 2, 10_000)
        pool = (sorted(self._spec_gen().data_split["train"])
                if cfg.fused_pipeline else self._train_files())
        n_pick = min(n_pick, len(pool))
        chosen = [pool[i] for i in sorted(
            rng.choice(len(pool), size=n_pick, replace=False))]
        if cfg.fused_pipeline:
            specs = [spec for _, spec in self._spec_gen().iter_specs(chosen)]
        else:
            specs = [np.load(f) for f in chosen]
        frames = np.concatenate([s.T for s in specs],
                                axis=0).astype(np.float32)
        return self._host_frames(frames)

    def evaluate_clustering(self, data: np.ndarray, labels: np.ndarray,
                            sample_size: int = 10000,
                            seed: int = 0) -> float:
        """Mean silhouette score on a sample (reference :115-117 — sklearn
        ``silhouette_score(sample_size=10000)``).  Pure numpy: for each
        sampled point, a = mean distance to co-cluster points, b = min over
        other clusters of mean distance; s = (b - a) / max(a, b)."""
        data = np.asarray(data, np.float32)
        labels = np.asarray(labels)
        if len(data) > sample_size:
            sel = np.random.default_rng(seed).choice(
                len(data), sample_size, replace=False)
            data, labels = data[sel], labels[sel]
        uniq = np.unique(labels)
        if len(uniq) < 2:
            # sklearn raises here too: a single-cluster assignment has no
            # silhouette; a silent 0.0 would read as a legitimate mid score
            raise ValueError(
                "silhouette requires >= 2 clusters in the (sampled) labels"
            )
        # pairwise distances on the sample (sample_size^2 floats, ~400 MB max)
        sq = (data * data).sum(1)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (data @ data.T), 0.0)
        dist = np.sqrt(d2, dtype=np.float32)
        masks = {c: labels == c for c in uniq}
        counts = {c: int(m.sum()) for c, m in masks.items()}
        mean_to = np.stack([dist[:, masks[c]].mean(axis=1) for c in uniq],
                           axis=1)  # (n, n_clusters)
        scores = np.zeros(len(data), np.float32)
        for j, c in enumerate(uniq):
            mine = masks[c]
            if counts[c] < 2:
                continue  # singleton clusters score 0 (sklearn convention)
            # own-cluster mean excludes self: n/(n-1) correction of the mean
            a = mean_to[mine, j] * counts[c] / (counts[c] - 1)
            b = np.min(np.delete(mean_to[mine], j, axis=1), axis=1)
            scores[mine] = (b - a) / np.maximum(np.maximum(a, b), 1e-12)
        score = float(scores.mean())
        logger.info("Silhouette Score: %s", score)
        return score

    def visualize_centroids(self, centroids: np.ndarray) -> None:
        """2-D PCA scatter (reference :104-113), PCA via numpy SVD.
        Best-effort: without matplotlib (or on any plotting error) it logs a
        warning and the stage goes on."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            centered = centroids - centroids.mean(axis=0, keepdims=True)
            _, _, vt = np.linalg.svd(centered, full_matrices=False)
            pts = centered @ vt[:2].T
            plt.figure(figsize=(10, 8))
            plt.scatter(pts[:, 0], pts[:, 1])
            plt.title("2D PCA of Centroids")
            out = Path(self.config.base_dir) / "output" / "centroids_visualization.png"
            out.parent.mkdir(parents=True, exist_ok=True)
            plt.savefig(out)
            plt.close()
            logger.info("Centroids visualization saved to %s", out)
        except Exception as e:  # plotting is best-effort
            logger.warning("centroid visualization failed: %s", e)


if __name__ == "__main__":
    import argparse

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0")
    ns, rest = parser.parse_known_args()
    ClusterCreator(AudioTokensConfig.from_args(rest), ns.device).run()
