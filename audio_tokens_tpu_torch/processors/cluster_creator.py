"""Stage 2: cluster training-set STFT frames into a centroid vocabulary.

Counterpart of ``audio_tokens_tpu/processors/cluster_creator.py``, with the
same artifact contract (reference: processors/cluster_creator.py:36-62):
reads ``{source_spec_path}/train/*.npy`` in sorted order, writes
L2-normalized ``centroids.npy`` (f32 ``x / (||x|| + 1e-10)`` rows, shape
``(vocab_size, feature_dim)``) and, where matplotlib is installed, a 2-D
PCA scatter at ``output/centroids_visualization.png``.

The fit is ``ops/kmeans.py`` on the stage's device (``cuda:0`` unless the
caller passes another): each file batch is L2-normalized there and stays
there for the fit.  Two modes (``config.kmeans_mode``):

  * ``batch_warm_start`` (the default) — the reference's schedule: each
    ``clustering_batch_size``-file batch re-trains ``niter`` Lloyd
    iterations from the previous batch's centroids;
  * ``full`` — one Lloyd fit over every frame, held in device memory.

Not ported, and refused with ``NotImplementedError``: the streaming fit and
its mid-fit checkpoint, its host/disk caches and wire formats (ROADMAP A2,
second half), the fused device feed and ``take_resident_frames`` (ROADMAP
A3, fused mode), ``use_convolution`` and the precision tiers (ROADMAP A6),
multi-process runs and stage traces (ROADMAP A7).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.ops.kmeans import (
    KMeans,
    kmeans_fit,
    precision_from_str,
)
from audio_tokens_tpu_torch.ops.vq import l2_normalize
from audio_tokens_tpu_torch.processors.spectrogram_generator import (
    refuse_multiprocess,
)
from audio_tokens_tpu_torch.utils.seeding import set_seed

logger = logging.getLogger(__name__)


def _refuse_unported(config: AudioTokensConfig) -> None:
    refused = {
        "fused_pipeline=True (the fused device feed and the resident-frames "
        "handoff)": ("A3, fused mode", config.fused_pipeline),
        "use_convolution (ConvFeatures)": ("A6", config.use_convolution),
        "kmeans_stream_cache_mb > 0 (the streaming fit's host cache)":
            ("A2, second half", config.kmeans_stream_cache_mb > 0),
        "kmeans_stream_spill_mb > 0 (the streaming fit's disk spill)":
            ("A2, second half", config.kmeans_stream_spill_mb > 0),
        f"kmeans_wire='{config.kmeans_wire}' (the streaming fit's wire)":
            ("A2, second half", config.kmeans_wire != "f32"),
    }
    for what, (item, asked) in refused.items():
        if asked:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP {item}")
    refuse_multiprocess(config)
    precision_from_str(config.kmeans_precision)


class ClusterCreator:
    def __init__(self, config: AudioTokensConfig,
                 device: Optional[torch.device | str] = None):
        _refuse_unported(config)
        self.config = config
        self.device = torch.device("cuda", 0) if device is None else \
            torch.device(device)
        set_seed(config.random_seed)

    def run(self) -> np.ndarray:
        logger.info("starting clustering (mode=%s)", self.config.kmeans_mode)
        cfg = self.config
        if cfg.kmeans_mode == "full":
            if self._should_stream():
                raise NotImplementedError(
                    "kmeans_mode='full' over more frames than "
                    "kmeans_inmemory_budget_mb (or kmeans_streaming="
                    "'always') needs the streaming fit, which is not ported "
                    "yet: ROADMAP A2, second half")
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
            )
            logger.info("full kmeans over %d frames: obj=%.2f",
                        frames.shape[0], obj)
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

        centroids = l2_normalize(centroids).cpu().numpy()
        logger.info("Centroids shape: %s", centroids.shape)
        out_path = Path(cfg.centroids_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        np.save(out_path, centroids)
        self.visualize_centroids(centroids)
        return centroids

    @property
    def feature_dim(self) -> int:
        return self.config.feature_dim

    def _should_stream(self) -> bool:
        """Whether full-mode k-means would need the streaming fit: the JAX
        stage's rule for the staged path (spectrogram bytes on disk against
        ``kmeans_inmemory_budget_mb``, or the subsample's when
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
        spec_dir = Path(self.config.source_spec_path) / "train"
        est = sum(f.stat().st_size for f in spec_dir.glob("*.npy"))
        if est > budget:
            logger.info(
                "full kmeans: ~%.1f GB of frames exceeds the %.1f GB in-memory "
                "budget", est / 2**30, budget / 2**30)
            return True
        return False

    def _batch_generator(self, batch_size: int) -> Iterator[torch.Tensor]:
        """Yield (frames, feature_dim) f32 tensors on the stage's device,
        L2-normalized there, per ``batch_size`` files in sorted order — the
        reference's frame pipeline (:83-102)."""
        spec_dir = Path(self.config.source_spec_path) / "train"
        files = sorted(spec_dir.glob("*.npy"))
        if not files:
            raise FileNotFoundError(f"no spectrograms under {spec_dir}")
        for i in range(0, len(files), batch_size):
            frames = np.concatenate(
                [np.load(f).T for f in files[i : i + batch_size]],
                axis=0).astype(np.float32)
            yield l2_normalize(torch.from_numpy(frames).to(self.device))

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
