"""The four pipeline stages in one run (counterpart of the repository's
``run_pipeline.py``).

Spectrograms -> centroids -> tokens -> a trained classifier, under one
shared config and one device (``cuda:0`` unless the caller passes another;
without a card it fails rather than run somewhere else).  Under
``--distributed true`` with torchrun, or with the ``AUDIO_TOKENS_*``
variables, N processes run the pipeline together, one card each
(``parallel/distributed.py``): the stages shard the clips, the clustering
is one streaming ``full`` fit over every rank's frames and the training is
data parallel.  The split manifest must exist first:

    python -m audio_tokens_tpu_torch.data.splitter --base_dir WS
    python -m audio_tokens_tpu_torch.run_pipeline [--device cpu] \\
        --base_dir WS --vocab_size 500 ...

Every flag other than ``--device`` is a config field (``AudioTokensConfig``).
``--fused_pipeline true`` writes no spectrogram files: clustering takes its
frames from the audio (in ``kmeans_mode=full`` within the device budget,
straight into device memory), and the tokenize stage assigns the train
clips from those resident frames and tokenizes the rest wav -> tokens
through ``FusedTokenizer`` (kernel B1).  It refuses datasets that train on
spectrograms.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.ops.common import exact_f32
from audio_tokens_tpu_torch.parallel import distributed
from audio_tokens_tpu_torch.processors import (
    ClusterCreator,
    ModelTrainer,
    SpecTokenizer,
    SpectrogramGenerator,
)

logger = logging.getLogger(__name__)


def main(config: Optional[AudioTokensConfig] = None,
         device: Optional[torch.device | str] = None):
    """Run the stages in order; returns (val_loss, val_metrics)."""
    config = config or AudioTokensConfig.from_args()
    distributed.maybe_initialize(config)
    device = (distributed.default_device() if device is None
              else torch.device(device))
    if config.fused_pipeline and (
            config.dataset_type != "TokenizedSpecDataset"
            or config.use_precomputed_embeddings):
        raise ValueError(
            "fused_pipeline=True writes no spectrogram artifacts, but "
            f"dataset_type={config.dataset_type!r} / "
            f"use_precomputed_embeddings={config.use_precomputed_embeddings} "
            "trains on raw spectrograms — run the staged pipeline for "
            "spec-consuming models (cnn/baseline/raw-embedding)")
    exact_f32()  # the mel, K-means and classifier products stay in f32
    if config.fused_pipeline:
        logger.info("fused pipeline: skipping the spectrogram artifact stage")
    else:
        SpectrogramGenerator(config, device).run()
    cluster = ClusterCreator(config, device)
    cluster.run()
    # the device feed's frames, if the fit took it: the train split is then
    # assigned without a second decode
    SpecTokenizer(config, device,
                  resident_frames=cluster.take_resident_frames()).run()
    val_loss, val_metrics = ModelTrainer(config, device).run()
    logger.info(
        "Pipeline complete. Final Val Loss: %.4f, Val mAP: %.4f",
        val_loss, val_metrics["mAP"],
    )
    return val_loss, val_metrics


if __name__ == "__main__":
    import argparse

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="default: this rank's card (cuda:0 in one "
                        "process)")
    ns, rest = parser.parse_known_args()
    main(AudioTokensConfig.from_args(rest), ns.device)
