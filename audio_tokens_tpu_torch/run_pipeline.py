"""The four pipeline stages in one run, on one device (counterpart of the
staged path of the repository's ``run_pipeline.py``).

Spectrograms -> centroids -> tokens -> a trained classifier, under one
shared config and one device (``cuda:0`` unless the caller passes another;
without a card it fails rather than run somewhere else).  The split
manifest must exist first:

    python -m audio_tokens_tpu_torch.data.splitter --base_dir WS
    python -m audio_tokens_tpu_torch.run_pipeline [--device cpu] \\
        --base_dir WS --vocab_size 500 ...

Every flag other than ``--device`` is a config field (``AudioTokensConfig``).
The fused mode (``fused_pipeline=True``) is not ported yet (ROADMAP A3).
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.ops.common import exact_f32
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
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if config.fused_pipeline:
        raise NotImplementedError(
            "fused_pipeline=True (wav -> tokens without spectrogram "
            "artifacts) is not ported yet: ROADMAP A3, fused mode")
    exact_f32()  # the mel, K-means and classifier products stay in f32
    SpectrogramGenerator(config, device).run()
    ClusterCreator(config, device).run()
    SpecTokenizer(config, device).run()
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
    parser.add_argument("--device", default="cuda:0")
    ns, rest = parser.parse_known_args()
    main(AudioTokensConfig.from_args(rest), ns.device)
