"""Stage 4: train a classifier on the tokenized artifacts (counterpart of
``audio_tokens_tpu/processors/model_trainer.py``).

Stage-interface wrapper (``__init__(config)`` + ``run()``) around
``train.Trainer``, on ``cuda:0`` unless another device is given; without a
card it fails rather than train somewhere else.  From a shell:

    python -m audio_tokens_tpu_torch.processors.model_trainer [--device cpu] \\
        --epochs 10 --training_batch_size 64 ...

Every flag other than ``--device`` is a config field (``AudioTokensConfig``).
"""

from __future__ import annotations

from typing import Optional

import torch

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.train.trainer import Trainer


class ModelTrainer(Trainer):
    def __init__(self, config: AudioTokensConfig,
                 device: Optional[torch.device | str] = None):
        super().__init__(config, torch.device("cuda", 0) if device is None
                         else device)


if __name__ == "__main__":
    import argparse
    import logging

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0")
    ns, rest = parser.parse_known_args()
    trainer = ModelTrainer(AudioTokensConfig.from_args(rest), ns.device)
    val_loss, val_metrics = trainer.run()
    logging.getLogger(__name__).info(
        "Final Validation Loss: %.4f, Final Validation mAP: %.4f",
        val_loss, val_metrics["mAP"],
    )
