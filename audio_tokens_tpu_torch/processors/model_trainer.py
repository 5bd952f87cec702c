"""Stage 4: train a classifier on the tokenized artifacts (counterpart of
``audio_tokens_tpu/processors/model_trainer.py``).

Stage-interface wrapper (``__init__(config)`` + ``run()``) around
``train.Trainer``, on ``cuda:0`` unless another device is given (under
``distributed``, this rank's card: ``parallel/distributed.local_device``);
without a card it fails rather than train somewhere else.  From a shell:

    python -m audio_tokens_tpu_torch.processors.model_trainer [--device cpu] \\
        --epochs 10 --training_batch_size 64 ...

Every flag other than ``--device`` is a config field (``AudioTokensConfig``).
Data parallel over N cards: one process a card, e.g. ``torchrun
--nproc_per_node N -m audio_tokens_tpu_torch.processors.model_trainer
--distributed true ...``.
"""

from __future__ import annotations

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.train.trainer import Trainer


class ModelTrainer(Trainer):
    """``Trainer`` under the stage name; ``device`` defaults as there."""


if __name__ == "__main__":
    import argparse
    import logging

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="default: this rank's card (cuda:0 in one "
                        "process)")
    ns, rest = parser.parse_known_args()
    trainer = ModelTrainer(AudioTokensConfig.from_args(rest), ns.device)
    val_loss, val_metrics = trainer.run()
    logging.getLogger(__name__).info(
        "Final Validation Loss: %.4f, Final Validation mAP: %.4f",
        val_loss, val_metrics["mAP"],
    )
