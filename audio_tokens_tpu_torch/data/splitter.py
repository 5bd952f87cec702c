"""Seeded train/validation split manifest.

A copy of ``audio_tokens_tpu/data/splitter.py``, held equal to the original by
``tests/test_torch_train_data.py``.

Behavioral equivalent of the reference's DatasetSplitter
(reference: processors/dataset_splitter.py:16-42): seeded shuffle of all
ytids, truncation to ``dataset_ratio``, last ``validation_ratio`` fraction
becomes validation, JSON manifest ``{"train": [...], "validation": [...]}``
written to ``config.split_file``.

Uses python's ``random.Random(seed).shuffle`` exactly as the reference does,
so at an identical seed + ytid order the split is identical.
"""

from __future__ import annotations

import json
import logging
import random
from pathlib import Path
from typing import List, Tuple

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.data.metadata import AudiosetMetadataProcessor


class DatasetSplitter:
    def __init__(self, config: AudioTokensConfig):
        self.config = config
        self.logger = logging.getLogger(__name__)

    def create_split_file(
        self, metadata_processor: AudiosetMetadataProcessor
    ) -> Path:
        train, val = self._split_data(metadata_processor.get_all_ytids())
        split_path = Path(self.config.split_file)
        split_path.parent.mkdir(parents=True, exist_ok=True)
        with split_path.open("w") as f:
            json.dump({"train": train, "validation": val}, f)
        self.logger.info(
            "Split file %s: %d train / %d validation", split_path, len(train), len(val)
        )
        return split_path

    def _split_data(self, ytids: List[str]) -> Tuple[List[str], List[str]]:
        rng = random.Random(self.config.random_seed)
        ytids = list(ytids)
        rng.shuffle(ytids)
        dataset_size = int(len(ytids) * self.config.dataset_ratio)
        ytids = ytids[:dataset_size]
        split_index = int(len(ytids) * (1 - self.config.validation_ratio))
        return ytids[:split_index], ytids[split_index:]


def load_split(split_file: str) -> dict:
    with open(split_file, "r") as f:
        return json.load(f)


if __name__ == "__main__":
    config = AudioTokensConfig.from_args()
    DatasetSplitter(config).create_split_file(AudiosetMetadataProcessor(config))
