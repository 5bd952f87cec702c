"""Dataset sanity report: loader sizes, split disjointness, batch samples.

Counterpart of ``audio_tokens_tpu/tools/dataset_tester.py``, a working
equivalent of the reference's tester (reference: tools/dataset_tester.py:
18-23): prints the loaders' and datasets' sizes, re-checks train/val ytid
disjointness, and shows a sample batch's shapes and label statistics.

Usage: python -m audio_tokens_tpu_torch.tools.dataset_tester [<config flags>]
"""

from __future__ import annotations

import logging

import numpy as np

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.data.datasets import DataLoaderCreator

logger = logging.getLogger(__name__)


def main(config: AudioTokensConfig) -> None:
    train_loader, val_loader = DataLoaderCreator(config).get_dataloaders()
    print(f"train: {len(train_loader.ds)} clips, {len(train_loader)} batches")
    print(f"val:   {len(val_loader.ds)} clips, {len(val_loader)} batches")

    overlap = set(train_loader.ds.ytids) & set(val_loader.ds.ytids)
    print(f"train/val ytid overlap: {len(overlap)}")
    assert not overlap

    batches = train_loader.batches(0)
    try:
        batch = next(batches)
    finally:
        batches.close()  # reaps the prefetch thread
    print(f"inputs:  {batch['inputs'].shape} {batch['inputs'].dtype}")
    print(f"lengths: min={batch['lengths'].min()} max={batch['lengths'].max()}")
    labels = batch["labels"]
    print(
        f"labels:  {labels.shape}, positives/row "
        f"min={int(labels.sum(1).min())} max={int(labels.sum(1).max())}"
    )
    if batch["inputs"].dtype.kind == "i":
        toks = batch["inputs"][0][: batch["lengths"][0]]
        print(f"sample tokens[0][:20]: {toks[:20].tolist()}")
    print(f"sample labels[0] indices: {np.nonzero(labels[0])[0].tolist()}")


if __name__ == "__main__":
    main(AudioTokensConfig.from_args())
