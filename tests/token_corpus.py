"""A tokenized fixture corpus for the trainer tests, without the audio
stages: the synthetic ontology and segment CSV of ``tests/fixtures.py``, a
split file, and per-clip token ``.npy`` artifacts drawn from a seed in the
layout ``SpecTokenizer`` writes (``{dest_tokenized_path}/{split}/{ytid}.npy``,
int64).  Lengths straddle ``max_seq_len`` so batches hold both truncated and
padded rows."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tests import fixtures


def make_token_corpus(base: Path, max_seq_len: int = 64,
                      seed: int = 0) -> None:
    """Write metadata, split file and token artifacts under ``base``."""
    from audio_tokens_tpu.data.metadata import AudiosetMetadataProcessor
    from audio_tokens_tpu.data.splitter import DatasetSplitter

    meta = base / "metadata"
    meta.mkdir(parents=True, exist_ok=True)
    fixtures.make_ontology(meta / "ontology.json")
    fixtures.make_segments_csv(meta / "balanced_train_segments.csv")
    (base / "output").mkdir(exist_ok=True)
    cfg = config(base, max_seq_len=max_seq_len)
    DatasetSplitter(cfg).create_split_file(AudiosetMetadataProcessor(cfg))
    split = json.loads(Path(cfg.split_file).read_text())
    rng = np.random.default_rng(seed)
    for name, ytids in split.items():
        out = Path(cfg.dest_tokenized_path) / name
        out.mkdir(parents=True, exist_ok=True)
        for ytid in ytids:
            n = int(rng.integers(max_seq_len // 3, 2 * max_seq_len))
            np.save(out / f"{ytid}.npy",
                    rng.integers(0, cfg.vocab_size, n).astype(np.int64))


def config(base: Path, **overrides):
    """The JAX package's config for the corpus under ``base``: the fixture
    sizes of ``fixtures.test_config``, an lstm of 1 layer, batch 4 (18
    training and 6 validation clips: both splits end in a partial batch),
    one batch-assembly thread."""
    kw = dict(model_type="lstm", max_seq_len=64, training_batch_size=4,
              num_workers=1, learning_rate=3e-3, save_best_checkpoint=False,
              device_corpus="off", log_every_steps=0)
    kw.update(overrides)
    return fixtures.test_config(base, **kw)


def port_config(base: Path, **overrides):
    """The same configuration as the port's ``AudioTokensConfig``."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig

    return AudioTokensConfig(**config(base, **overrides).to_dict())
