"""Training-input loader micro-benchmark: batches/s and clips/s assembled by
``BatchLoader`` at various worker counts, on a synthetic tokenized corpus.

Counterpart of ``audio_tokens_tpu/tools/bench_loader.py``.  The streaming
trainer's input path must outrun the card's step rate; this reports how
many clips a second the host assembles, so input starvation is measured
instead of guessed.  The corpus is the JAX tool's (``make_corpus``).

Usage: python -m audio_tokens_tpu_torch.tools.bench_loader [--n_clips 2000]
       [--batch_size 64] [--seq_len 1728] [--workers 1,4,8]
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def make_corpus(base: Path, n_clips: int, seq_len: int, n_classes: int) -> None:
    rng = np.random.default_rng(0)
    tok_dir = base / "tokenized_audio" / "train"
    tok_dir.mkdir(parents=True, exist_ok=True)
    ytids = [f"ld{i:05d}xx" for i in range(n_clips)]
    for y in ytids:
        np.save(tok_dir / f"{y}.npy",
                rng.integers(0, 500, seq_len).astype(np.int64))
    (base / "output").mkdir(exist_ok=True)
    (base / "output" / "bal_train_data_split.json").write_text(
        json.dumps({"train": ytids, "validation": ytids[:1]})
    )
    meta = base / "metadata"
    meta.mkdir(exist_ok=True)
    items = [{"id": f"/m/b{i:03d}", "name": f"c{i}", "restrictions": []}
             for i in range(n_classes)]
    (meta / "ontology.json").write_text(json.dumps(items))
    lines = ["#", "#", "# header"]
    for y in ytids:
        lines.append(f'{y}, 0.0, 10.0, "/m/b000"')
    (meta / "balanced_train_segments.csv").write_text("\n".join(lines) + "\n")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark -> {workers: (batches/s, clips/s)}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_clips", type=int, default=2000)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--seq_len", type=int, default=1728)
    parser.add_argument("--workers", default="1,4,8")
    args = parser.parse_args(argv)

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.data.datasets import (BatchLoader,
                                                      TokenizedSpecDataset)
    from audio_tokens_tpu_torch.data.metadata import AudiosetMetadataProcessor

    base = Path(tempfile.mkdtemp(prefix="atk_loader_bench_"))
    rates = {}
    try:
        make_corpus(base, args.n_clips, args.seq_len, n_classes=8)
        cfg = AudioTokensConfig(base_dir=str(base), num_classes=8,
                                max_seq_len=args.seq_len,
                                training_batch_size=args.batch_size)
        meta = AudiosetMetadataProcessor(cfg)
        ds = TokenizedSpecDataset(cfg, meta, split="train")
        for w in [int(x) for x in args.workers.split(",")]:
            loader = BatchLoader(ds, args.batch_size, shuffle=True, seed=0,
                                 num_workers=w)
            n = sum(1 for _ in loader.batches(epoch=0))  # warm page cache
            t0 = time.perf_counter()
            n = sum(1 for _ in loader.batches(epoch=1))
            dt = time.perf_counter() - t0
            rates[w] = (n / dt, n * args.batch_size / dt)
            print(f"workers={w}: {n / dt:7.1f} batches/s "
                  f"({n * args.batch_size / dt:9.0f} clips/s)")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return rates


if __name__ == "__main__":
    main()
