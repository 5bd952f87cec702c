"""End-to-end demo at the reference's PR1 scale: ~100 ten-second clips through
all four stages at the reference's default signal chain (22.05 kHz, 64 mel,
n_fft 512, hop 128, vocab 500) with per-stage wall-clock timings.

Counterpart of ``audio_tokens_tpu/tools/smoke_run.py``.  Real AudioSet audio
is not needed: a deterministic synthetic corpus (tone mixtures whose
fundamental encodes the class; ``make_corpus`` writes the JAX tool's files
byte for byte) is generated in the workspace, so the run exercises decode ->
spectrograms -> clustering -> tokenization -> training -> inference
(``infer.ManualTester``) as a real run would.

Usage: python -m audio_tokens_tpu_torch.tools.smoke_run [--workspace DIR]
       [--n_clips 100] [--epochs 5] [--model_type simple] [--fused]
       [--device cuda:0]
"""

from __future__ import annotations

import argparse
import json
import logging
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

SR = 22050


def make_corpus(base: Path, n_clips: int, n_classes: int = 10) -> None:
    """Synthetic AudioSet-shaped corpus: metadata + sharded wav files."""
    from audio_tokens_tpu_torch.data.audio_io import write_pcm_wav

    meta = base / "metadata"
    meta.mkdir(parents=True, exist_ok=True)
    items = [
        {"id": f"/m/smoke{i:03d}", "name": f"Tone {i}", "restrictions": []}
        for i in range(n_classes)
    ]
    (meta / "ontology.json").write_text(json.dumps(items))

    rng = np.random.default_rng(0)
    lines = ["# synthetic", "# header", "# YTID, start, end, labels"]
    t = np.arange(SR * 10) / SR
    for i in range(n_clips):
        ytid = f"sm{i:05d}xyz"
        cls = i % n_classes
        extra = (i * 7) % n_classes
        labs = sorted({cls, extra})
        lines.append(
            f'{ytid}, 0.000, 10.000, "' +
            ",".join(f"/m/smoke{j:03d}" for j in labs) + '"'
        )
        # clip: fundamental + harmonic encodes the class, plus noise
        f0 = 110.0 * (1 + cls)
        x = (
            0.5 * np.sin(2 * np.pi * f0 * t)
            + 0.25 * np.sin(2 * np.pi * 1.5 * 110.0 * (1 + extra) * t)
            + 0.05 * rng.standard_normal(len(t))
        ).astype(np.float32)
        x /= np.abs(x).max()
        path = base / "audioset" / "bal_train" / ytid[:2] / f"{ytid}.wav"
        write_pcm_wav(path, x, SR)
    (meta / "balanced_train_segments.csv").write_text("\n".join(lines) + "\n")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the demo -> {"timings", "wire" (each pipeline stage's
    ``utils/profiling.WIRE`` delta), "val_metrics", "rows", "config"}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--workspace", default=None)
    parser.add_argument("--n_clips", type=int, default=100)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--model_type", default="simple")
    parser.add_argument("--fused", action="store_true",
                        help="fused pipeline: wav->tokens, no mel artifacts")
    parser.add_argument("--device", default="cuda:0")
    args, rest = parser.parse_known_args(argv)

    base = Path(args.workspace or tempfile.mkdtemp(prefix="audiotokens_smoke_"))
    print(f"workspace: {base}")
    make_corpus(base, args.n_clips)

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.data.metadata import AudiosetMetadataProcessor
    from audio_tokens_tpu_torch.data.splitter import DatasetSplitter
    from audio_tokens_tpu_torch.processors import (
        ClusterCreator, ModelTrainer, SpecTokenizer, SpectrogramGenerator,
    )
    from audio_tokens_tpu_torch.utils.profiling import WIRE

    cfg = AudioTokensConfig(
        base_dir=str(base),
        dataset_ratio=1.0,
        validation_ratio=0.2,
        num_classes=10,
        epochs=args.epochs,
        model_type=args.model_type,
        hidden_size=128,
        training_batch_size=8,
        learning_rate=1e-3,
        device_batch_size=32,
        fused_pipeline=args.fused,
    )
    del rest  # stage flags are fixed for the smoke config
    dev = args.device

    timings, wire = {}, {}
    t0 = time.perf_counter()
    DatasetSplitter(cfg).create_split_file(AudiosetMetadataProcessor(cfg))
    timings["split"] = time.perf_counter() - t0

    stages = [
        ("spectrograms", SpectrogramGenerator),
        ("clustering", ClusterCreator),
        ("tokenization", SpecTokenizer),
    ]
    if args.fused:
        stages = stages[1:]
    cluster = None
    for name, stage in stages:
        snap = WIRE.snapshot()
        t0 = time.perf_counter()
        if stage is SpecTokenizer and cluster is not None:
            # run_pipeline's wiring: the handoff is None under the smoke
            # config's batch_warm_start clustering (it engages only where
            # the fit took the device feed; scale_run exercises it)
            stage(cfg, dev,
                  resident_frames=cluster.take_resident_frames()).run()
        else:
            inst = stage(cfg, dev)
            inst.run()
            if stage is ClusterCreator:
                cluster = inst
        timings[name] = time.perf_counter() - t0
        wire[name] = WIRE.delta(snap)

    snap = WIRE.snapshot()
    t0 = time.perf_counter()
    val_loss, val_metrics = ModelTrainer(cfg, dev).run()
    timings["training"] = time.perf_counter() - t0
    wire["training"] = WIRE.delta(snap)

    # single-clip inference through the saved checkpoint
    from audio_tokens_tpu_torch.infer import ManualTester

    t0 = time.perf_counter()
    split = json.loads(Path(cfg.split_file).read_text())
    rows = ManualTester(cfg, device=dev).run(split["validation"][0], top_k=5)
    timings["inference"] = time.perf_counter() - t0

    print("\n=== smoke run summary ===")
    for k, v in timings.items():
        print(f"{k:>14s}: {v:7.2f} s")
    print(f"final val mAP: {val_metrics['mAP']:.4f} (random ~{2/10:.2f})")
    top_hit = any(r["is_true"] for r in rows[:2])
    print(f"inference top-2 contains a true label: {top_hit}")
    return {"timings": timings, "wire": wire, "val_metrics": val_metrics,
            "rows": rows, "config": cfg}


if __name__ == "__main__":
    main()
