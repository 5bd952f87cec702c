"""At-scale end-to-end rehearsal: the full 4-stage pipeline on a >=10k-clip
synthetic corpus with per-stage wall-clock and a projection to the 2M-clip
north star (reference: README.md:29, audio_tokens_config.py:26-27).

Counterpart of ``audio_tokens_tpu/tools/scale_run.py``.  It measures the
stages COMPOSED: decode feeding the fused tokenizer, the clustering stage's
device feed (or streaming fit) eating the same decode, the token corpus
feeding the device-resident trainer.  Beside each stage's wall time it
prints what the wire meter (``utils/profiling.WIRE``) counted in it: the MB
moved host-to-card and card-to-host and the seconds of its device-resident
sections.  The clustering projection's compute rate is the one this run
measured: train frames x ``niter`` over the clustering stage's device
seconds.

Usage: python -m audio_tokens_tpu_torch.tools.scale_run [--n_clips 10000]
       [--epochs 5] [--workspace DIR] [--niter 20] [--staged]
       [--device cuda:0] [<config flags>]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

from audio_tokens_tpu_torch.tools.smoke_run import make_corpus

NORTH_STAR_CLIPS = 2_000_000  # unbalanced AudioSet (reference README.md:29)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the rehearsal -> the dict written to
    ``output/scale_run_timings.json`` (plus ``"config"``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--workspace", default=None)
    parser.add_argument("--n_clips", type=int, default=10_000)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--model_type", default="simple")
    parser.add_argument("--niter", type=int, default=20)
    parser.add_argument("--staged", action="store_true",
                        help="run the staged (spectrogram-artifact) pipeline "
                             "instead of the fused wav->tokens path")
    parser.add_argument("--cache_mb", type=int, default=24_000,
                        help="kmeans stream cache budget (frames produced "
                             "once, replayed niter times)")
    parser.add_argument("--kmeans_wire", default="f32",
                        help="'bf16' halves the streaming fit's host-to-card "
                             "bytes")
    parser.add_argument("--device", default="cuda:0")
    # any other --field value pair overlays the config (e.g.
    # --vocab_size 16384 --tokenizer_vq_precision bf16x3 for a rehearsal at
    # the north-star vocabulary)
    args, rest = parser.parse_known_args(argv)

    base = Path(args.workspace or tempfile.mkdtemp(prefix="audiotokens_scale_"))
    print(f"workspace: {base}  ({args.n_clips} clips)", flush=True)

    from audio_tokens_tpu_torch.utils.profiling import WIRE

    timings: dict = {}
    wire: dict = {}

    @contextlib.contextmanager
    def stage(name):
        snap = WIRE.snapshot()
        t0 = time.perf_counter()
        yield
        timings[name] = time.perf_counter() - t0
        wire[name] = WIRE.delta(snap)

    t0 = time.perf_counter()
    if not (base / "metadata" / "ontology.json").exists():
        make_corpus(base, args.n_clips)
    timings["corpus_synthesis"] = time.perf_counter() - t0

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.data.metadata import AudiosetMetadataProcessor
    from audio_tokens_tpu_torch.data.splitter import DatasetSplitter
    from audio_tokens_tpu_torch.processors import (
        ClusterCreator, ModelTrainer, SpecTokenizer, SpectrogramGenerator,
    )

    base_fields = dict(
        base_dir=str(base),
        dataset_ratio=1.0,
        validation_ratio=0.1,
        num_classes=10,
        epochs=args.epochs,
        niter=args.niter,
        model_type=args.model_type,
        hidden_size=128,
        training_batch_size=64,
        eval_batch_size=64,
        learning_rate=1e-3,
        device_batch_size=64,
        fused_pipeline=not args.staged,
        kmeans_mode="full",
        kmeans_stream_cache_mb=args.cache_mb,
        kmeans_wire=args.kmeans_wire,
        pcm_wire="i16",           # half the waveform bytes
        max_train_steps=0,
    )
    # extra --field value (or --field=value) pairs overlay base_fields
    # (``config._coerce`` on each) and the config is constructed ONCE, so
    # __post_init__ validation and derived paths see the final values
    base_fields.update(AudioTokensConfig.parse_overrides(rest))
    cfg = AudioTokensConfig(**base_fields)
    dev = args.device

    t0 = time.perf_counter()
    DatasetSplitter(cfg).create_split_file(AudiosetMetadataProcessor(cfg))
    timings["split"] = time.perf_counter() - t0
    n_train = len(json.loads(Path(cfg.split_file).read_text())["train"])

    if args.staged:
        with stage("spectrograms"):
            SpectrogramGenerator(cfg, dev).run()

    with stage("clustering"):
        cluster = ClusterCreator(cfg, dev)
        cluster.run()

    with stage("tokenization"):
        SpecTokenizer(cfg, dev,
                      resident_frames=cluster.take_resident_frames()).run()

    with stage("training"):
        val_loss, val_metrics = ModelTrainer(cfg, dev).run()

    # ------------------------------------------------------------------
    # report + projection
    # ------------------------------------------------------------------
    frames_per_clip = cfg.frames_per_clip
    print("\n=== scale run summary ===", flush=True)
    # the byte counts and device seconds are the columns that do not
    # depend on the host: composed-stage claims rest on them
    print(f"{'stage':>16s}  {'wall s':>8s}  {'h2d MB':>8s}  {'d2h MB':>8s}  "
          f"{'device s':>8s}")
    total = 0.0
    for k, v in timings.items():
        total += v
        w = wire.get(k)
        cols = (f"{w['h2d_mb']:8.1f}  {w['d2h_mb']:8.1f}  "
                f"{w['device_s']:8.1f}" if w else f"{'-':>8s}  {'-':>8s}  "
                f"{'-':>8s}")
        per_clip = ""
        if k in ("spectrograms", "clustering", "tokenization"):
            per_clip = f"  ({n_train / v:8.1f} train clips/s)"
        elif k == "training":
            per_clip = f"  ({args.epochs} epochs)"
        print(f"{k:>16s}: {v:8.1f}  {cols}{per_clip}")
    print(f"{'TOTAL':>16s}: {total:8.1f} s")
    print(f"final val mAP: {val_metrics['mAP']:.4f} (random ~0.20), "
          f"val loss {val_loss:.4f}")

    binding = max(
        (k for k in timings if k not in ("corpus_synthesis", "split")),
        key=lambda k: timings[k],
    )
    print(f"binding stage at this scale: {binding} "
          f"({timings[binding]:.1f} s)")

    scale = NORTH_STAR_CLIPS / args.n_clips
    print(f"\n=== projection to {NORTH_STAR_CLIPS / 1e6:.0f}M clips "
          f"(x{scale:.0f} linear in clips; this host) ===")
    for k in timings:
        if k in ("corpus_synthesis", "split"):
            continue
        if k == "training":
            # training scales per epoch; steps/epoch scale linearly
            per_epoch = timings[k] / args.epochs
            print(f"{k:>16s}: {per_epoch * scale / 3600:8.1f} h/epoch")
        else:
            print(f"{k:>16s}: {timings[k] * scale / 3600:8.1f} h")
    # this run's rate: train rows x niter over the clustering stage's
    # device seconds (0 where no section ran: the rate is then unknown)
    points = n_train * frames_per_clip * args.niter
    device_s = wire["clustering"]["device_s"]
    rate = points / device_s if device_s > 0 else float("nan")
    compute_s = (NORTH_STAR_CLIPS * frames_per_clip * args.niter / rate
                 if device_s > 0 else float("nan"))
    # the route the fit took, recorded by ClusterCreator.run()
    if getattr(cluster, "used_device_feed", False):
        wav_bytes = 2 if cfg.pcm_wire == "i16" else 4
        print(f"(clustering moves ~{n_train * cfg.clip_samples * wav_bytes / 2**30:.0f} GiB "
              f"of waveforms host-to-card ONCE: the device feed assembles "
              f"frames on the card and all {args.niter} Lloyd iterations "
              f"run there; this run's rate {rate / 1e6:.1f}M point-iters/s "
              f"puts the 2M-clip fit's compute at ~{compute_s:.0f} s)")
    else:
        wire_bytes = 2 if cfg.kmeans_wire == "bf16" else 4
        print(f"(clustering moves ~{n_train * frames_per_clip * cfg.n_mels * wire_bytes * args.niter / 2**30:.0f} GiB "
              f"of frames host-to-card at niter={args.niter} where no cache "
              f"holds them; this run's device rate {rate / 1e6:.1f}M "
              f"point-iters/s puts the 2M-clip fit's compute at "
              f"~{compute_s:.0f} s)")

    result = {"n_clips": args.n_clips, "timings": timings, "wire": wire,
              "val_mAP": val_metrics["mAP"], "val_loss": val_loss,
              "niter": args.niter, "epochs": args.epochs,
              "fused": not args.staged}
    out = base / "output" / "scale_run_timings.json"
    out.write_text(json.dumps(result, indent=2))
    print(f"timings written to {out}")
    return {**result, "config": cfg, "point_iters_per_s": rate}


if __name__ == "__main__":
    main()
