"""Where a serving batch's time goes on one card: ``torch.profiler`` over
``ServingProgram`` batches of the lstm or bert classifier at full width.

    python -m audio_tokens_tpu_torch.tools.profile_serving [--model bert]
        [--batch 64] [--batches 5]

The program is ``chip_smoke.py``'s: 10-second synthetic clips (two
partials plus noise, seeded), 500 unit-normalized random centroids, random
weights from seed 0; lstm at the package defaults (embed 256, hidden 512),
bert at ``tools/bench_training.py``'s ``bert_full`` widths (hidden 768, 12
heads, 2 layers, window 1728, bf16, flash attention).  Two batches warm up,
``--batches`` batches are timed on the host clock (each ending in
``torch.cuda.synchronize()``; the median is printed), and as many run
again under the profiler.  The script prints the wall time of a batch
without and with the profiler, the card's busy time a batch (the sum of
the device time of every kernel and copy the profiler saw; one stream, so
nothing overlaps but a copy), the idle share of the profiled wall time,
and the ten kernels and copies that take most device time.  The last line
is the card as nvidia-smi names it.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import numpy as np

SR, CLIP_SECONDS, VOCAB = 22050, 10.0, 500


def clips(n: int) -> list:
    """Two partials plus noise a clip, seeded (``chip_smoke.make_clips``)."""
    rng = np.random.default_rng(0)
    t = np.arange(int(SR * CLIP_SECONDS)) / SR
    out = []
    for i in range(n):
        f0 = 80.0 * (1 + (i % 16))
        x = (0.5 * np.sin(2 * np.pi * f0 * t)
             + 0.2 * np.sin(2 * np.pi * 2.3 * f0 * t)
             + 0.1 * rng.standard_normal(len(t)))
        out.append(x.astype(np.float32))
    return out


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("lstm", "bert"), default="bert")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.export import ServingProgram
    from audio_tokens_tpu_torch.ops.common import exact_f32
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    exact_f32()
    dev = torch.device("cuda", 0)
    common = dict(clip_seconds=CLIP_SECONDS, vocab_size=VOCAB,
                  num_classes=543, max_seq_len=1728)
    if args.model == "bert":
        cfg = AudioTokensConfig(
            model_type="bert", hidden_size=768, num_layers=2,
            transformer_max_position=1728, dropout=0.0,
            transformer_attention="flash", **common)
    else:
        cfg = AudioTokensConfig(lstm_embed_dim=256, lstm_hidden_dim=512,
                                num_layers=1, **common)
    rng = np.random.default_rng(7)
    cents = rng.standard_normal((VOCAB, 64)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True) + 1e-10
    tok = FusedTokenizer(cfg, cents, dev)
    prog = ServingProgram.from_components(
        cfg, tok, device=dev, generator=torch.Generator().manual_seed(0))
    batch, lengths = tok.frontend.prepare_batch(clips(args.batch))
    batch, lengths = torch.from_numpy(batch), torch.from_numpy(lengths)

    def one() -> float:
        t0 = time.perf_counter()
        prog(batch, lengths)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        one()
    plain_ms = statistics.median(one() for _ in range(args.batches))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.batches):
            one()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.batches
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Activity"):
            continue  # host ops (their kernels are listed), profiler's own
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3 / args.batches, ev.count // args.batches,
                         ev.key))
    busy = sum(r[0] for r in rows)
    print(f"{args.model} serving, batch {args.batch}: wall {plain_ms:.3f} ms "
          f"a batch (median of {args.batches}, host clock, host->card copy "
          f"included); profiled {wall_ms:.3f} ms a batch, card busy "
          f"{busy:.3f} ms a batch, idle {max(0.0, 1 - busy / wall_ms):.1%}")
    for ms, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {ms:9.3f} ms a batch  x{count:<4d} {key[:100]}")
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
