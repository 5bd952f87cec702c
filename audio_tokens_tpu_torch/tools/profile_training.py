"""Where a training step's time goes on one card: a single device-resident
epoch (``train/device_epoch.DeviceEpochRunner``) against ensemble epochs
(``train/ensemble.EnsembleTrainer``) of the same family, under
``torch.profiler``.

    python -m audio_tokens_tpu_torch.tools.profile_training [--models lstm,bert]
        [--members 1,4] [--batches 8]

Each family trains on ``tools/bench_training.py``'s synthetic corpus
(``--batches`` batches at the case's batch size and T 1728, full lengths)
at ``chip_smoke.py``'s phase-14 widths: the lstm (embed 256, hidden 512,
batch 64, dropout 0.1), simple (hidden 768, batch 64), bert (``bert_full``:
hidden 768, 2 layers, window 1728, bf16, batch 8) and cnn (bf16 spec rows,
batch 64).  For the single run and each member count: one epoch warms up,
one is timed on the host clock (it ends in its read of the card), and one
runs under the profiler.  Printed: ms a step, the card's busy ms a step
(the device time of every kernel and copy the profiler saw), the idle
share, the kernels and copies with the most device time, and the host ops
with the most self time.  The last line is the card as nvidia-smi names it.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np

FAMILIES = {
    "lstm": dict(model_type="lstm", lstm_embed_dim=256, lstm_hidden_dim=512,
                 num_layers=1, dropout=0.1, training_batch_size=64),
    "simple": dict(model_type="simple", hidden_size=768,
                   training_batch_size=64),
    "bert": dict(model_type="bert", hidden_size=768, num_layers=2,
                 transformer_max_position=1728, dropout=0.0,
                 transformer_attention="flash", training_batch_size=8),
    "cnn": dict(model_type="cnn", dataset_type="RawSTFTDataset",
                device_corpus_dtype="bfloat16", training_batch_size=64),
}


def profiled(fn, steps: int, top: int = 8):
    """fn() under the profiler -> (busy ms a step, [(device ms a step,
    calls a step, kernel)], [(host self ms a step, calls a step, op)])."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, host = [], []
    for ev in prof.key_averages():
        if ev.key.startswith("Activity"):
            continue  # the profiler's own
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            kernels.append((us / 1e3 / steps, ev.count // steps, ev.key))
        elif ev.device_type == DeviceType.CPU:
            host.append((ev.self_cpu_time_total / 1e3 / steps,
                         ev.count // steps, ev.key))
    busy = sum(k[0] for k in kernels)
    return (busy, sorted(kernels, reverse=True)[:top],
            sorted(host, reverse=True)[:top])


def run(cfg, dev, arrays, n: int, k: int):
    """The single trainer (``k`` 0) or an ensemble of ``k`` on the corpus
    ``arrays`` of ``n`` rows: a warm-up epoch, a timed one, a profiled one
    -> (wall ms a step, busy ms a step, kernels, host ops)."""
    import torch

    from audio_tokens_tpu_torch.train.device_epoch import DeviceEpochRunner
    from audio_tokens_tpu_torch.train.ensemble import EnsembleTrainer
    from audio_tokens_tpu_torch.train.trainer import Trainer

    b = cfg.training_batch_size
    steps = n // b
    if k == 0:
        runner = DeviceEpochRunner(Trainer(cfg, dev))
        runner.set_corpus_arrays("train", *arrays, n, b)

        def epoch(e):
            runner.train_epoch(e, e * steps)
    else:
        ens = EnsembleTrainer(cfg, dev, n_models=k)
        ens.set_corpus_arrays("train", *arrays, n, b)
        state = ens.init_state()

        def epoch(e):
            ens.train_epoch(*state, e, e * steps)
    epoch(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch(1)
    wall = (time.perf_counter() - t0) * 1e3 / steps
    return (wall, *profiled(lambda: epoch(2), steps))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default="lstm,simple,bert,cnn")
    ap.add_argument("--members", default="1,4",
                    help="ensemble sizes to run beside the single trainer")
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 1

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops.common import exact_f32
    from audio_tokens_tpu_torch.tools.bench_training import synthetic_corpus

    exact_f32()
    dev = torch.device("cuda", 0)
    for family in args.models.split(","):
        cfg = AudioTokensConfig(vocab_size=500, num_classes=543,
                                max_seq_len=1728, log_every_steps=0,
                                **FAMILIES[family])
        n = cfg.training_batch_size * args.batches
        arrays = synthetic_corpus(cfg, cfg.training_batch_size, n,
                                  np.random.default_rng(0))
        for k in [0] + [int(m) for m in args.members.split(",")]:
            wall, busy, kernels, host = run(cfg, dev, arrays, n, k)
            print(f"[profile {family}] "
                  f"{'single trainer' if k == 0 else f'ensemble K {k}'}: "
                  f"{wall:.3f} ms a step (host clock), card busy {busy:.3f} "
                  f"ms a step, idle {max(0.0, 1 - busy / wall):.1%}")
            for ms, count, key in kernels:
                print(f"    card {ms:9.3f} ms a step  x{count:<4d} {key[:90]}")
            for ms, count, key in host:
                print(f"    host {ms:9.3f} ms a step  x{count:<4d} {key[:90]}")
            torch.cuda.empty_cache()
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
