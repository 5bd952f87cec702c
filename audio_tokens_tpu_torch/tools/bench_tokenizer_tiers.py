"""Kernel B1's precision tiers A/B: clips/s and token agreement per combo.

Counterpart of ``audio_tokens_tpu/tools/bench_tokenizer_tiers.py``.  Every
(``tokenizer_precision``, ``tokenizer_vq_precision``) combo of ``COMBOS``
runs in one process on one shared batch of random ten-second clips, at each
vocabulary of ``--vocab`` (500, the package default, and 16,384, where the
centroid-distance product is ~97% of the kernel's work), so the ratios are
honest under clock drift; agreement is against the all-``highest`` kernel
of the same run and vocabulary.  On the card the time of a batch comes from
CUDA events over ``--iters`` launches after a warm-up.

Usage: python -m audio_tokens_tpu_torch.tools.bench_tokenizer_tiers
       [--vocab 500 16384] [--batch 64] [--iters 10] [--seconds 10]
       [--device cuda:0]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

# (tokenizer_precision, tokenizer_vq_precision) combos benchmarked, in order
COMBOS = (
    ("highest", "highest"),
    ("highest", "bf16x3"),
    ("bf16x3", "bf16x3"),
    ("default", "default"),
)
SR, N_MELS, N_FFT, HOP = 22050, 64, 512, 128


def batch_ms(fn, iters: int, device: torch.device) -> float:
    """ms a call of ``fn``: CUDA events on the card, else the host clock."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run every combo at every vocabulary; print a line each and return
    their rows (vocab, tier, vq_tier, ms, clips_per_s, agreement)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--vocab", type=int, nargs="+", default=[500, 16384])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)

    from audio_tokens_tpu_torch.ops.common import exact_f32
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.mel import MelFrontend

    exact_f32()
    device = torch.device(args.device)
    rng = np.random.default_rng(0)
    fe = MelFrontend("cpu", SR, N_MELS, N_FFT, HOP, int(SR * args.seconds))
    clips = [rng.standard_normal(int(SR * args.seconds)).astype(np.float32)
             for _ in range(args.batch)]
    x = torch.from_numpy(fe.prepare_batch(clips)[0]).to(device)
    rows = []
    for vocab in args.vocab:
        cents = rng.standard_normal((vocab, N_MELS)).astype(np.float32)
        cents /= np.linalg.norm(cents, axis=1, keepdims=True)
        exact = None
        for tier, vq in COMBOS:
            kern = TokenizerKernel(SR, N_MELS, N_FFT, HOP, fe.frames_max,
                                   cents, device, tier, vq)
            toks = kern(x)
            if exact is None:
                exact = toks
            ms = batch_ms(lambda: kern(x), args.iters, device)
            agree = float((toks == exact).float().mean())
            rows.append(dict(vocab=vocab, tier=tier, vq_tier=vq, ms=ms,
                             clips_per_s=args.batch / ms * 1e3,
                             agreement=agree))
            print(f"vocab {vocab} tier={tier}/{vq}: "
                  f"{args.batch / ms * 1e3:7.0f} clips/s ({ms:.3f} ms/batch"
                  f"), agreement vs exact {agree * 100:.4f}%", flush=True)
            del kern
    return rows


if __name__ == "__main__":
    main()
