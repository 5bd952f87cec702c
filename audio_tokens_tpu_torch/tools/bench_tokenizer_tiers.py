"""Kernel B1's precision tiers A/B: clips/s and token agreement per combo.

Counterpart of ``audio_tokens_tpu/tools/bench_tokenizer_tiers.py``.  Every
(``tokenizer_precision``, ``tokenizer_vq_precision``) combo of ``COMBOS``
runs in one process on one shared batch of random ten-second clips, at each
vocabulary of ``--vocab`` (500, the package default, and 16,384, where the
centroid-distance product is ~97% of the kernel's work), so the ratios are
honest under clock drift; agreement is against the all-``highest`` kernel
of the same run and vocabulary.  On the card the time of a batch comes from
CUDA events over ``--iters`` launches after a warm-up.  ``--torch-mirror``
also times the reference pipeline's torch-CPU mirror (``tools/
torch_mirror.py``, on the host at 16 threads: the speedup's denominator)
at the last vocabulary, best of 3 passes over 4 clips, and its tokens'
agreement with the all-``highest`` kernel's on clip 0.

Usage: python -m audio_tokens_tpu_torch.tools.bench_tokenizer_tiers
       [--vocab 500 16384] [--batch 64] [--iters 10] [--seconds 10]
       [--device cuda:0] [--torch-mirror]
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
    their rows (vocab, tier, vq_tier, ms a batch, clips_per_s, agreement).
    With ``--torch-mirror`` the last row is the mirror's: tier
    ``"torch-mirror"``, vq_tier None, ms a clip, clips/s on the host,
    agreement with the all-``highest`` kernel on clip 0, threads."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--vocab", type=int, nargs="+", default=[500, 16384])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--torch-mirror", action="store_true",
                        help="also time the torch-CPU mirror of the "
                             "reference pipeline (stft -> mel -> cdist "
                             "argmin) at the last vocabulary: the speedup "
                             "denominator")
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
    if args.torch_mirror:
        rows.append(mirror_row(clips, cents, exact[0].cpu().numpy()))
    return rows


def mirror_row(clips, cents: np.ndarray, exact0: np.ndarray) -> dict:
    """The torch-CPU mirror at ``cents``: ms a clip and clips/s, best of 3
    passes over 4 clips, and its tokens' agreement with ``exact0`` (the
    all-``highest`` kernel's tokens of clip 0), with the frames where they
    differ (``frames_apart``).  Torch's thread count is restored
    afterwards."""
    from audio_tokens_tpu_torch.tools.torch_mirror import (best_of_3_rate,
                                                           make_one_clip)

    threads = torch.get_num_threads()
    try:
        one_clip = make_one_clip(SR, N_MELS, N_FFT, HOP, cents)
        ref = one_clip(clips[0]).numpy()
        same = ref == exact0[:len(ref)]
        agree = float(same.mean())
        cps = best_of_3_rate(clips[:4], one_clip)
        mirror_threads = torch.get_num_threads()
    finally:
        torch.set_num_threads(threads)
    print(f"torch-cpu mirror @ vocab {len(cents)}: {1e3 / cps:.0f} ms/clip "
          f"-> {cps:.1f} clips/s at {mirror_threads} threads (agreement vs "
          f"exact kernel {agree * 100:.2f}%)", flush=True)
    return dict(vocab=len(cents), tier="torch-mirror", vq_tier=None,
                ms=1e3 / cps, clips_per_s=cps, agreement=agree,
                threads=mirror_threads,
                frames_apart=np.flatnonzero(~same).tolist())


if __name__ == "__main__":
    main()
