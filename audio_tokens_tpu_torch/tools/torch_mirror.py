"""Torch-CPU mirror of the reference wav -> tokens pipeline: the speedup
denominator for ``tools/bench_tokenizer_tiers.py --torch-mirror`` (and the
port's benchmark).

Counterpart of ``audio_tokens_tpu/tools/torch_mirror.py``, with the same
numerics.  The reference's own stack (torchaudio decode + FAISS
IndexFlatL2) is not installed, so this mirrors the kernels it ran:
``torch.stft`` (center, reflect: the torchaudio ``MelSpectrogram``
contract) -> the mel filterbank product -> dB -> L2 normalize -> ``cdist``
argmin (reference ``processors/spectrogram_generator.py:28-34,123-126`` and
``processors/spec_tokenizer.py:76-78,123-127``).  One definition, so that
the benchmarks cannot drift apart numerically.

It runs on the host CPU on purpose, at the reference's thread count (16,
``spectrogram_generator.py:15``): it is the reference's cost, the number a
card's rate is divided by, not a device path of the port, so it has no
kernel and never touches the card.  The window and the filterbank come from
the port's own ``ops/mel.py``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from audio_tokens_tpu_torch.ops.mel import hann_window, mel_filterbank

REFERENCE_THREADS = 16  # reference: spectrogram_generator.py:15


def make_one_clip(sample_rate: int, n_mels: int, n_fft: int, hop: int,
                  centroids: np.ndarray):
    """-> a function (wav (n,) f32 numpy) -> the clip's (frames,) int64
    token ids, on the host CPU.  Sets torch's thread count to the
    reference's 16 (the caller restores its own)."""
    torch.set_num_threads(REFERENCE_THREADS)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate))
    win = torch.from_numpy(hann_window(n_fft))
    cent = torch.from_numpy(np.asarray(centroids, np.float32))

    def one_clip(x: np.ndarray) -> torch.Tensor:
        wav = torch.from_numpy(x)
        spec = torch.stft(wav, n_fft, hop, window=win, center=True,
                          pad_mode="reflect", return_complex=True)
        power = spec.real**2 + spec.imag**2  # (F, T)
        mel_db = 10.0 * torch.log10(torch.clamp(fb.T @ power, min=1e-10))
        frames = mel_db.T.contiguous()
        frames = frames / (frames.norm(dim=1, keepdim=True) + 1e-10)
        return torch.cdist(frames, cent).argmin(dim=1)

    return one_clip


def best_of_3_rate(clips, one_clip) -> float:
    """clips/s, best of 3 passes over ``clips`` (the CPU baseline is
    load-sensitive; its fastest pass gives the most conservative
    speedup)."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for x in clips:
            one_clip(x)
        best = min(best, time.perf_counter() - t0)
    return len(clips) / best
