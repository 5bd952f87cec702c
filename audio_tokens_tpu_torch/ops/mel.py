"""Mel-spectrogram frontend in plain PyTorch.

Counterpart of ``audio_tokens_tpu/ops/mel.py``: the same numerics
(torchaudio defaults: periodic Hann window, power 2, HTK mel scale without
filter normalization, f_min 0 / f_max sr/2, center=True with per-clip
reflect padding, ``10*log10(max(x, 1e-10))``).  The numpy filter functions
below are copies of the JAX module's (``tests/test_torch_port.py`` holds
them equal): importing that module would import jax.

Framing is ``Tensor.unfold`` (a view, any hop) followed by one matmul
against the windowed real-DFT basis; no convolution, so cuDNN and its TF32
default never enter.  On the serving path this frontend only runs when the
tokenizer's megakernel (kernel B1, ``ops/cuda_tokenizer.py``) is not
engaged: for per-clip min-max normalization.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


def decode_wire(padded_batch: torch.Tensor) -> torch.Tensor:
    """Waveform wire format -> f32: int16 PCM rows become s/32768; float
    rows pass through (the rule of ``audio_tokens_tpu.ops.mel.decode_wire``)."""
    if padded_batch.dtype == torch.int16:
        return padded_batch.to(torch.float32) * (1.0 / 32768.0)
    return padded_batch


def hann_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(dtype)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular HTK-scale mel filterbank, shape (n_freqs, n_mels), norm=None."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(dtype)


def dft_filters(n_fft: int, dtype=np.float32) -> np.ndarray:
    """Hann-windowed real-DFT basis as conv filters, shape (2*n_freq, 1, n_fft).

    Output channel k in [0, n_freq) is Re(X_k); channel n_freq+k is Im(X_k)
    so that conv(x, W)[2 blocks] reproduces rfft(x * window).
    """
    n_freq = n_fft // 2 + 1
    t = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freq, dtype=np.float64)[:, None]
    angle = 2.0 * np.pi * k * t[None, :] / n_fft
    win = hann_window(n_fft, dtype=np.float64)
    real = np.cos(angle) * win
    imag = -np.sin(angle) * win
    return np.concatenate([real, imag], axis=0)[:, None, :].astype(dtype)


def reflect_pad_clip(
    wave: np.ndarray, total_len: int, n_fft: int
) -> np.ndarray:
    """Host-side: center a clip in a fixed-length buffer with per-clip reflect pad.

    Layout: [reflect(head, n_fft//2) | clip | reflect(tail, n_fft//2) | zeros]
    with total buffer length ``n_fft//2 + total_len + n_fft//2``.  The device
    program then frames with VALID padding, so frame i of clip j equals the
    reference's centered frame i regardless of other clips' lengths.
    """
    pad = n_fft // 2
    n = wave.shape[0]
    if n > total_len:
        wave = wave[:total_len]
        n = total_len
    if n < pad + 1:
        raise ValueError(f"clip too short for reflect pad: {n} <= {pad}")
    out = np.zeros(pad + total_len + pad, dtype=np.float32)
    out[pad : pad + n] = wave
    out[:pad] = wave[1 : pad + 1][::-1]
    out[pad + n : pad + n + pad] = wave[n - pad - 1 : n - 1][::-1]
    return out


def num_frames(n_samples: int, hop_length: int) -> int:
    """Valid (centered) frame count for a clip of n_samples."""
    return 1 + n_samples // hop_length


def amplitude_to_db(power: torch.Tensor, amin: float = 1e-10) -> torch.Tensor:
    """torchaudio AmplitudeToDB(stype='power', top_db=None), ref=1.0."""
    return 10.0 * torch.log10(torch.clamp(power, min=amin))


class MelFrontend(nn.Module):
    """Batched waveform -> log-mel with fixed shapes.

    ``forward`` takes a host-prepared padded batch (see
    :func:`reflect_pad_clip`) of shape (B, >= pad+T+pad) and returns
    (B, n_mels, frames_max) float32.  The filter tensors are buffers on
    ``device`` (so that a traced serving program owns them); inputs must be
    on the same device.
    """

    def __init__(
        self,
        device: torch.device,
        sample_rate: int = 22050,
        n_mels: int = 64,
        n_fft: int = 512,
        hop_length: int = 128,
        clip_samples: int = 220500,
    ):
        super().__init__()
        self.device = torch.device(device)
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.n_freq = n_fft // 2 + 1
        self.hop_length = hop_length
        self.clip_samples = clip_samples
        self.frames_max = num_frames(clip_samples, hop_length)
        self.padded_len = n_fft // 2 + clip_samples + n_fft // 2
        self.register_buffer("_basis", torch.from_numpy(
            np.ascontiguousarray(dft_filters(n_fft)[:, 0, :].T)).to(self.device))
        self.register_buffer("_fbank", torch.from_numpy(
            mel_filterbank(self.n_freq, n_mels, sample_rate)).to(self.device))

    def prepare_batch(self, waves) -> Tuple[np.ndarray, np.ndarray]:
        """Host: list of 1-D float arrays -> (padded (B, padded_len), lengths (B,))."""
        batch = np.zeros((len(waves), self.padded_len), dtype=np.float32)
        lengths = np.zeros((len(waves),), dtype=np.int32)
        for i, w in enumerate(waves):
            batch[i] = reflect_pad_clip(
                np.asarray(w, dtype=np.float32), self.clip_samples, self.n_fft)
            lengths[i] = min(len(w), self.clip_samples)
        return batch, lengths

    def mel_frames(self, padded_batch: torch.Tensor) -> torch.Tensor:
        """(B, >= padded_len) -> (B, T, n_mels) log-mel, frame-major
        (VQ-friendly layout)."""
        x = decode_wire(padded_batch)[:, : self.padded_len]
        frames = x.unfold(1, self.n_fft, self.hop_length)[:, : self.frames_max]
        spec = torch.matmul(frames, self._basis)  # (B, T, 2F)
        re, im = spec[..., : self.n_freq], spec[..., self.n_freq :]
        mel = torch.matmul(re * re + im * im, self._fbank)
        return amplitude_to_db(mel)

    def forward(self, padded_batch: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, n_mels, T): the reference's artifact layout."""
        return self.mel_frames(padded_batch).transpose(1, 2)

    def frame_counts(self, lengths: torch.Tensor) -> torch.Tensor:
        return 1 + lengths // self.hop_length

    def normalized(self, padded_batch: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
        """Mel dB, then per-clip min-max to [0,1] over the VALID frames only;
        constant clips (digital silence) map to zeros, never NaN."""
        mel = self(padded_batch)
        n_valid = self.frame_counts(lengths.to(mel.device))
        t_idx = torch.arange(mel.shape[-1], device=mel.device)[None, None, :]
        valid = t_idx < n_valid[:, None, None]
        big = torch.finfo(mel.dtype).max
        mn = torch.where(valid, mel, big).amin(dim=(1, 2), keepdim=True)
        mx = torch.where(valid, mel, -big).amax(dim=(1, 2), keepdim=True)
        rng_ok = mx > mn
        return torch.where(
            rng_ok, (mel - mn) / torch.where(rng_ok, mx - mn, 1.0), 0.0)
