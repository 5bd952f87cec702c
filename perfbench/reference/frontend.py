"""Waveform rows -> log-mel frames -> nearest centroid, from the
definitions: a periodic Hann window, the real DFT as a product with its
cos / sin basis, power, the HTK mel filterbank without normalization
(0 Hz to sr / 2), ``10 log10(max(x, 1e-10))``, each frame divided by its
L2 norm plus 1e-10, and the centroid with the least ``||c||^2 - 2 f.c``
(the lowest index among equal scores).

The served rows are the caller's layout: each clip centered in
``n_fft / 2 + samples + n_fft / 2`` samples with reflection at both ends
and zeros past a short clip's end; frame i starts at sample i * hop.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.precision import dtype_of, matmul

AMIN = 1e-10
NORM_EPS = 1e-10


def hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def dft_basis(n_fft: int) -> np.ndarray:
    """(n_fft, 2 * (n_fft // 2 + 1)): windowed cos, then -sin, of every
    bin from 0 to n_fft / 2."""
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    angle = 2.0 * np.pi * t * k / n_fft
    w = hann(n_fft)[:, None]
    return np.concatenate([np.cos(angle) * w, -np.sin(angle) * w], axis=1)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) HTK triangles over the bin frequencies
    0 .. sr // 2, corners equally spaced in mel from 0 to sr / 2."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sr // 2, n_fft // 2 + 1)
    corners = to_hz(np.linspace(to_mel(0.0), to_mel(sr / 2.0), n_mels + 2))
    lo, mid, hi = corners[:-2], corners[1:-1], corners[2:]
    rise = (freqs[:, None] - lo[None, :]) / (mid - lo)[None, :]
    fall = (hi[None, :] - freqs[:, None]) / (hi - mid)[None, :]
    return np.maximum(0.0, np.minimum(rise, fall))


class Frontend:
    """The front end's constants on ``device``, and its functions at a
    precision."""

    def __init__(self, cfg: dict, device: torch.device):
        self.n_fft, self.hop = cfg["n_fft"], cfg["hop_length"]
        self.samples = int(cfg["common_sr"] * cfg["clip_seconds"])
        self.frames = 1 + self.samples // self.hop
        self.padded = self.samples + self.n_fft
        self.n_bins = self.n_fft // 2 + 1
        self.basis = torch.from_numpy(dft_basis(self.n_fft)).to(device)
        self.fbank = torch.from_numpy(mel_filterbank(
            cfg["common_sr"], self.n_fft, cfg["n_mels"])).to(device)

    def log_mel(self, rows: torch.Tensor, precision: str) -> torch.Tensor:
        """(B, >= padded) waveform rows -> (B, frames, n_mels) dB."""
        dt = dtype_of(precision)
        x = rows[:, :self.padded].to(dt)
        frames = x.unfold(1, self.n_fft, self.hop)[:, :self.frames]
        spec = matmul(frames, self.basis, precision)
        re, im = spec[..., :self.n_bins], spec[..., self.n_bins:]
        mel = matmul(re * re + im * im, self.fbank, precision)
        return 10.0 * torch.log10(torch.clamp(mel, min=AMIN))

    def features(self, rows: torch.Tensor, precision: str) -> torch.Tensor:
        """(B, frames, n_mels) log-mel frames over their L2 norms."""
        db = self.log_mel(rows, precision)
        return db / (torch.linalg.vector_norm(db, dim=-1, keepdim=True)
                     + NORM_EPS)


def scores(feats: torch.Tensor, centroids: torch.Tensor,
           precision: str) -> torch.Tensor:
    """(..., K) ``||c||^2 - 2 f.c``: the order of the squared distances."""
    dt = dtype_of(precision)
    c = centroids.to(dt)
    return (c * c).sum(1) - 2.0 * matmul(feats, c.t(), precision)


def nearest(feats: torch.Tensor, centroids: torch.Tensor,
            precision: str) -> torch.Tensor:
    return torch.argmin(scores(feats, centroids, precision), dim=-1)


def token_gap(feats64: torch.Tensor, centroids: torch.Tensor,
              tokens: torch.Tensor) -> float:
    """The widest gap by which a given token's score lies above the best
    score, both in float64 from float64 features: 0 where every token is
    a nearest centroid, small where a token lost a near tie by rounding,
    large where a token is wrong."""
    s = scores(feats64, centroids, "float64")
    got = torch.gather(s, -1, tokens.long().unsqueeze(-1)).squeeze(-1)
    return float((got - s.amin(-1)).max())
