"""Kernel B1 (``csrc/tokenizer.cu``): padded waveform -> token ids in one kernel.

Replaces ``audio_tokens_tpu/ops/pallas_tokenizer.py::_kernel`` (launched by
``TokenizerKernel.__call__``).  Per frame: windowed real DFT -> power ->
mel -> dB -> L2 normalize -> nearest centroid, with only waveform bytes read
and int32 tokens written.  On the H100 it is bound by float32 FMA issue in
the DFT product (57.8 GFLOP per batch of 64 ten-second clips against 56 MB
of waveform); the source explains how the design keeps the window, power
and features in shared memory and streams the 1 MB DFT basis from L2.

What the TPU kernel needed and this one does not: the 128-multiple frame
tile plan, the over-allocated host buffer (``alloc_blocks``) and the VMEM
budget planners.  The CUDA kernel masks its own ragged tile and reads the
first ``padded_len`` samples of rows of any length >= ``padded_len``.

The DFT basis drops the Nyquist bin (its filterbank row is exactly zero, so
the mel sums are unchanged) and keeps re/im of bins 0..n_fft/2-1 as one
(n_fft, n_fft) matrix; only the ``highest`` (float32) tier is ported.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_tokens_tpu_torch.ops import _build
from audio_tokens_tpu_torch.ops.common import check_cuda_tensor
from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin_plain
from audio_tokens_tpu_torch.ops.mel import (
    decode_wire,
    dft_filters,
    mel_filterbank,
)


def log_mel_plain(padded: torch.Tensor, basis: torch.Tensor,
                  fbank: torch.Tensor, n_fft: int, hop: int, padded_len: int,
                  n_frames: int) -> torch.Tensor:
    """The kernel's features before normalization, in plain PyTorch:
    padded (B, >= padded_len) f32 -> (B, n_frames, M) dB, with the pruned
    basis (n_fft, 2 nb) and filterbank (nb, M)."""
    nb = basis.shape[1] // 2
    frames = padded[:, :padded_len].unfold(1, n_fft, hop)[:, :n_frames]
    spec = torch.matmul(frames, basis)  # (B, T, 2 nb)
    re, im = spec[..., :nb], spec[..., nb:]
    mel = torch.matmul(re * re + im * im, fbank)
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def tokenize_plain(padded: torch.Tensor, basis: torch.Tensor,
                   fbank: torch.Tensor, centroids: torch.Tensor, n_fft: int,
                   hop: int, padded_len: int, n_frames: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: padded (B, >= padded_len)
    f32 -> (B, n_frames) int32."""
    db = log_mel_plain(padded, basis, fbank, n_fft, hop, padded_len, n_frames)
    b, t, m = db.shape
    return vq_argmin_plain(db.reshape(b * t, m), centroids,
                           normalize=True).reshape(b, t)


def _lib():
    lib = _build.load("tokenizer")
    fn = lib.atk_tokenize
    if fn.argtypes is None:
        P, I, L = _build.P, _build.I, _build.L
        fn.argtypes = [P, I, L, L, I, I, I, P, I, P, I, P, P, I, P, P]
        fn.restype = I
    return lib


class TokenizerKernel:
    """Device-resident basis, filterbank and centroids + the wrapper
    ``(B, >= padded_len) waveforms -> (B, n_frames) int32 tokens``.

    ``TokenizerKernel.launches`` counts kernel launches (all instances).
    """

    launches = 0

    def __init__(self, sample_rate: int, n_mels: int, n_fft: int, hop: int,
                 n_frames: int, centroids: np.ndarray,
                 device: torch.device):
        if n_fft % 2:
            raise ValueError("TokenizerKernel requires an even n_fft")
        self.device = torch.device(device)
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.hop = hop
        self.n_frames = n_frames
        self.padded_len = (n_frames - 1) * hop + n_fft
        n_freq = n_fft // 2 + 1
        nb = n_freq - 1
        w = dft_filters(n_fft)[:, 0, :].T  # (n_fft, 2 n_freq)
        basis = np.concatenate([w[:, :nb], w[:, n_freq : n_freq + nb]], axis=1)
        fb = mel_filterbank(n_freq, n_mels, sample_rate)
        if fb[-1].any():
            raise ValueError("Nyquist filterbank row expected to be zero")
        cent = np.ascontiguousarray(centroids, dtype=np.float32)
        if cent.ndim != 2 or cent.shape[0] < 1 or cent.shape[1] != n_mels:
            raise ValueError(f"centroids must be (K >= 1, {n_mels}), "
                             f"got {cent.shape}")
        self.basis = torch.from_numpy(np.ascontiguousarray(basis)).to(self.device)
        self.fbank = torch.from_numpy(np.ascontiguousarray(fb[:-1])).to(self.device)
        self.centroids = torch.from_numpy(cent).to(self.device)
        self.c2 = (self.centroids * self.centroids).sum(1)

    def log_mel_plain(self, padded: torch.Tensor) -> torch.Tensor:
        """(B, n_frames, M) dB features as the plain version computes them."""
        return log_mel_plain(decode_wire(padded), self.basis, self.fbank,
                             self.n_fft, self.hop, self.padded_len,
                             self.n_frames)

    def plain(self, padded: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version, on whatever device ``padded`` is."""
        return tokenize_plain(decode_wire(padded), self.basis, self.fbank,
                              self.centroids, self.n_fft, self.hop,
                              self.padded_len, self.n_frames)

    def __call__(self, padded: torch.Tensor) -> torch.Tensor:
        if padded.device.type == "cpu":
            return self.plain(padded)
        padded = decode_wire(padded)
        check_cuda_tensor("padded", padded, torch.float32, 2)
        if padded.device != self.device:
            raise ValueError(f"batch on {padded.device}, kernel on {self.device}")
        b, stride = padded.shape
        if stride < self.padded_len:
            raise ValueError(f"rows of {stride} samples are shorter than "
                             f"padded_len {self.padded_len}")
        out = torch.empty((b, self.n_frames), dtype=torch.int32,
                          device=self.device)
        lib = _lib()
        with torch.cuda.device(self.device):
            rc = lib.atk_tokenize(
                padded.data_ptr(), b, stride, self.padded_len, self.n_frames,
                self.hop, self.n_fft, self.basis.data_ptr(),
                self.basis.shape[1] // 2, self.fbank.data_ptr(), self.n_mels,
                self.centroids.data_ptr(), self.c2.data_ptr(),
                self.centroids.shape[0], out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _build.check(lib, rc, "tokenize")
        TokenizerKernel.launches += 1
        return out
