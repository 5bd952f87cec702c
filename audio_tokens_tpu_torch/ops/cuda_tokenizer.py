"""Kernel B1 (``csrc/tokenizer.cu``): padded waveform -> token ids in one kernel.

Replaces ``audio_tokens_tpu/ops/pallas_tokenizer.py::_kernel`` (launched by
``TokenizerKernel.__call__``).  Per frame: windowed real DFT -> power ->
mel -> dB -> L2 normalize -> nearest centroid, with only waveform bytes read
and int32 tokens written.  On the H100 it is bound by float32 FMA issue in
the DFT product (57.8 GFLOP per batch of 64 ten-second clips against 56 MB
of waveform); the source explains how the design keeps the window, power
and features in shared memory, streams the 1 MB DFT basis through a
``cp.async`` ring, and holds 8 frames x 4 bins (re and im) a thread.

What the TPU kernel needed and this one does not: the 128-multiple frame
tile plan, the over-allocated host buffer (``alloc_blocks``) and the VMEM
budget planners.  The CUDA kernel masks its own ragged tile and reads the
first ``padded_len`` samples of rows of any length >= ``padded_len``.

The DFT basis drops the Nyquist bin (its filterbank row is exactly zero, so
the mel sums are unchanged) and keeps re/im of bins 0..n_fft/2-1 as one
(n_fft, n_fft) matrix; only the ``highest`` (float32) tier is ported.  The
kernel's copy is padded with zeros to whole ring stages (rows a multiple of
16) and whole passes (bins a multiple of 128), the filterbank's to the same
bins: the zeros add nothing to any sum.

``TokenizerKernel`` is an ``nn.Module`` whose buffers are the basis,
filterbank and centroids, so that a traced serving program owns them.  Its
forward calls the custom op ``atk::tokenize``: the op's CPU registration is
the plain PyTorch version (on the unpadded views of the kernel's copies),
its CUDA registration launches the kernel (and counts the launch) or
raises, and its fake only allocates the output.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

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


@torch.library.custom_op("atk::tokenize", mutates_args=(),
                        device_types="cpu")
def _tokenize_op(padded: torch.Tensor, basis: torch.Tensor,
                 fbank: torch.Tensor, centroids: torch.Tensor,
                 c2: torch.Tensor, n_fft: int, hop: int, padded_len: int,
                 n_frames: int) -> torch.Tensor:
    """padded (B, >= padded_len) f32 with the kernel's zero-padded basis
    (rows, 2 nbp) and filterbank (nbp, M), centroids (K, M) and their
    squared norms c2 (K,) -> (B, n_frames) int32."""
    nb, nbp = n_fft // 2, basis.shape[1] // 2
    plain_basis = torch.cat([basis[:n_fft, :nb], basis[:n_fft, nbp:nbp + nb]],
                            dim=1)
    return tokenize_plain(padded, plain_basis, fbank[:nb], centroids, n_fft,
                          hop, padded_len, n_frames)


@_tokenize_op.register_kernel("cuda")
def _tokenize_cuda(padded, basis, fbank, centroids, c2, n_fft, hop,
                   padded_len, n_frames):
    check_cuda_tensor("padded", padded, torch.float32, 2)
    for name, t, nd in (("basis", basis, 2), ("fbank", fbank, 2),
                        ("centroids", centroids, 2), ("c2", c2, 1)):
        check_cuda_tensor(name, t, torch.float32, nd)
    if len({t.device for t in (padded, basis, fbank, centroids, c2)}) != 1:
        raise ValueError(f"batch on {padded.device}, kernel tensors on "
                         f"{basis.device}")
    b, stride = padded.shape
    if stride < padded_len:
        raise ValueError(f"rows of {stride} samples are shorter than "
                         f"padded_len {padded_len}")
    out = torch.empty((b, n_frames), dtype=torch.int32, device=padded.device)
    lib = _lib()
    with torch.cuda.device(padded.device):
        rc = lib.atk_tokenize(
            padded.data_ptr(), b, stride, padded_len, n_frames, hop,
            basis.shape[0], basis.data_ptr(), basis.shape[1] // 2,
            fbank.data_ptr(), fbank.shape[1], centroids.data_ptr(),
            c2.data_ptr(), centroids.shape[0], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "tokenize")
    TokenizerKernel.launches += 1
    return out


@_tokenize_op.register_fake
def _tokenize_fake(padded, basis, fbank, centroids, c2, n_fft, hop,
                   padded_len, n_frames):
    return padded.new_empty((padded.shape[0], n_frames), dtype=torch.int32)


class TokenizerKernel(nn.Module):
    """Device-resident basis, filterbank and centroids (buffers) + the
    wrapper ``(B, >= padded_len) waveforms -> (B, n_frames) int32 tokens``.

    ``TokenizerKernel.launches`` counts kernel launches (all instances).
    """

    launches = 0

    def __init__(self, sample_rate: int, n_mels: int, n_fft: int, hop: int,
                 n_frames: int, centroids: np.ndarray,
                 device: torch.device):
        super().__init__()
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

        def buffer(name, array):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(array)).to(self.device))

        buffer("basis", basis)
        buffer("fbank", fb[:-1])
        # the kernel's zero-padded copies: rows to whole ring stages, bins
        # to whole passes (csrc/tokenizer.cu)
        rows, nbp = -(-n_fft // 16) * 16, -(-nb // 128) * 128
        kb = np.zeros((rows, 2 * nbp), np.float32)
        kb[:n_fft, :nb] = basis[:, :nb]
        kb[:n_fft, nbp:nbp + nb] = basis[:, nb:]
        kf = np.zeros((nbp, n_mels), np.float32)
        kf[:nb] = fb[:-1]
        buffer("_kbasis", kb)
        buffer("_kfbank", kf)
        buffer("centroids", cent)
        self.register_buffer("c2", (self.centroids * self.centroids).sum(1))

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

    def forward(self, padded: torch.Tensor) -> torch.Tensor:
        return torch.ops.atk.tokenize(
            decode_wire(padded), self._kbasis, self._kfbank, self.centroids,
            self.c2, self.n_fft, self.hop, self.padded_len, self.n_frames)
