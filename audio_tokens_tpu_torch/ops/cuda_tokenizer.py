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
(n_fft, n_fft) matrix.  The kernel's copy is padded with zeros to whole ring
stages (rows a multiple of 16) and whole passes (bins a multiple of 128),
the filterbank's to the same bins: the zeros add nothing to any sum.

The precision tiers (``ops/tiers.py``) of the JAX kernel: ``tier`` sets the
DFT and mel products, ``vq_tier`` the centroid-distance product, each
``highest`` (f32, today's kernel), ``bf16x3`` or ``default`` (bf16 on the
tensor cores).  Their bf16 operands are split once, here, when the kernel is
built: the basis and the filterbank transposed (bins x samples, bands x
bins; rows to a multiple of 32, bins of 64, bands of 16) and the centroids
as the argmin's image (``cuda_vq.tier_image``: chunks of 128 centroids,
slices of 64 bands), as the JAX kernel splits its centroids on the host.
The tensor-core DFT needs hop a multiple of 16 and at most 128 mel bands;
other shapes raise ``ValueError`` on the card.  The bf16 argmin takes any
number of bands, as the JAX megakernel does (``kernel_fits``).

``TokenizerKernel`` is an ``nn.Module`` whose buffers are the basis,
filterbank and centroids, so that a traced serving program owns them.  Its
forward calls the custom op ``atk::tokenize``: the op's CPU registration is
the plain PyTorch version (on the unpadded views of the kernel's copies),
its CUDA registration launches the kernel (and counts the launch) or
raises, and its fake only allocates the output.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from audio_tokens_tpu_torch.ops import _build
from audio_tokens_tpu_torch.ops.common import check_cuda_tensor
from audio_tokens_tpu_torch.ops.cuda_vq import (
    MAX_SMEM,
    bf16_split_rows,
    tier_image,
    vq_argmin_plain,
)
from audio_tokens_tpu_torch.ops.mel import (
    decode_wire,
    dft_filters,
    mel_filterbank,
)
from audio_tokens_tpu_torch.ops.tiers import TIERS, check_tier, tier_matmul

ROW_STAGE, BIN_PASS = 32, 64  # the tensor-core DFT's sample and bin steps
# the tiered argmin's chunk (centroids) and slice (k-steps of 16 bands):
# csrc/common.cuh's kB1Chunk, kB1Ks
ARGMIN_CHUNK, ARGMIN_KS = 128, 4


def log_mel_plain(padded: torch.Tensor, basis: torch.Tensor,
                  fbank: torch.Tensor, n_fft: int, hop: int, padded_len: int,
                  n_frames: int, tier: str = "highest") -> torch.Tensor:
    """The kernel's features before normalization, in plain PyTorch:
    padded (B, >= padded_len) f32 -> (B, n_frames, M) dB, with the pruned
    basis (n_fft, 2 nb) and filterbank (nb, M), the DFT and mel products at
    ``tier``."""
    nb = basis.shape[1] // 2
    frames = padded[:, :padded_len].unfold(1, n_fft, hop)[:, :n_frames]
    spec = tier_matmul(frames, basis, tier)  # (B, T, 2 nb)
    re, im = spec[..., :nb], spec[..., nb:]
    mel = tier_matmul(re * re + im * im, fbank, tier)
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def tokenize_plain(padded: torch.Tensor, basis: torch.Tensor,
                   fbank: torch.Tensor, centroids: torch.Tensor, n_fft: int,
                   hop: int, padded_len: int, n_frames: int,
                   tier: str = "highest",
                   vq_tier: str = "highest") -> torch.Tensor:
    """The kernel's function in plain PyTorch: padded (B, >= padded_len)
    f32 -> (B, n_frames) int32."""
    db = log_mel_plain(padded, basis, fbank, n_fft, hop, padded_len, n_frames,
                       tier)
    b, t, m = db.shape
    return vq_argmin_plain(db.reshape(b * t, m), centroids, normalize=True,
                           tier=vq_tier).reshape(b, t)


def _lib():
    lib = _build.load("tokenizer")
    fn = lib.atk_tokenize_tier
    if fn.argtypes is None:
        P, I, L = _build.P, _build.I, _build.L
        fn.argtypes = [
            P, I, L, L, I, I, I, P, I, P, I, P, I, I, P, P, P, I, P, L, I, I,
            P, P]
        fn.restype = I
        lib.atk_tokenize_tier_smem.argtypes = [I, I, I, I, I]
        lib.atk_tokenize_tier_smem.restype = L
    return lib


@torch.library.custom_op("atk::tokenize", mutates_args=(),
                        device_types="cpu")
def _tokenize_op(padded: torch.Tensor, basis: torch.Tensor,
                 fbank: torch.Tensor, centroids: torch.Tensor,
                 c2: torch.Tensor, n_fft: int, hop: int, padded_len: int,
                 n_frames: int, tier: str = "highest",
                 vq_tier: str = "highest",
                 tbasis: Optional[torch.Tensor] = None,
                 tfbank: Optional[torch.Tensor] = None,
                 tcent: Optional[torch.Tensor] = None) -> torch.Tensor:
    """padded (B, >= padded_len) f32 with the kernel's zero-padded basis
    (rows, 2 nbp) and filterbank (nbp, M), centroids (K, M) and their
    squared norms c2 (K,) -> (B, n_frames) int32.  At the bf16 tiers the
    kernel also takes the split operands ``TokenizerKernel`` made: tbasis
    (planes, 2 tnb, trows), tfbank (planes, M16, tnb) for ``tier``, tcent
    (planes, K, M16) for ``vq_tier``; the plain version splits the f32
    tensors itself."""
    nb, nbp = n_fft // 2, basis.shape[1] // 2
    plain_basis = torch.cat([basis[:n_fft, :nb], basis[:n_fft, nbp:nbp + nb]],
                            dim=1)
    return tokenize_plain(padded, plain_basis, fbank[:nb], centroids, n_fft,
                          hop, padded_len, n_frames, tier, vq_tier)


@_tokenize_op.register_kernel("cuda")
def _tokenize_cuda(padded, basis, fbank, centroids, c2, n_fft, hop,
                   padded_len, n_frames, tier="highest", vq_tier="highest",
                   tbasis=None, tfbank=None, tcent=None):
    check_tier(tier)
    check_tier(vq_tier, "VQ precision tier")
    check_cuda_tensor("padded", padded, torch.float32, 2)
    for name, t, nd in (("basis", basis, 2), ("fbank", fbank, 2),
                        ("centroids", centroids, 2), ("c2", c2, 1)):
        check_cuda_tensor(name, t, torch.float32, nd)
    split = {}  # the bf16 operands the tiers read, None where f32
    for name, t, t_tier in (("tbasis", tbasis, tier), ("tfbank", tfbank, tier),
                            ("tcent", tcent, vq_tier)):
        split[name] = None if t_tier == "highest" else t
        if t_tier != "highest":
            if t is None:
                raise ValueError(f"{name} is required at tiers ({tier}, "
                                 f"{vq_tier})")
            if name == "tcent":  # the argmin's centroid image
                check_cuda_tensor(name, t, torch.uint8, 1)
            else:
                check_cuda_tensor(name, t, torch.bfloat16, 3)
    tensors = [padded, basis, fbank, centroids, c2,
               *(t for t in split.values() if t is not None)]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"batch on {padded.device}, kernel tensors on "
                         f"{basis.device}")
    b, stride = padded.shape
    if stride < padded_len:
        raise ValueError(f"rows of {stride} samples are shorter than "
                         f"padded_len {padded_len}")
    k, m = centroids.shape
    out = torch.empty((b, n_frames), dtype=torch.int32, device=padded.device)
    lib = _lib()
    trows = tnb = 0
    if tier != "highest":
        trows, tnb = tbasis.shape[2], tbasis.shape[1] // 2
        smem = lib.atk_tokenize_tier_smem(hop, trows, m,
                                          int(tier == "bf16x3"),
                                          TIERS.index(vq_tier))
        if hop % 16 or m > 128 or smem > MAX_SMEM:
            raise ValueError(
                f"B1 at tier '{tier}' needs hop a multiple of 16, at most "
                f"128 mel bands and its shared memory within {MAX_SMEM} "
                f"bytes: hop {hop}, n_fft {n_fft}, {m} mel bands need "
                f"{smem}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(padded.device):
        rc = lib.atk_tokenize_tier(
            padded.data_ptr(), b, stride, padded_len, n_frames, hop,
            basis.shape[0], basis.data_ptr(), basis.shape[1] // 2,
            fbank.data_ptr(), m, ptr(split["tbasis"]), trows, tnb,
            ptr(split["tfbank"]), centroids.data_ptr(), c2.data_ptr(), k,
            ptr(split["tcent"]),
            0 if split["tcent"] is None else split["tcent"].numel(),
            TIERS.index(tier), TIERS.index(vq_tier),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "tokenize")
    TokenizerKernel.launches += 1
    return out


@_tokenize_op.register_fake
def _tokenize_fake(padded, basis, fbank, centroids, c2, n_fft, hop,
                   padded_len, n_frames, tier="highest", vq_tier="highest",
                   tbasis=None, tfbank=None, tcent=None):
    return padded.new_empty((padded.shape[0], n_frames), dtype=torch.int32)


class TokenizerKernel(nn.Module):
    """Device-resident basis, filterbank and centroids (buffers) + the
    wrapper ``(B, >= padded_len) waveforms -> (B, n_frames) int32 tokens``.

    ``TokenizerKernel.launches`` counts kernel launches (all instances).
    """

    launches = 0

    def __init__(self, sample_rate: int, n_mels: int, n_fft: int, hop: int,
                 n_frames: int, centroids: np.ndarray,
                 device: torch.device, tier: str = "highest",
                 vq_tier: str = "highest"):
        super().__init__()
        if n_fft % 2:
            raise ValueError("TokenizerKernel requires an even n_fft")
        self.tier = check_tier(tier, "tokenizer precision tier")
        self.vq_tier = check_tier(vq_tier, "VQ precision tier")
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
        # the tiers' bf16 operands, split once (None where the tier is f32)
        for name in ("_tbasis", "_tfbank", "_tcent"):
            self.register_buffer(name, None)
        if tier != "highest":
            trows = -(-n_fft // ROW_STAGE) * ROW_STAGE
            tnb = -(-nb // BIN_PASS) * BIN_PASS
            tb = torch.zeros((2 * tnb, trows))
            tb[:nb, :n_fft] = torch.from_numpy(basis[:, :nb].T)
            tb[tnb:tnb + nb, :n_fft] = torch.from_numpy(basis[:, nb:].T)
            tf = torch.zeros((-(-n_mels // 16) * 16, tnb))
            tf[:n_mels, :nb] = torch.from_numpy(fb[:-1].T)
            self.register_buffer("_tbasis", bf16_split_rows(tb, tier).to(
                self.device))
            self.register_buffer("_tfbank", bf16_split_rows(tf, tier).to(
                self.device))
        if vq_tier != "highest":
            self.register_buffer("_tcent", tier_image(
                torch.from_numpy(cent), vq_tier, ARGMIN_CHUNK, ARGMIN_KS,
                False).to(self.device))

    def log_mel_plain(self, padded: torch.Tensor) -> torch.Tensor:
        """(B, n_frames, M) dB features as the plain version computes them."""
        return log_mel_plain(decode_wire(padded), self.basis, self.fbank,
                             self.n_fft, self.hop, self.padded_len,
                             self.n_frames, self.tier)

    def plain(self, padded: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version, on whatever device ``padded`` is."""
        return tokenize_plain(decode_wire(padded), self.basis, self.fbank,
                              self.centroids, self.n_fft, self.hop,
                              self.padded_len, self.n_frames, self.tier,
                              self.vq_tier)

    def forward(self, padded: torch.Tensor) -> torch.Tensor:
        return torch.ops.atk.tokenize(
            decode_wire(padded), self._kbasis, self._kfbank, self.centroids,
            self.c2, self.n_fft, self.hop, self.padded_len, self.n_frames,
            self.tier, self.vq_tier, self._tbasis, self._tfbank, self._tcent)
