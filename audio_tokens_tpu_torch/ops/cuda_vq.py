"""Kernel B2 (``csrc/vq.cu``): fused L2 normalize + nearest-centroid id.

Replaces ``audio_tokens_tpu/ops/pallas_vq.py::_vq_kernel``.  On the H100 it
is bound by float32 FMA issue (7.1 GFLOP against 28 MB of frames at the
slice's 110,272 x 64 frames and 500 centroids); the kernel keeps frames,
their norms and every score in shared memory and registers and writes only
the int32 ids, with a lexicographic (score, index) merge so the lowest index
wins ties as ``jnp.argmin`` does.  The design is written up in the source.

``vq_argmin`` is the wrapper.  It calls the custom op ``atk::vq_argmin``,
so that ``torch.export`` records the kernel as one node: the op's CPU
registration is the plain PyTorch version ``vq_argmin_plain``, its CUDA
registration launches the kernel (and counts the launch) or raises, and its
fake only allocates the output.

``tier`` (``ops/tiers.py``: ``highest``, ``bf16x3``, ``default``) sets the
distance product's precision: ``highest`` is the f32 kernel above; the bf16
tiers, the Lloyd assignment at ``kmeans_precision`` ``high`` and
``default``, run on the tensor cores in one resident instance whose bf16
centroids must fit in shared memory (K 500 at d 64 does); a shape that does
not fit raises ``ValueError`` on the card.  ``c2 = ||c||^2`` is f32 from
the f32 centroids at every tier, as in the JAX package.
"""

from __future__ import annotations

import torch

from audio_tokens_tpu_torch.ops import _build
from audio_tokens_tpu_torch.ops.common import check_cuda_tensor
from audio_tokens_tpu_torch.ops.tiers import (
    TIERS,
    check_tier,
    split_bf16,
    tier_operands,
    tier_product,
)

MAX_SMEM = 227 * 1024  # shared memory a block may have on the H100

EPS = 1e-10  # matches ops/vq.py and the reference's normalize_vectors
CHUNK = 16384  # plain version: frame rows scored at once (no (N, K) matrix)


def l2_normalize(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """x / (||x|| + eps), row-wise — the reference's formula (no max())."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def vq_argmin_plain(frames: torch.Tensor, centroids: torch.Tensor,
                    normalize: bool, chunk: int = CHUNK,
                    tier: str = "highest") -> torch.Tensor:
    """(N, d) frames, (K, d) centroids -> (N,) int32 nearest-centroid ids,
    scoring ``||c||^2 - 2 f.c`` in row chunks, the product at ``tier``;
    torch.argmin keeps the first (lowest) index among equal scores."""
    check_tier(tier)
    if normalize:
        frames = l2_normalize(frames)
    c2 = (centroids * centroids).sum(1)[None, :]
    cparts = tier_operands(centroids.T, tier)
    out = torch.empty(frames.shape[0], dtype=torch.int32, device=frames.device)
    for i in range(0, frames.shape[0], chunk):
        fc = tier_product(tier_operands(frames[i : i + chunk], tier), cparts)
        out[i : i + chunk] = (c2 - 2.0 * fc).argmin(dim=1).to(torch.int32)
    return out


def bf16_split_rows(x: torch.Tensor, tier: str) -> torch.Tensor:
    """(K, d) f32 -> the tier's bf16 operand planes, (planes, K, d16): hi
    (and lo at bf16x3) of x with the features zero-padded to a multiple of
    16, as the tensor-core kernels read them."""
    k, d = x.shape
    padded = x.new_zeros((k, -(-d // 16) * 16))
    padded[:, :d] = x
    parts = split_bf16(padded) if tier == "bf16x3" else (padded,)
    return torch.stack(parts).to(torch.bfloat16).contiguous()


def _lib():
    lib = _build.load("vq")
    fn = lib.atk_vq_argmin
    if fn.argtypes is None:
        P, I, L = _build.P, _build.I, _build.L
        fn.argtypes = [P, I, I, P, P, I, I, P, P]
        fn.restype = I
        lib.atk_vq_argmin_tier.argtypes = [P, I, I, P, P, P, I, I, I, P, P]
        lib.atk_vq_argmin_tier.restype = I
        lib.atk_vq_tier_smem.argtypes = [I, I, I]
        lib.atk_vq_tier_smem.restype = L
    return lib


@torch.library.custom_op("atk::vq_argmin", mutates_args=(),
                        device_types="cpu")
def _vq_argmin_op(frames: torch.Tensor, centroids: torch.Tensor,
                  normalize: bool, tier: str = "highest") -> torch.Tensor:
    return vq_argmin_plain(frames, centroids, normalize, tier=tier)


@_vq_argmin_op.register_kernel("cuda")
def _vq_argmin_cuda(frames: torch.Tensor, centroids: torch.Tensor,
                    normalize: bool, tier: str = "highest") -> torch.Tensor:
    check_tier(tier)
    check_cuda_tensor("frames", frames, torch.float32, 2)
    check_cuda_tensor("centroids", centroids, torch.float32, 2)
    n, d = frames.shape
    k = centroids.shape[0]
    if centroids.shape[1] != d or centroids.device != frames.device:
        raise ValueError(f"centroids {tuple(centroids.shape)} on "
                         f"{centroids.device} do not match frames "
                         f"{tuple(frames.shape)} on {frames.device}")
    if k < 1 or d < 1:
        raise ValueError("need at least one centroid and one feature")
    c2 = (centroids * centroids).sum(1)
    out = torch.empty(n, dtype=torch.int32, device=frames.device)
    lib = _lib()
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    if tier == "highest":
        with torch.cuda.device(frames.device):
            rc = lib.atk_vq_argmin(frames.data_ptr(), n, d,
                                   centroids.data_ptr(), c2.data_ptr(), k,
                                   int(normalize), out.data_ptr(), stream)
    else:
        x3 = int(tier == "bf16x3")
        smem = lib.atk_vq_tier_smem(d, k, x3)
        if d > 128 or smem > MAX_SMEM:
            raise ValueError(
                f"B2 at tier '{tier}' runs only where the bf16 centroids fit "
                f"in shared memory (d <= 128): K {k} x d {d} needs {smem} "
                f"bytes of {MAX_SMEM} (the ring and sliced instances are "
                "f32 only; tier 'highest' takes any shape)")
        split = bf16_split_rows(centroids, tier)
        with torch.cuda.device(frames.device):
            rc = lib.atk_vq_argmin_tier(
                frames.data_ptr(), n, d, split[0].data_ptr(),
                split[-1].data_ptr(), c2.data_ptr(), k, int(normalize),
                TIERS.index(tier), out.data_ptr(), stream)
    _build.check(lib, rc, "vq_argmin")
    vq_argmin.launches += 1
    return out


@_vq_argmin_op.register_fake
def _vq_argmin_fake(frames, centroids, normalize, tier="highest"):
    return frames.new_empty((frames.shape[0],), dtype=torch.int32)


def vq_argmin(frames: torch.Tensor, centroids: torch.Tensor,
              normalize: bool, tier: str = "highest") -> torch.Tensor:
    """Nearest-centroid id per frame row, optionally L2-normalizing the rows
    first, the distance product at ``tier``: frames (N, d) f32, centroids
    (K, d) f32 -> (N,) int32."""
    return torch.ops.atk.vq_argmin(frames, centroids, normalize, tier)


vq_argmin.launches = 0
