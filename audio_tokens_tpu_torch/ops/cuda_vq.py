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
"""

from __future__ import annotations

import torch

from audio_tokens_tpu_torch.ops import _build
from audio_tokens_tpu_torch.ops.common import check_cuda_tensor

EPS = 1e-10  # matches ops/vq.py and the reference's normalize_vectors
CHUNK = 16384  # plain version: frame rows scored at once (no (N, K) matrix)


def l2_normalize(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """x / (||x|| + eps), row-wise — the reference's formula (no max())."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def vq_argmin_plain(frames: torch.Tensor, centroids: torch.Tensor,
                    normalize: bool, chunk: int = CHUNK) -> torch.Tensor:
    """(N, d) frames, (K, d) centroids -> (N,) int32 nearest-centroid ids,
    scoring ``||c||^2 - 2 f.c`` in row chunks; torch.argmin keeps the first
    (lowest) index among equal scores."""
    if normalize:
        frames = l2_normalize(frames)
    c2 = (centroids * centroids).sum(1)[None, :]
    out = torch.empty(frames.shape[0], dtype=torch.int32, device=frames.device)
    for i in range(0, frames.shape[0], chunk):
        scores = c2 - 2.0 * (frames[i : i + chunk] @ centroids.T)
        out[i : i + chunk] = scores.argmin(dim=1).to(torch.int32)
    return out


def _lib():
    lib = _build.load("vq")
    fn = lib.atk_vq_argmin
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, I, I, P, P, I, I, P, P]
        fn.restype = I
    return lib


@torch.library.custom_op("atk::vq_argmin", mutates_args=(),
                        device_types="cpu")
def _vq_argmin_op(frames: torch.Tensor, centroids: torch.Tensor,
                  normalize: bool) -> torch.Tensor:
    return vq_argmin_plain(frames, centroids, normalize)


@_vq_argmin_op.register_kernel("cuda")
def _vq_argmin_cuda(frames: torch.Tensor, centroids: torch.Tensor,
                    normalize: bool) -> torch.Tensor:
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
    with torch.cuda.device(frames.device):
        rc = lib.atk_vq_argmin(frames.data_ptr(), n, d, centroids.data_ptr(),
                               c2.data_ptr(), k, int(normalize),
                               out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "vq_argmin")
    vq_argmin.launches += 1
    return out


@_vq_argmin_op.register_fake
def _vq_argmin_fake(frames, centroids, normalize):
    return frames.new_empty((frames.shape[0],), dtype=torch.int32)


def vq_argmin(frames: torch.Tensor, centroids: torch.Tensor,
              normalize: bool) -> torch.Tensor:
    """Nearest-centroid id per frame row, optionally L2-normalizing the rows
    first: frames (N, d) f32, centroids (K, d) f32 -> (N,) int32."""
    return torch.ops.atk.vq_argmin(frames, centroids, normalize)


vq_argmin.launches = 0
