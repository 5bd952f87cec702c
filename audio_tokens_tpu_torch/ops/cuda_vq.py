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
``default``, run on Hopper's ``wgmma`` at any K and d.  ``vq_tier_plan`` is
the launch plan (instance, chunk width, feature slices, ring stages, shared
memory), the C side's ``tier_plan`` in Python; ``tier_image`` lays the
centroids out by it as the exact shared-memory image the kernel's bulk
copies move: per chunk and feature slice the bf16 planes in ``wgmma``'s
core-matrix order, then the chunk's ``c2 = ||c||^2``, f32 from the f32
centroids at every tier as in the JAX package (``+inf`` past K).
"""

from __future__ import annotations

from dataclasses import dataclass

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

MAX_SMEM = _build.SMEM_LIMIT  # shared memory a block may have on the H100
# the tiered instance (csrc/vq.cu): rows a block scores at once, bytes of
# its mbarriers, chunks that may stay resident, buffers at most, the
# alignment of its frame tiles
TIER_ROWS, TIER_HEADER, MAX_RESIDENT, MAX_FRAME_STAGES, MAX_STAGES = (
    128, 256, 12, 4, 4)
SMEM_ALIGN = 1024

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


def tier_item_bytes(chunk: int, ks: int, x3: bool, c2_step: bool) -> int:
    """Bytes of an image item (csrc/common.cuh): the bf16 planes of
    ``chunk`` centroids x 16 ks features, and either a 16-feature c2 k-step
    more a centroid or, after the planes, the chunk's f32 c2."""
    return ((2 if x3 else 1) * chunk * 16 * (ks + int(c2_step)) * 2
            + (0 if c2_step else chunk * 4))


PAD_SCORE = -2.0 ** 127  # -c2 / 2 of a padded centroid (bf16-exact): below any real score


def truncate_bf16(x: torch.Tensor) -> torch.Tensor:
    """x (f32) with the low 16 bits of each value cleared: a bf16 value."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def half_c2_parts(c2: torch.Tensor) -> torch.Tensor:
    """(K,) f32 c2 -> (K, 3): -c2 / 2 as three bf16 values (truncating
    splits) whose sum is -c2 / 2 exactly."""
    x = -0.5 * c2
    hi = truncate_bf16(x)
    mid = truncate_bf16(x - hi)
    return torch.stack([hi, mid, x - hi - mid], dim=1)


@dataclass(frozen=True)
class TierPlan:
    """The tiered instance's launch plan, fields in the C struct's order."""

    ks: int        # k-steps of 16 features the fragments hold (a slice)
    nc: int        # centroids a chunk (and a wgmma)
    wide: int      # rows wider than 128 features, walked in slices
    slices: int    # feature slices of 16 ks
    chunks: int
    items: int     # chunks x slices
    ibytes: int    # bytes of an image item
    istride: int   # bytes of a ring stage
    tile: int      # bytes of a frame tile (a slice where wide)
    resident: int  # the items stay in shared memory
    stages: int    # ring stages
    fstages: int   # frame tile buffers
    smem: int      # bytes of dynamic shared memory

    @property
    def instance(self) -> str:
        return f"vq_tier_kernel<{self.ks}, {self.wide == 1}>"


def vq_tier_plan(k: int, d: int, tier: str) -> TierPlan:
    """The launch plan of B2 at a bf16 tier for K centroids of d features
    (``csrc/vq.cu::tier_plan``): 4 k-steps of fragments and 128-centroid
    chunks up to d 64, 8 and 64 up to d 128, 128-feature slices beyond;
    the chunks resident where they fit beside two frame buffers, else a
    ring of up to 4 stages; shared memory from a 1024-aligned base."""
    if k < 1 or d < 1:
        raise ValueError("need at least one centroid and one feature")
    x3 = check_tier(tier) == "bf16x3"
    ks_all = -(-d // 16)
    ks, nc = (4, 128) if ks_all <= 4 else (8, 64)
    wide = int(ks_all > 8)
    slices = -(-ks_all // 8) if wide else 1
    chunks = -(-k // nc)
    items = chunks * slices
    ibytes = tier_item_bytes(nc, ks, x3, True)
    tile = TIER_ROWS * 16 * ks * 4
    align = SMEM_ALIGN if wide else 128
    istride = -(-(ibytes + (tile if wide else 0)) // align) * align
    avail = _build.SMEM_LIMIT - SMEM_ALIGN - TIER_HEADER
    if not wide and items <= MAX_RESIDENT and items * istride + 2 * tile \
            <= avail:
        resident, stages = 1, items
        fstages = min(MAX_FRAME_STAGES, (avail - items * istride) // tile)
    else:
        resident, fstages = 0, 0 if wide else 2
        stages = min(MAX_STAGES, (avail - fstages * tile) // istride)
    return TierPlan(ks, nc, wide, slices, chunks, items, ibytes, istride,
                    tile, resident, stages, fstages,
                    SMEM_ALIGN + fstages * tile + stages * istride
                    + TIER_HEADER)


def tier_image(centroids: torch.Tensor, tier: str, chunk: int, ks: int,
               c2_step: bool) -> torch.Tensor:
    """(K, d) f32 centroids -> the kernels' centroid image (uint8, flat):
    for each chunk of ``chunk`` centroids (zero rows past K) and each slice
    of 16 ks features (zeros past d), the tier's bf16 planes (hi, and lo at
    bf16x3) in wgmma's K-major core-matrix order (8 centroids x 8 features,
    128 bytes a core matrix, in (8-centroid group, 8-feature block) order).
    c2 = ``||c||^2`` of the f32 centroids goes in as the kernel reads it:
    with ``c2_step`` (B2) each centroid's features are followed by a c2
    k-step, ``-c2 / 2`` (``PAD_SCORE`` past K) as three bf16 parts that sum
    to it exactly, then zeros (all zeros in the lo plane), which the kernel
    multiplies by ones so that its products are ``f.c - c2 / 2``; without
    (B1) the planes are followed by the chunk's f32 c2 (+inf past K)."""
    k, d = centroids.shape
    width = 16 * ks
    chunks, slices = -(-k // chunk), -(-d // width)
    kp, dp = chunks * chunk, slices * width
    padded = centroids.new_zeros((kp, dp))
    padded[:k, :d] = centroids
    parts = split_bf16(padded) if tier == "bf16x3" else (padded,)
    planes = torch.stack(parts).to(torch.bfloat16).reshape(
        len(parts), chunks, chunk // 8, 8, slices, 2 * ks, 8)
    c2 = (centroids * centroids).sum(1)
    if c2_step:
        c2k = planes.new_zeros((len(parts), kp, 16))
        c2k[0, :k, :3] = half_c2_parts(c2).to(torch.bfloat16)
        c2k[0, k:, 0] = PAD_SCORE
        c2k = (c2k.reshape(len(parts), chunks, chunk // 8, 8, 1, 2, 8)
               .expand(-1, -1, -1, -1, slices, -1, -1))
        planes = torch.cat([planes, c2k], dim=5)
    core = (planes.permute(1, 4, 0, 2, 5, 3, 6).contiguous()
            .reshape(chunks, slices, -1).view(torch.uint8))
    if not c2_step:
        c2f = torch.full((kp,), float("inf"), dtype=torch.float32,
                         device=centroids.device)
        c2f[:k] = c2
        c2f = (c2f.reshape(chunks, 1, chunk).expand(chunks, slices, chunk)
               .contiguous().view(torch.uint8))
        core = torch.cat([core, c2f], dim=2)
    return core.reshape(-1)


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
        lib.atk_vq_argmin_tier.argtypes = [P, I, I, P, L, I, I, I, P, P]
        lib.atk_vq_argmin_tier.restype = I
        lib.atk_vq_tier_plan.argtypes = [I, I, I, P]
        lib.atk_vq_tier_plan.restype = I
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
    out = torch.empty(n, dtype=torch.int32, device=frames.device)
    lib = _lib()
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    if tier == "highest":
        c2 = (centroids * centroids).sum(1)
        with torch.cuda.device(frames.device):
            rc = lib.atk_vq_argmin(frames.data_ptr(), n, d,
                                   centroids.data_ptr(), c2.data_ptr(), k,
                                   int(normalize), out.data_ptr(), stream)
    else:
        plan = vq_tier_plan(k, d, tier)
        img = tier_image(centroids, tier, plan.nc, plan.ks, True)
        with torch.cuda.device(frames.device):
            rc = lib.atk_vq_argmin_tier(
                frames.data_ptr(), n, d, img.data_ptr(), img.numel(), k,
                int(normalize), TIERS.index(tier), out.data_ptr(), stream)
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
