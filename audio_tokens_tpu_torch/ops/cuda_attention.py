"""Kernel B5 (``csrc/attention.cu``): non-causal flash attention with segment
ids, forward and backward, as ``torch.library`` custom ops joined by an
autograd registration.

B5 replaces the library kernels that ``audio_tokens_tpu/models/
transformer.py::FlashSelfAttention`` calls
(``jax.experimental.pallas.ops.tpu.flash_attention``): the forward
``_flash_attention_kernel`` and the backward pair
``_flash_attention_dkv_kernel`` / ``_flash_attention_dq_kernel``, joined
there by a ``custom_vjp`` and here by ``torch.library.register_autograd``
on ``atk::flash_fwd``.  Every function
takes the JAX layout: q, k, v (B, nh, T, dh) in float32 or bfloat16,
segment ids (B, T) int32; a query attends to the keys of its own segment.
Every op also takes the library's ``SegmentIds(q=, kv=)`` of two
lengths: a query block of T rows against T_kv keys (``kv_segment_ids``
(B, T_kv), k and v (B, nh, T_kv, dh)), as a sequence-parallel rank runs
its own query rows against the gathered keys (``models/transformer.py``);
every query's segment must occur among the keys.  The backward pair then
gives dq (B, nh, T, dh) and dk, dv (B, nh, T_kv, dh): the block's share of
the keys' gradients, which the gather's backward sums over the ranks.
The kernels take dh = 64 (the bert family's heads) and any T: they mask
their own ragged edge, where the JAX module pads T to a multiple of 256 for
the TPU's tiles.

The numerics are the library's (its kernel source, lines 395-480): scores
in f32 times ``sm_scale`` plus the finite ``MASK_VALUE`` where the segments
differ, an online softmax, P rounded to v's dtype before P.v, the output
cast to the input dtype.  The forward writes the row logsumexp the backward
recomputes P from only when asked: ``flash_attention`` asks only when
autograd will need it, so serving under ``inference_mode`` stores nothing
extra.  On the H100 the kernels are bound by arithmetic (587 GFLOP a layer
at the serving shape), and past the tensor cores by the elementwise pass
between their products.  In bf16 the forward and both backward kernels run
on the tensor cores on one design (``mma.sync`` from bf16 tiles, P and dS
kept in registers, the streamed tiles through a ``cp.async`` ring that
overlaps the next tile's loads with this tile's products, tiles that share
no segment with a block's rows left out, where P is exactly 0, and tiles of
one segment walked without mask tests).  In f32 the forward and the
backward pair run on the same design in 3xTF32 (each operand split into
two tf32 parts, three ``mma.sync`` products a product, f32 accuracy at 165
TFLOP/s against plain FMA's 67; the block's own rows stay in shared memory
and are split as they are read).  Every kernel needs 16-byte aligned q, k,
v (and do) and refuses others.

Each kernel is a custom op (``atk::flash_fwd``, ``atk::flash_bwd_dkv``,
``atk::flash_bwd_dq``), so that ``torch.export`` records it as one node:
the op's CPU registration is the plain version, its CUDA registration
launches the kernel (and counts the launch) or raises, and its fake only
allocates the outputs.  The pair is the forward's backward
(``torch.library.register_autograd``).

Under an ensemble's member axis (``train/ensemble.py``: ``torch.func.vmap``
over K members) each op's ``register_vmap`` rule folds the members into
the batch, (K, B, nh, T, dh) -> (K B, nh, T, dh), segment ids repeated for
each member where they are shared: attention has no weights of its own,
so one launch serves every member.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from audio_tokens_tpu_torch.ops import _build
from audio_tokens_tpu_torch.ops.common import check_cuda_tensor, needs_grad

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # library DEFAULT_MASK_VALUE
HEAD_DIM = 64  # csrc/attention.cu kD
DTYPES = (torch.float32, torch.bfloat16)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 ``x`` rounded to ``dtype`` and back (a no-op for float32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _logits(q: torch.Tensor, k: torch.Tensor, seg: torch.Tensor,
            sm_scale: float, kv_seg: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """(B, nh, T, T_kv) f32 scores q.k^T * sm_scale + the segment mask
    (the keys' segment ids ``kv_seg``, default the queries')."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    kv_seg = seg if kv_seg is None else kv_seg
    same = seg[:, None, :, None] == kv_seg[:, None, None, :]
    return s + torch.where(same, 0.0, MASK_VALUE)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          segment_ids: torch.Tensor, sm_scale: float,
                          return_lse: bool = False,
                          kv_segment_ids: Optional[torch.Tensor] = None):
    """B5's forward materialized: softmax over each query's own segment,
    unnormalized P (relative to the row max) rounded to v's dtype before
    P.v, then divided by the row sum.  Returns o (B, nh, T, dh) in q's
    dtype, and with ``return_lse`` also the (B, nh, T) f32 logsumexp.
    ``kv_segment_ids`` (B, T_kv): the keys' segment ids where k and v have
    T_kv rows of their own (default: ``segment_ids``, T_kv = T).  Out of
    place, so that autograd can differentiate it."""
    s = _logits(q, k, segment_ids, sm_scale, kv_segment_ids)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (torch.matmul(_round(p, v.dtype), v.float()) / l).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l)).squeeze(-1)
    return o


def _probs_and_ds(q, k, v, seg, lse, do, di, sm_scale, kv_seg=None):
    """The backward's P = exp(s - lse) and dS = (dO.V^T - di) * P * scale,
    both f32 (B, nh, T, T_kv); ``kv_seg`` as in ``_logits``."""
    p = _logits(q, k, seg, sm_scale, kv_seg).sub_(lse[..., None]).exp_()
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, dp.sub_(di[..., None]).mul_(p).mul_(sm_scale)


def flash_attention_dkv_plain(q, k, v, segment_ids, lse, do, di,
                              sm_scale: float,
                              kv_segment_ids: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = dS^T.Q and dv = P^T.dO, P and dS rounded to the input dtype
    first (as ``_flash_attention_dkv_kernel``); outputs in q's dtype, of
    k's shape.  ``kv_segment_ids`` as in ``flash_attention_plain``."""
    p, ds = _probs_and_ds(q, k, v, segment_ids, lse, do, di, sm_scale,
                          kv_segment_ids)
    dt = q.dtype
    dv = torch.matmul(_round(p, dt).transpose(-1, -2), do.float())
    dk = torch.matmul(_round(ds, dt).transpose(-1, -2), q.float())
    return dk.to(dt), dv.to(dt)


def flash_attention_dq_plain(q, k, v, segment_ids, lse, do, di,
                             sm_scale: float,
                             kv_segment_ids: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """dq = dS.K, dS rounded to the input dtype first (as
    ``_flash_attention_dq_kernel``); output in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, segment_ids, lse, do, di, sm_scale,
                          kv_segment_ids)
    return torch.matmul(_round(ds, q.dtype), k.float()).to(q.dtype)


def _lib():
    lib = _build.load("attention")
    if lib.atk_flash_fwd.argtypes is None:
        P, I, F = _build.P, _build.I, ctypes.c_float
        lib.atk_flash_fwd.argtypes = [P, P, P, P, P, I, I, I, I, I, F, I, P,
                                      P, P]
        lib.atk_flash_fwd.restype = I
        lib.atk_flash_bwd_dkv.argtypes = [P, P, P, P, P, P, P, P, I, I, I,
                                          I, I, F, I, P, P, P]
        lib.atk_flash_bwd_dkv.restype = I
        lib.atk_flash_bwd_dq.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I,
                                         I, F, I, P, P]
        lib.atk_flash_bwd_dq.restype = I
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           seg: torch.Tensor, kv_seg: Optional[torch.Tensor] = None,
           **more: torch.Tensor) -> None:
    """Raise unless the tensors are what the kernels take: k and v of q's
    shape, or with ``kv_seg`` of their own length T_kv."""
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    b, nh, t_len, dh = q.shape
    t_kv = t_len if kv_seg is None else k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(name, t, q.dtype, 4)
        want = (b, nh, t_len if name == "q" else t_kv, dh)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want}")
    if dh != HEAD_DIM:
        raise ValueError(f"kernel takes head dim {HEAD_DIM}, got {dh}")
    for name, t, n in (("segment_ids", seg, t_len),
                       ("kv_segment_ids", kv_seg, t_kv)):
        if t is None:
            continue
        check_cuda_tensor(name, t, torch.int32, 2)
        if tuple(t.shape) != (b, n):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {(b, n)}")
    for name, t in more.items():
        if name == "do":
            check_cuda_tensor(name, t, q.dtype, 4)
            shape = tuple(q.shape)
        else:
            check_cuda_tensor(name, t, torch.float32, 3)
            shape = (b, nh, t_len)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if len({t.device for t in (q, k, v, seg, kv_seg, *more.values())
            if t is not None}) != 1:
        raise ValueError("the attention tensors must share one device")


@torch.library.custom_op("atk::flash_fwd", mutates_args=(),
                        device_types="cpu")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  segment_ids: torch.Tensor, sm_scale: float, lse: bool,
                  kv_segment_ids: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (o, the row logsumexp); the logsumexp is an empty f32 tensor
    unless ``lse``."""
    if lse:
        return flash_attention_plain(q, k, v, segment_ids, sm_scale, True,
                                     kv_segment_ids)
    return (flash_attention_plain(q, k, v, segment_ids, sm_scale,
                                  kv_segment_ids=kv_segment_ids),
            q.new_empty(0, dtype=torch.float32))


@_flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, segment_ids, sm_scale, lse, kv_segment_ids=None):
    _check(q, k, v, segment_ids, kv_segment_ids)
    b, nh, t_len, dh = q.shape
    kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
    o = torch.empty_like(q)
    row_lse = torch.empty((b, nh, t_len) if lse else (0,),
                          dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.atk_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
            kv_seg.data_ptr(), b, nh, t_len, k.shape[2], dh, sm_scale,
            int(q.dtype == torch.bfloat16), o.data_ptr(),
            row_lse.data_ptr() if lse else None,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "flash_fwd")
    flash_attention_fwd.launches += 1
    return o, row_lse


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, segment_ids, sm_scale, lse, kv_segment_ids=None):
    b, nh, t_len, _ = q.shape
    return torch.empty_like(q), q.new_empty(
        (b, nh, t_len) if lse else (0,), dtype=torch.float32)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        segment_ids: torch.Tensor, sm_scale: float,
                        lse: bool = False,
                        kv_segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B5 forward -> (o (B, nh, T, dh) in q's dtype, the (B, nh, T) f32 row
    logsumexp when ``lse``, else None).  ``kv_segment_ids`` (B, T_kv): k
    and v hold T_kv rows of their own (a query block against more keys)."""
    o, row_lse = torch.ops.atk.flash_fwd(q, k, v, segment_ids,
                                         float(sm_scale), lse,
                                         kv_segment_ids)
    return o, (row_lse if lse else None)


flash_attention_fwd.launches = 0


@torch.library.custom_op("atk::flash_bwd_dkv", mutates_args=(),
                        device_types="cpu")
def _flash_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  segment_ids: torch.Tensor, lse: torch.Tensor,
                  do: torch.Tensor, di: torch.Tensor, sm_scale: float,
                  kv_segment_ids: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_dkv_plain(q, k, v, segment_ids, lse, do, di,
                                     sm_scale, kv_segment_ids)


def _bwd_launch(fn, name: str, q, k, v, segment_ids, lse, do, di, sm_scale,
                kv_segment_ids, *outs) -> None:
    """Check the inputs and launch one of the backward pair on ``outs``."""
    _check(q, k, v, segment_ids, kv_segment_ids, lse=lse, do=do, di=di)
    b, nh, t_len, dh = q.shape
    kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"atk_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
            kv_seg.data_ptr(), lse.data_ptr(), do.data_ptr(), di.data_ptr(),
            b, nh, t_len, k.shape[2], dh, sm_scale,
            int(q.dtype == torch.bfloat16), *(t.data_ptr() for t in outs),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, name)
    fn.launches += 1


@_flash_dkv_op.register_kernel("cuda")
def _flash_dkv_cuda(q, k, v, segment_ids, lse, do, di, sm_scale,
                    kv_segment_ids=None):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch(flash_attention_bwd_dkv, "flash_bwd_dkv", q, k, v,
                segment_ids, lse, do, di, sm_scale, kv_segment_ids, dk, dv)
    return dk, dv


@_flash_dkv_op.register_fake
def _flash_dkv_fake(q, k, v, segment_ids, lse, do, di, sm_scale,
                    kv_segment_ids=None):
    return torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op("atk::flash_bwd_dq", mutates_args=(),
                        device_types="cpu")
def _flash_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 segment_ids: torch.Tensor, lse: torch.Tensor,
                 do: torch.Tensor, di: torch.Tensor, sm_scale: float,
                 kv_segment_ids: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    return flash_attention_dq_plain(q, k, v, segment_ids, lse, do, di,
                                    sm_scale, kv_segment_ids)


@_flash_dq_op.register_kernel("cuda")
def _flash_dq_cuda(q, k, v, segment_ids, lse, do, di, sm_scale,
                   kv_segment_ids=None):
    dq = torch.empty_like(q)
    _bwd_launch(flash_attention_bwd_dq, "flash_bwd_dq", q, k, v, segment_ids,
                lse, do, di, sm_scale, kv_segment_ids, dq)
    return dq


@_flash_dq_op.register_fake
def _flash_dq_fake(q, k, v, segment_ids, lse, do, di, sm_scale,
                   kv_segment_ids=None):
    return torch.empty_like(q)


def flash_attention_bwd_dkv(q, k, v, segment_ids, lse, do, di,
                            sm_scale: float,
                            kv_segment_ids: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5 backward for dk and dv from the forward's inputs, its row
    logsumexp ``lse``, the output gradient ``do`` and di = rowsum(o * do)
    (f32); ``kv_segment_ids`` as in ``flash_attention_fwd`` (dk and dv of
    k's T_kv rows)."""
    return torch.ops.atk.flash_bwd_dkv(q, k, v, segment_ids, lse, do, di,
                                       float(sm_scale), kv_segment_ids)


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, segment_ids, lse, do, di,
                           sm_scale: float,
                           kv_segment_ids: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """B5 backward for dq, from the same inputs as the dk/dv kernel."""
    return torch.ops.atk.flash_bwd_dq(q, k, v, segment_ids, lse, do, di,
                                      float(sm_scale), kv_segment_ids)


flash_attention_bwd_dq.launches = 0


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, segment_ids, sm_scale, lse, kv_segment_ids = inputs
    o, row_lse = output
    ctx.set_materialize_grads(False)
    ctx.sm_scale, ctx.lse = sm_scale, lse
    ctx.save_for_backward(q, k, v, segment_ids, kv_segment_ids, o, row_lse)


def _flash_fwd_backward(ctx, do, _dlse):
    """The library's custom_vjp backward: di = rowsum(o * do) outside the
    kernels, then the dk/dv and dq kernels."""
    if do is None:
        return None, None, None, None, None, None, None
    if not ctx.lse:
        raise RuntimeError("atk::flash_fwd ran with lse=False: its backward "
                           "needs the row logsumexp")
    q, k, v, seg, kv_seg, o, lse = ctx.saved_tensors
    do = do.contiguous()
    di = (o.float() * do.float()).sum(-1)
    args = (q, k, v, seg, lse, do, di, ctx.sm_scale, kv_seg)
    dk, dv = flash_attention_bwd_dkv(*args)
    dq = flash_attention_bwd_dq(*args)
    return dq, dk, dv, None, None, None, None


torch.library.register_autograd("atk::flash_fwd", _flash_fwd_backward,
                                setup_context=_flash_fwd_setup)


# -- the member axis: torch.func.vmap over an ensemble's members --------------
def _fold(t, bdim, k: int):
    """(K, B, ...) with the member axis at ``bdim`` -> (K B, ...) contiguous;
    a shared tensor is repeated for each member."""
    if bdim is None:
        return t.unsqueeze(0).expand(k, *t.shape).reshape(k * t.shape[0],
                                                          *t.shape[1:])
    t = t.movedim(bdim, 0)
    return t.reshape(k * t.shape[1], *t.shape[2:]).contiguous()


def _unfold(t, k: int):
    return t.view(k, t.shape[0] // k, *t.shape[1:])


@torch.library.register_vmap("atk::flash_fwd")
def _flash_fwd_vmap(info, in_dims, q, k, v, segment_ids, sm_scale, lse,
                    kv_segment_ids=None):
    """Attention has no weights of its own, so the members fold into the
    batch: one B5 launch for all of them.  As for B3, whether autograd
    needs the logsumexp is asked of the members' tensors; it is returned
    only when the caller asked."""
    n = info.batch_size
    keep = lse or needs_grad(q, k, v)
    kv_seg = (None if kv_segment_ids is None
              else _fold(kv_segment_ids, in_dims[6], n))
    o, row_lse = torch.ops.atk.flash_fwd(
        *(_fold(t, d, n) for t, d in zip((q, k, v, segment_ids), in_dims)),
        sm_scale, keep, kv_seg)
    row_lse = _unfold(row_lse, n) if lse else row_lse.new_empty((n, 0))
    return (_unfold(o, n), row_lse), (0, 0)


def _bwd_folded(info, in_dims, inputs, sm_scale, kv_segment_ids):
    """The backward pair's arguments with the members folded into the
    batch (``kv_segment_ids`` as ``_flash_fwd_vmap`` folds it)."""
    n = info.batch_size
    kv_seg = (None if kv_segment_ids is None
              else _fold(kv_segment_ids, in_dims[8], n))
    return (*(_fold(t, d, n) for t, d in zip(inputs, in_dims)), sm_scale,
            kv_seg)


@torch.library.register_vmap("atk::flash_bwd_dkv")
def _flash_dkv_vmap(info, in_dims, q, k, v, segment_ids, lse, do, di,
                    sm_scale, kv_segment_ids=None):
    """The dk/dv kernel once for all members, folded into the batch."""
    n = info.batch_size
    dk, dv = torch.ops.atk.flash_bwd_dkv(*_bwd_folded(
        info, in_dims, (q, k, v, segment_ids, lse, do, di), sm_scale,
        kv_segment_ids))
    return (_unfold(dk, n), _unfold(dv, n)), (0, 0)


@torch.library.register_vmap("atk::flash_bwd_dq")
def _flash_dq_vmap(info, in_dims, q, k, v, segment_ids, lse, do, di,
                   sm_scale, kv_segment_ids=None):
    """The dq kernel once for all members, folded into the batch."""
    n = info.batch_size
    dq = torch.ops.atk.flash_bwd_dq(*_bwd_folded(
        info, in_dims, (q, k, v, segment_ids, lse, do, di), sm_scale,
        kv_segment_ids))
    return _unfold(dq, n), 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: torch.Tensor, sm_scale: float,
                    kv_segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """softmax(q.k^T * sm_scale over each query's segment).v, (B, nh, T, dh),
    differentiable in q, k and v (B5's backward pair).  Where autograd will
    not need a gradient, B5 runs without its logsumexp store.
    ``kv_segment_ids`` (B, T_kv): a query block against T_kv keys (dk and
    dv of their T_kv rows)."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    return flash_attention_fwd(q, k, v, segment_ids, sm_scale, grad,
                               kv_segment_ids)[0]
