"""Shared op-level helpers."""

from __future__ import annotations

import torch


def exact_f32() -> None:
    """Run float32 products in full float32 on the card.

    TF32 keeps about three decimal digits, enough to flip nearest-centroid
    decisions, so the plain versions that the kernels are held to must not
    use it.  Both switches are needed: ``cudnn.allow_tf32`` defaults to True.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def members(t, bdim, n: int) -> list:
    """The ``n`` members' slices of an argument a ``torch.func.vmap`` rule
    got with member axis ``bdim`` (contiguous, as the kernels take them);
    an argument without one (``bdim`` None, or None itself) is shared.  The
    slices come from one ``unbind``, whose backward stacks the members'
    gradients in one copy (``select`` a member would scatter each into a
    zero tensor of all of them)."""
    if t is None or bdim is None:
        return [t] * n
    return [m.contiguous() for m in t.unbind(bdim)]


def needs_grad(*tensors) -> bool:
    """Whether autograd will want a gradient of any of ``tensors``.  Inside
    a vmap rule the arguments are the unwrapped tensors, whose
    ``requires_grad`` the wrappers could not see through the member axis."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
