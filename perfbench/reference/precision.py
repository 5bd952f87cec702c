"""Products at a named precision.

``float64`` is the reference; ``float32`` is float32 with TF32 off; the
controls step down from what a configuration states: ``tf32`` (float32
operands rounded to TF32 on the tensor cores) below float32, ``fp8``
(e4m3 operands with one scale a tensor, float32 sums) below bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float64", "float32", "tf32", "fp8")
FP8_MAX = 448.0  # the largest e4m3 value


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one scale that maps its largest magnitude
    to the format's largest value, back in float32."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b at ``precision``, the result in its dtype (float64 or
    float32)."""
    dt = dtype_of(precision)
    if precision == "fp8":
        a, b = fp8(a), fp8(b)
    with tf32(precision == "tf32"):
        return torch.matmul(a.to(dt), b.to(dt))
