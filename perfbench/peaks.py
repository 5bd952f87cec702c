"""The yardstick's peaks: one NVIDIA H100 SXM (80 GB HBM3) from NVIDIA's
data sheet, dense rates without sparsity, at the full 700 W power limit.

A share of a roofline or of a peak is stated against these numbers, with
the card's own ``power.limit`` printed beside it (``device.power_limit_w``):
a card set below 700 W runs slower under load, and its shares read lower.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

# operations a second by arithmetic type
PEAK_OPS = {
    "float64": 67e12,   # FP64 on the tensor cores
    "float32": 67e12,   # FP32 FMA outside the tensor cores (TF32 off)
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "fp8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class Part:
    """Work that one arithmetic type does: ``ops`` operations (a
    multiply-add counts two) and ``nbytes`` of device memory that the work
    needs to read or write, each input byte once and each output once."""

    dtype: str
    ops: float = 0.0
    nbytes: float = 0.0

    def least_seconds(self) -> float:
        """The least time this part could take: the larger of its
        operations over their peak and its bytes over the memory's."""
        return max(self.ops / PEAK_OPS[self.dtype],
                   self.nbytes / HBM_BYTES_PER_S)


def least_seconds(parts: Iterable[Part]) -> float:
    """The least time of several parts, each at the peak of its own type,
    one after the other."""
    return sum(p.least_seconds() for p in parts)
