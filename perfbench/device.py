"""The card a run measures, and what the process may hold.

A run needs the cards its cell asks for: without them it exits before
making anything, and never measures on the CPU under a device metric's
name.  Once the window has closed it refuses to print a result if the
process has loaded the JAX stack or the JAX package (compared by whole
top-level module names: the port's name begins with the JAX package's).
"""

from __future__ import annotations

import subprocess
import sys
from typing import Optional

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "audio_tokens_tpu")


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch sees no CUDA device: this benchmark measures "
                     "the card and runs nowhere else")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell needs {n} cards, torch sees {have}")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    """The card's ``power.limit`` in watts, from nvidia-smi; None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(device: torch.device, chips: int) -> dict:
    """The result line's ``device``: platform, the card's name, the cards
    used, the peak of allocated memory (read before the reference runs)
    and the power limit that every share is read against."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit_w": power_limit_w()}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
