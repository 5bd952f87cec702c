"""Deterministic seeding (counterpart of ``audio_tokens_tpu/utils/seeding.py``).

``set_seed`` is a copy: it seeds the host-side ``random`` and ``numpy``
globals.  Randomness on tensors never comes from torch's global generator;
each stage draws from its own ``torch.Generator``, seeded from the root seed
and a stable hash of the stage name.  ``stage_hash`` is the JAX package's
FNV-1a hash, the value ``key_for`` folds into its root key, so a stage name
picks the same stream identity in both packages (the bits differ: JAX and
torch generators are different algorithms).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> None:
    """Seed host-side global RNGs (python + numpy)."""
    random.seed(seed)
    np.random.seed(seed)


def _fnv1a(data: bytes) -> int:
    h = 2166136261
    for ch in data:
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


def stage_hash(stage: str) -> int:
    """32-bit FNV-1a of the stage name (stable; python's hash() is salted
    per process)."""
    return _fnv1a(stage.encode())


def stage_seed(seed: int, stage: str) -> int:
    """The 32-bit seed of ``stage``'s stream under root ``seed``: FNV-1a of
    the stage name followed by the seed's 8 bytes (torch's CPU generator
    keeps only 32 bits of a seed)."""
    return _fnv1a(stage.encode() + seed.to_bytes(8, "little", signed=True))


def generator_for(seed: int, stage: str,
                  device: torch.device | str = "cpu") -> torch.Generator:
    """A per-stage generator on ``device``: independent streams per stage,
    the same stream for the same (seed, stage)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stage_seed(seed, stage))
    return gen
