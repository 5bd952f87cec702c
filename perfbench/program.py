"""The system under test, as the harness reaches it: the port's config
object built from a configuration file, and the run's numeric settings.

Only the port (``audio_tokens_tpu_torch``) is imported, and only inside
these functions, so that importing the harness loads nothing of it.
"""

from __future__ import annotations

import dataclasses
import time

import torch

# the steps below each precision that a configuration may state: the
# control of ``correct`` computes the reference one step down
STEP_DOWN = {"float64": "float32", "float32": "tf32", "bfloat16": "fp8"}


def exact_float32() -> None:
    """Float32 products in float32, as the configurations state: TF32 off
    for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def config(cfg: dict, seed: int, **overrides):
    """The port's ``AudioTokensConfig`` from a configuration file's keys
    (those that are its fields), the run's seed and ``overrides``."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig

    names = {f.name for f in dataclasses.fields(AudioTokensConfig)}
    kwargs = {k: v for k, v in cfg.items() if k in names}
    kwargs.update(overrides)
    # the host RNGs the port seeds take 32 bits
    kwargs["random_seed"] = int(seed) % (1 << 32)
    return AudioTokensConfig(**kwargs)


class Clock:
    """Seconds between laps, for the set-up's split on standard error."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps: dict = {}

    def lap(self, name: str) -> dict:
        now = time.perf_counter()
        self.laps[name] = round(now - self.t, 3)
        self.t = now
        return self.laps
