"""Stage profiling: wall-clock + throughput counters.

Counterpart of ``audio_tokens_tpu/utils/profiling.py``: its ``StageTimer``,
the one log line a pipeline stage writes per split.  The JAX module's
``WireMeter`` (host-link byte accounting for its tools) and its
``jax.profiler`` traces are not ported: a non-empty ``profile_dir`` is
refused by :func:`maybe_trace`, naming ROADMAP A7, where the tools that read
those traces are.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Iterator, Optional

logger = logging.getLogger(__name__)


class StageTimer:
    """Context manager: wall time + named unit counters -> one log line.

    with StageTimer("tokenize/train") as t:
        ...
        t.count("clips", n)
        t.count("frames", total_frames)
    """

    def __init__(self, name: str):
        self.name = name
        self.counters: dict = {}
        self.seconds = 0.0

    def count(self, unit: str, n: int) -> None:
        self.counters[unit] = self.counters.get(unit, 0) + int(n)

    def __enter__(self) -> "StageTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        rates = "  ".join(
            f"{unit}={n} ({n / max(self.seconds, 1e-9):.1f}/s)"
            for unit, n in self.counters.items()
        )
        logger.info("[%s] %.2fs  %s", self.name, self.seconds, rates)


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str]) -> Iterator[None]:
    """No-op without a ``profile_dir``; with one, refuse: device traces of
    the stages are not ported yet."""
    if profile_dir:
        raise NotImplementedError(
            f"profile_dir={profile_dir!r} (stage traces) is not ported yet: "
            "ROADMAP A7 (the profiling tools)")
    yield
