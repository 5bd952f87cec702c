"""Per-layer metric readers.  ``metrics/<name>.json`` names its reader and
the reader's inputs:

* ``roofline``: ``kernels`` (substrings of kernel names) and ``work`` (a
  function of ``work.py``, per unit): 100 x the least time of the units'
  needed work over the matched kernels' summed device time;
* ``mfu``: ``work`` (per unit): 100 x the least time of the units' whole
  needed work, each part at its own peak, over the window's wall time;
* ``idle_share``: 100 x the share of the window in which no kernel, copy
  or set ran on the device (the union of their intervals);
* ``copy_ms``: ``copies`` (substrings of copy names): their summed device
  time a unit, in ms.

A reader that finds nothing to read returns None, and the metric is left
out of the line; it never returns 0 for a share.  A metric whose reading
needs code of its own puts ``reader: "module"`` and a ``metrics/<name>.py``
with ``read(spec, ctx)`` beside its file.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Optional

from perfbench import work
from perfbench.peaks import least_seconds
from perfbench.tracing import Trace


@dataclass
class Context:
    """What a reader may read: the cell's configuration and traffic, the
    units of work the traced window completed, and its reduced trace."""

    config: dict
    mix: dict
    units: int
    trace: Trace


def _least(spec: dict, ctx: Context) -> float:
    per_unit = getattr(work, spec["work"])(ctx.config, ctx.mix)
    return least_seconds(per_unit) * ctx.units


def roofline(spec: dict, ctx: Context) -> Optional[float]:
    t = ctx.trace.kernel_seconds(spec["kernels"])
    if t <= 0 or ctx.units <= 0:
        return None
    return 100.0 * _least(spec, ctx) / t


def mfu(spec: dict, ctx: Context) -> Optional[float]:
    if ctx.trace.window_s <= 0 or ctx.units <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * _least(spec, ctx) / ctx.trace.window_s


def idle_share(spec: dict, ctx: Context) -> Optional[float]:
    if ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def copy_ms(spec: dict, ctx: Context) -> Optional[float]:
    t = ctx.trace.copy_seconds(spec["copies"])
    if t <= 0 or ctx.units <= 0:
        return None
    return 1e3 * t / ctx.units


READERS = {"roofline": roofline, "mfu": mfu, "idle_share": idle_share,
           "copy_ms": copy_ms}


def read(name: str, spec: dict, ctx: Context) -> Optional[float]:
    if spec["reader"] == "module":
        module = importlib.import_module(f"perfbench.metrics.{name}")
        return module.read(spec, ctx)
    return READERS[spec["reader"]](spec, ctx)
