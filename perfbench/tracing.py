"""The traced run: spans around the harness's own calls, one profiler
session over the window, and its reduction to device intervals.

Spans are ``torch.profiler.record_function`` ranges named
``perfbench/<what>`` around the calls the harness makes into the program
(``serve``, ``train_epoch``, ``kmeans_fit``) and its host-side reads; they
cost nothing outside a profiler session, and the untraced runs open none.

The profiler drops the first kernel records of a session, more the longer
the process has lived (``utils/profiling.py`` of the program measured one
more for about every 15 s), so a session first launches small kernels
that take those losses, then the window runs.  A window in which a kernel
launch has no kernel record is a truncated trace: the run fails rather
than read shares from it.

The reduction takes the window from its span, the device's intervals
(kernels, copies, sets) inside it, their union (busy time: a copy that
overlaps a kernel counts once), each kernel name's summed time, and the
idle gaps, each named by the innermost harness span that the host was in.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

PREFIX = "perfbench/"
WINDOW = PREFIX + "window"
_T_IMPORT = time.monotonic()
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """``span(name)``: a profiler range while tracing, nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)


@dataclass
class Trace:
    """The reduced trace of one window (seconds)."""

    window_s: float
    busy_s: float
    kernels: Dict[str, float] = field(default_factory=dict)
    copies: Dict[str, float] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, patterns) -> float:
        return sum(t for name, t in self.kernels.items()
                   if any(p in name for p in patterns))

    def copy_seconds(self, patterns) -> float:
        return sum(t for name, t in self.copies.items()
                   if any(p in name for p in patterns))

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time (kernels of one name
        summed over their template arguments) and the longest idle gaps."""
        ops: Dict[str, float] = {}
        for name, t in [*self.kernels.items(), *self.copies.items()]:
            ops[short_name(name)] = ops.get(short_name(name), 0.0) + t
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in self.gaps[:n]]}


def short_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    for stop in ("<", "("):
        if stop in name:
            name = name[:name.index(stop)]
    return name.strip()[:120]


def _warm_up(device: torch.device) -> None:
    n = 1024 + int(16 * (time.monotonic() - _T_IMPORT))
    t = torch.zeros(1, device=device)
    with torch.profiler.record_function(PREFIX + "warmup"):
        for _ in range(n):
            t.add_(1.0)
    torch.cuda.synchronize(device)


@contextlib.contextmanager
def session(device: torch.device, sink: list):
    """Profile the block; append its ``Trace`` to ``sink`` on exit.  The
    block must open the ``WINDOW`` span around what it measures."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            _warm_up(device)
        yield
        if cuda:
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    sink.append(reduce_events(events, check_launches=cuda))


def _is_launch(name: str) -> bool:
    """A runtime or driver call that launches a kernel (``cudaLaunchKernel``,
    ``cudaLaunchCooperativeKernel``, ``cuLaunchKernel``, ...)."""
    return "Launch" in name and "Kernel" in name


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: List[dict], check_launches: bool = True) -> Trace:
    """Chrome trace events (times in microseconds) -> ``Trace``."""
    spans = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith(PREFIX)]
    win = [e for e in spans if e["name"] == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window spans, not 1")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    dev, kernels, copies, corr = [], {}, {}, set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if b <= t0 or a >= t1:
            continue
        a, b = max(a, t0), min(b, t1)
        dev.append((a, b))
        table = kernels if e["cat"] == "kernel" else copies
        table[e["name"]] = table.get(e["name"], 0.0) + (b - a) * 1e-6
        if e["cat"] == "kernel":
            corr.add(e.get("args", {}).get("correlation"))
    if check_launches:
        lost = [e for e in events if e.get("cat") in LAUNCH_CATS
                and _is_launch(str(e.get("name", "")))
                and t0 <= float(e["ts"]) <= t1
                and e.get("args", {}).get("correlation") not in corr]
        if lost:
            raise RuntimeError(f"truncated trace: {len(lost)} kernel launches "
                               "in the window have no kernel record")
    busy = _union(dev)
    gaps = []
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["name"][len(PREFIX):]) for e in spans if e["name"] != WINDOW]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = 0.5 * (a + b)
            inside = [(hb - ha, name) for ha, hb, name in host
                      if ha <= mid <= hb]
            gaps.append((min(inside)[1] if inside else "host",
                         (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return Trace(window_s=(t1 - t0) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 kernels=kernels, copies=copies, gaps=gaps)

