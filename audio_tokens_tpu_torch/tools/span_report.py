"""Charge a trace's device time and idle gaps to the port's layer spans.

A Chrome trace from ``torch.profiler`` (a stage run with ``profile_dir``,
written by ``utils/profiling.maybe_trace``, or any session's export) holds
the ``atk/<layer>`` ranges that ``utils/profiling.span`` opens beside the
device records they launched; both come from one profiler session and
share its clock.

* A kernel, copy or set belongs to the innermost ``atk/`` span whose host
  interval holds the runtime call that launched it, joined by the
  ``correlation`` id on any thread: autograd launches the backward's
  kernels from a thread of its own, not from the one that opened
  ``train.backward``.
* A span's device seconds are the union of its operations' intervals in
  the window, its host seconds its own durations there, each over its
  instances that start in the window.
* An idle gap (no kernel, copy or set on the device) is named by what held
  its midpoint on the host: the innermost other range (``perfbench/read``,
  ``maybe_trace/warmup``), then ``/<atk span>``, then ``:<runtime call>``,
  as in ``perfbench/serve/serve.h2d:cudaMemcpyAsync``; ``host`` where
  nothing did.

The window is the range named by ``--window`` (one instance), else the
trace after ``maybe_trace``'s warm-up.

Usage: python -m audio_tokens_tpu_torch.tools.span_report TRACE.json
           [--window RANGE] [--top N]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "atk/"  # utils/profiling.SPAN_PREFIX, kept free of torch
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATS = ("cuda_runtime", "cuda_driver")
WARMUP = "maybe_trace/warmup"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(intervals: List[tuple], times: List[float]) -> list:
    """For each of ``times``, the index of the innermost of ``intervals``
    ((start, end, ...), ends included) that holds it, the latest start
    first, then the earliest end; None where none holds it.  One sweep."""
    marks = [(a, 0, i) for i, (a, _, *_) in enumerate(intervals)]
    marks += [(b, 2, i) for i, (_, b, *_) in enumerate(intervals)]
    marks += [(t, 1, j) for j, t in enumerate(times)]
    marks.sort()
    holding: Dict[int, tuple] = {}
    out: list = [None] * len(times)
    for _, kind, i in marks:
        if kind == 0:
            holding[i] = (intervals[i][0], -intervals[i][1])
        elif kind == 2:
            holding.pop(i, None)
        elif holding:
            out[i] = max(holding, key=holding.get)
    return out


def _interval(e: dict) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def _window(events: List[dict], name: Optional[str]) -> Tuple[float, float]:
    if name is not None:
        hits = [_interval(e) for e in events if e.get("name") == name]
        if len(hits) != 1:
            raise ValueError(f"the trace holds {len(hits)} ranges named "
                             f"{name!r}, not 1")
        return hits[0]
    warm = [_interval(e)[1] for e in events if e.get("name") == WARMUP]
    ends = [_interval(e) for e in events]
    return max(warm, default=min(a for a, _ in ends)), max(b for _, b in ends)


def report(events: List[dict], window: Optional[str] = None,
           top: int = 10) -> dict:
    """Chrome trace events (times in microseconds) -> the window's busy
    seconds, each ``atk/`` span's device and host ms an instance, the
    share of busy time charged to a span, and the ``top`` longest gaps."""
    events = [e for e in events if e.get("ph") == "X"]
    t0, t1 = _window(events, window)
    ranges = [(*_interval(e), e["name"]) for e in events
              if e.get("cat") == "user_annotation"]
    spans = [(a, b, n[len(SPAN_PREFIX):]) for a, b, n in ranges
             if n.startswith(SPAN_PREFIX)]
    other = [r for r in ranges if not r[2].startswith(SPAN_PREFIX)
             and r[2] != window]
    calls = [(*_interval(e), e["name"]) for e in events
             if e.get("cat") in CALL_CATS]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in CALL_CATS
                and "correlation" in e.get("args", {})}
    ops = []
    for e in events:
        a, b = _interval(e)
        if e.get("cat") in DEVICE_CATS and b > t0 and a < t1:
            ops.append((max(a, t0), min(b, t1),
                        launched.get(e.get("args", {}).get("correlation"))))
    timed = [op for op in ops if op[2] is not None]
    owners = _innermost(spans, [t for _, _, t in timed])
    charged: Dict[str, list] = {}
    for (a, b, _), k in zip(timed, owners):
        if k is not None:
            charged.setdefault(spans[k][2], []).append((a, b))
    table: Dict[str, list] = {}
    for a, b, name in spans:
        row = table.setdefault(name, [0.0, 0.0, 0])
        row[1] += max(0.0, min(b, t1) - max(a, t0))
        row[2] += t0 <= a <= t1
    for name, iv in charged.items():
        table.setdefault(name, [0.0, 0.0, 0])[0] = sum(
            b - a for a, b in _union(iv))
    busy = _union([(a, b) for a, b, _ in ops])
    busy_us = sum(b - a for a, b in busy)
    covered_us = sum(b - a for a, b in _union(
        [ab for iv in charged.values() for ab in iv]))
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    holes = [(0.5 * (a + b), b - a)
             for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [m for m, _ in holes]
    gaps = []
    for (_, width), o, s, c in zip(holes, _innermost(other, mids),
                                   _innermost(spans, mids),
                                   _innermost(calls, mids)):
        name = "/".join(held[k][2] for held, k in ((other, o), (spans, s))
                        if k is not None) or "host"
        if c is not None:
            name += ":" + calls[c][2]
        gaps.append([name, 1e-3 * width])
    gaps.sort(key=lambda g: -g[1])
    return {
        "window_s": 1e-6 * (t1 - t0), "busy_s": 1e-6 * busy_us,
        "charged_pct": 100.0 * covered_us / busy_us if busy_us else None,
        "spans": {name: {"device_ms": 1e-3 * d / max(n, 1),
                         "host_ms": 1e-3 * h / max(n, 1), "instances": n}
                  for name, (d, h, n) in sorted(table.items())},
        "idle_gaps_ms": gaps[:top]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace")
    p.add_argument("--window", default=None,
                   help="the range that bounds the window (one instance)")
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)
    with open(args.trace) as f:
        events = json.load(f)["traceEvents"]
    print(json.dumps(report(events, args.window, args.top), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
