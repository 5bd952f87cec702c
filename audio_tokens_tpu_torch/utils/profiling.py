"""Stage profiling: wall-clock + throughput counters, the host-link meter
and optional device traces.

Counterpart of ``audio_tokens_tpu/utils/profiling.py``:

  * ``StageTimer``: the one log line a pipeline stage writes per split;
  * ``WireMeter`` / ``WIRE``: the bytes this process moved over its
    host<->card link and the seconds of its device-resident sections,
    which ``tools/scale_run.py`` reads around each stage;
  * ``maybe_trace``: with a ``profile_dir``, the stage under
    ``torch.profiler.profile``, one Chrome/Perfetto trace a call;
  * ``span``: a ``record_function`` range ``atk/<name>`` around one layer
    of a hot path (serving, the training step, the Lloyd iteration) while
    a profiler session is active, nothing otherwise.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

logger = logging.getLogger(__name__)


SPAN_PREFIX = "atk/"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The range ``atk/<name>`` (``torch.profiler.record_function``) while a
    ``torch.profiler`` session is active in the process, else one shared
    ``nullcontext``: with no profiler a span costs a flag's read, where a
    ``record_function`` costs ~14 us on the CPU.  Under ``torch.export`` or
    ``torch.compile`` it is the ``nullcontext`` too, so no profiler op
    enters a traced graph.  A session's trace (``maybe_trace``, the
    benchmark's traced runs) carries the spans beside the device records
    they launched; ``tools/span_report.py`` charges those to them."""
    if (not torch.autograd.profiler._is_profiler_enabled
            or torch.compiler.is_compiling()):
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


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


def nbytes(a) -> int:
    """Bytes of a tensor (``numel() * element_size()``) or of a numpy
    array or scalar (``nbytes``); 0 for anything else."""
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(getattr(a, "nbytes", 0))


class WireMeter:
    """Process-global link and compute accounting.

    The dominant movers count at their transfer sites (waveform and frame
    feeds, corpus uploads, spectrogram and token downloads), whatever the
    device, so that a CPU run counts what a card run moves; device-resident
    sections (whole epochs, Lloyd iterations from the device cache, the
    resident assignment) time themselves with ``device()``.  Scalar reads,
    small artifacts and collectives are not counted.

    Semantics: the bytes THIS PROCESS moved over ITS host<->card link (a
    data-parallel rank counts its own rows).  The counters are
    lock-guarded: the feed producers and the prefetch threads count from
    background threads.
    """

    def __init__(self):
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.device_seconds = 0.0
        self._lock = threading.Lock()

    def h2d(self, *arrays) -> None:
        n = sum(nbytes(a) for a in arrays)
        with self._lock:
            self.h2d_bytes += n

    def d2h(self, *arrays) -> None:
        n = sum(nbytes(a) for a in arrays)
        with self._lock:
            self.d2h_bytes += n

    @contextlib.contextmanager
    def device(self) -> Iterator[None]:
        """Time a device-resident section.  The section must end with a
        host read of its result, so that its seconds are the card's work,
        not the launch queue's."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.device_add(time.perf_counter() - t0)

    def device_add(self, seconds: float) -> None:
        with self._lock:
            self.device_seconds += seconds

    def snapshot(self) -> tuple:
        with self._lock:
            return (self.h2d_bytes, self.d2h_bytes, self.device_seconds)

    def delta(self, snap: tuple) -> dict:
        with self._lock:
            return {
                "h2d_mb": (self.h2d_bytes - snap[0]) / 2**20,
                "d2h_mb": (self.d2h_bytes - snap[1]) / 2**20,
                "device_s": self.device_seconds - snap[2],
            }


WIRE = WireMeter()

_trace_lock = threading.Lock()
_trace_active = False
_trace_session: tuple = (None, "", itertools.count())
# The warm-up of a CUDA trace (see ``maybe_trace``): _WARMUP_BASE launches
# plus _warmup_per_s for each second since this module was imported, a
# rate raised to three times any loss a trace shows.
_WARMUP_BASE = 64
_warmup_per_s = 0.25
_T_IMPORT = time.monotonic()
_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def _claim_trace_path(out: Path, rank: int) -> Path:
    """``out/trace_r<rank>_<start>_p<pid>_<n>.json``: the process's start
    stamp and pid keep processes and runs apart, ``n`` counts this
    process's traces.  The file is created exclusively, so a clash raises
    ``FileExistsError`` instead of overwriting a trace."""
    global _trace_session
    pid = os.getpid()
    if _trace_session[0] != pid:  # first trace, or a forked child's
        _trace_session = (pid, time.strftime("%Y%m%d-%H%M%S"),
                          itertools.count())
    _, stamp, count = _trace_session
    path = out / f"trace_r{rank}_{stamp}_p{pid}_{next(count)}.json"
    path.open("x").close()
    return path


def _warm_up(device: torch.device) -> None:
    """Launch the warm-up's one-element kernels on ``device``, under the
    span ``maybe_trace/warmup``, and wait for them."""
    from torch.profiler import record_function

    n = _WARMUP_BASE + int(_warmup_per_s * (time.monotonic() - _T_IMPORT))
    t = torch.zeros(1, device=device)
    with record_function("maybe_trace/warmup"):
        for _ in range(n):
            t.add_(1.0)
    torch.cuda.synchronize(device)


def _launch_records(path: Path) -> tuple:
    """From a written Chrome trace: (the warm-up's launches, how many of
    them lost their kernel record, the launches after it, how many of
    those lost theirs).  A launch is a runtime or driver ``*LaunchKernel*``
    call; its kernel record carries the same correlation id."""
    events = json.loads(path.read_text())["traceEvents"]
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel"}
    warm = [e for e in events if e.get("name") == "maybe_trace/warmup"
            and e.get("ph") == "X"]
    t0, t1 = ((warm[0]["ts"], warm[0]["ts"] + warm[0]["dur"]) if warm
              else (float("-inf"),) * 2)
    counts = [0, 0, 0, 0]
    for e in events:
        if (e.get("cat") in _LAUNCH_CATEGORIES
                and "LaunchKernel" in e.get("name", "")):
            i = 0 if t0 <= e["ts"] <= t1 else 2 if e["ts"] > t1 else None
            if i is not None:
                counts[i] += 1
                counts[i + 1] += e["args"].get("correlation") not in kernels
    return tuple(counts)


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str],
                device: Optional[torch.device | str] = None
                ) -> Iterator[None]:
    """No-op without a ``profile_dir``.  With one, the block runs under
    ``torch.profiler.profile`` (CPU activity, plus CUDA where ``device`` is
    a CUDA device) and its trace is written to a file of its own under
    ``profile_dir`` (``_claim_trace_path``), so ranks, splits, processes
    and repeated runs never overwrite each other.

    On a CUDA device the profiler drops the first kernel records of every
    session, more of them the longer the process has lived: none at first,
    then one more for about every 15 s of its life, idle or busy (measured
    on an H100, PyTorch 2.11 with CUDA 12.8).  So each trace first
    launches small kernels that take those losses (``_warm_up``, a count
    that grows with the process's age), then runs the block; afterwards
    every kernel launch of the block must have its record in the trace,
    else ``RuntimeError`` (a truncated trace), as it is where the trace
    holds no CUDA activity.  A nested trace raises too (one profiler a
    process)."""
    if not profile_dir:
        yield
        return
    global _trace_active, _warmup_per_s
    with _trace_lock:
        if _trace_active:
            raise RuntimeError(
                "maybe_trace: a trace is already active in this process "
                "(torch.profiler allows one profiler at a time)")
        _trace_active = True
    path = written = None
    try:
        from torch.profiler import ProfilerActivity, profile

        from audio_tokens_tpu_torch.parallel import distributed

        cuda = device is not None and torch.device(device).type == "cuda"
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        out = Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = _claim_trace_path(out, distributed.process_index())
        with profile(activities=activities) as prof:
            if cuda:
                _warm_up(torch.device(device))
            yield
            if cuda:
                torch.cuda.synchronize(device)
        prof.export_chrome_trace(str(path))
        written = path
        if cuda:
            n_warm, warm_lost, n_block, block_lost = _launch_records(path)
            _warmup_per_s = max(_warmup_per_s, 3 * warm_lost / max(
                time.monotonic() - _T_IMPORT, 1.0))
            if block_lost or not n_block:
                raise RuntimeError(
                    f"maybe_trace: the trace of {device} at {path} is "
                    f"truncated: {block_lost} of the block's {n_block} "
                    f"kernel launches have no kernel record ({warm_lost} of "
                    f"{n_warm} warm-up launches lost theirs)")
        logger.info("trace written to %s", path)
    except BaseException:
        if path is not None and written is None:  # no trace: no empty file
            path.unlink(missing_ok=True)
        raise
    finally:
        with _trace_lock:
            _trace_active = False
