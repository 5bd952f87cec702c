"""The port's stage profiling (``audio_tokens_tpu_torch/utils/profiling.py``)
on the CPU: the wire meter driven by one sequence of calls beside the JAX
package's ``WireMeter`` (byte counts and device seconds equal exactly, the
``h2d`` calls made from concurrent threads too), its ``device()`` section,
``StageTimer``'s line, and the stage traces of ``maybe_trace`` (a readable
Chrome trace a call, one file per call, processes that share a
``profile_dir`` and a clashing name, the launch accounting that finds a
truncated CUDA trace, a nested trace refused)."""

import json
import logging
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_tokens_tpu.utils import profiling as jax_profiling
from audio_tokens_tpu_torch.utils import profiling
from audio_tokens_tpu_torch.utils.profiling import (StageTimer, WireMeter,
                                                    maybe_trace, nbytes)

REPO = Path(__file__).resolve().parents[1]


def _arrays(seed: int):
    """numpy arrays of several dtypes and shapes, and the same as tensors
    (the port's meter counts both alike)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((7, 13)).astype(np.float32),
            rng.integers(0, 500, 321).astype(np.int64),
            rng.integers(-100, 100, (3, 1000)).astype(np.int16),
            np.zeros((5, 2, 3), np.uint8), np.int32(4)]
    return arrs, [torch.from_numpy(np.asarray(a)) for a in arrs]


def test_nbytes_of_tensors_and_arrays():
    arrs, tens = _arrays(0)
    for a, t in zip(arrs, tens):
        assert nbytes(t) == t.numel() * t.element_size() == np.asarray(a).nbytes
        assert nbytes(a) == getattr(a, "nbytes")
    assert nbytes(torch.zeros(4, 5, dtype=torch.bfloat16)) == 40
    assert nbytes(torch.zeros(8)[::2]) == 16  # a view counts its elements
    assert nbytes("not an array") == 0


def test_meter_sequence_matches_jax():
    """The same calls on both meters: h2d/d2h of single and several arrays,
    h2d from 8 threads at once, device_add; every delta equal."""
    jax_meter, port = jax_profiling.WireMeter(), WireMeter()
    arrs, tens = _arrays(1)
    j0, p0 = jax_meter.snapshot(), port.snapshot()
    jax_meter.h2d(arrs[0])
    port.h2d(tens[0])
    jax_meter.d2h(*arrs[1:3])
    port.d2h(arrs[1], tens[2])
    jax_meter.h2d(arrs[4])
    port.h2d(tens[4])
    mid_j, mid_p = jax_meter.snapshot(), port.snapshot()

    def hammer(meter, items, n=200):
        for _ in range(n):
            meter.h2d(*items)

    for meter, items in ((jax_meter, arrs[:3]), (port, tens[:3])):
        threads = [threading.Thread(target=hammer, args=(meter, items))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    jax_meter.device_add(0.25)
    port.device_add(0.25)
    assert port.delta(p0) == jax_meter.delta(j0)
    assert port.delta(mid_p) == jax_meter.delta(mid_j)
    want = 8 * 200 * sum(a.nbytes for a in arrs[:3]) / 2**20
    assert port.delta(mid_p)["h2d_mb"] == pytest.approx(want, rel=0, abs=0)
    assert set(port.delta(p0)) == {"h2d_mb", "d2h_mb", "device_s"}


def test_device_section_times_and_counts():
    port = WireMeter()
    snap = port.snapshot()
    with port.device():
        x = torch.randn(256, 256)
        float((x @ x).sum())  # the section ends with a host read
    with pytest.raises(ValueError):
        with port.device():
            raise ValueError("inside")
    d = port.delta(snap)
    assert d["device_s"] > 0 and d["h2d_mb"] == d["d2h_mb"] == 0
    assert port.snapshot()[2] == d["device_s"]


def test_stage_timer_line_matches_jax(caplog):
    with caplog.at_level(logging.INFO):
        with StageTimer("tokenize/train") as t:
            t.count("clips", 3)
            t.count("clips", 2)
        with jax_profiling.StageTimer("tokenize/train") as j:
            j.count("clips", 5)
    assert t.counters == j.counters == {"clips": 5}
    lines = [r.getMessage().split()[0] for r in caplog.records]
    assert lines.count("[tokenize/train]") == 2


def test_trace_writes_a_chrome_trace_per_call(tmp_path):
    with maybe_trace(None):  # no directory: no profiler, no file
        pass
    out = tmp_path / "traces"
    for _ in range(2):
        with maybe_trace(str(out), "cpu"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    files = sorted(out.glob("trace_r0_*.json"))
    assert len(files) == 2
    for f in files:
        events = json.loads(f.read_text())["traceEvents"]
        names = {e.get("name") for e in events}
        assert "aten::mm" in names, sorted(n for n in names if n)[:20]


def test_nested_trace_refused(tmp_path):
    with maybe_trace(str(tmp_path), "cpu"):
        with pytest.raises(RuntimeError, match="already active"):
            with maybe_trace(str(tmp_path / "inner"), "cpu"):
                pass
    # the outer trace was written and the lock released
    assert len(list(tmp_path.glob("trace_r0_*.json"))) == 1
    with maybe_trace(str(tmp_path), "cpu"):
        pass
    assert not profiling._trace_active


_TRACE_TWICE = """
import sys, torch
from audio_tokens_tpu_torch.utils.profiling import maybe_trace
for _ in range(2):
    with maybe_trace(sys.argv[1], "cpu"):
        torch.ones(8).sum()
"""


def test_processes_sharing_a_profile_dir_keep_every_trace(tmp_path):
    """Two processes at once, then a third (a repeated run), each tracing
    twice into one directory: all six traces are there."""
    def start():
        return subprocess.Popen([sys.executable, "-c", _TRACE_TWICE,
                                 str(tmp_path)], cwd=REPO)

    procs = [start(), start()]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    assert start().wait(timeout=120) == 0
    files = sorted(tmp_path.glob("trace_r0_*.json"))
    assert len(files) == 6, [f.name for f in files]
    assert len({f.name.split("_p")[1].split("_")[0] for f in files}) == 3
    for f in files:
        assert json.loads(f.read_text())["traceEvents"]


def test_trace_name_clash_raises(tmp_path, monkeypatch):
    """A name already taken is never overwritten: the claim raises before
    the block runs, and the existing file is kept."""
    import itertools
    import os

    monkeypatch.setattr(profiling, "_trace_session",
                        (os.getpid(), "stamp", itertools.count()))
    taken = tmp_path / f"trace_r0_stamp_p{os.getpid()}_0.json"
    taken.write_text("kept")
    ran = []
    with pytest.raises(FileExistsError):
        with maybe_trace(str(tmp_path), "cpu"):
            ran.append(1)
    assert not ran and taken.read_text() == "kept"
    assert not profiling._trace_active
    with maybe_trace(str(tmp_path), "cpu"):  # the next name is free
        pass
    assert (tmp_path / f"trace_r0_stamp_p{os.getpid()}_1.json").exists()


def test_launch_records_find_a_truncated_trace(tmp_path):
    """``_launch_records`` on a Chrome trace: launches inside the warm-up
    span and after it, each with or without its kernel record."""
    def launch(ts, corr, cat="cuda_runtime", name="cudaLaunchKernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    def kernel(corr):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 1,
                "args": {"correlation": corr}}

    events = [{"ph": "X", "cat": "user_annotation",
               "name": "maybe_trace/warmup", "ts": 10, "dur": 10},
              launch(11, 1), launch(12, 2), launch(13, 3),
              launch(30, 4), launch(31, 5, "cuda_driver", "cuLaunchKernel"),
              launch(32, 6), launch(33, 7, name="cudaMemcpyAsync"),
              kernel(3), kernel(5), kernel(6)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling._launch_records(path) == (3, 2, 3, 1)
    events = [e for e in events if e["name"] != "maybe_trace/warmup"]
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling._launch_records(path) == (0, 0, 6, 3)
