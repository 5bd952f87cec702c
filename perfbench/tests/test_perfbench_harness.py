"""The harness on the CPU: BENCHMARK.json against the contract's shapes,
cells and metrics found by name, a rehearsal of every cell at a tiny size,
and the refusals (no card; the JAX stack loaded)."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import device, readers, registry, run, tracing, work
from perfbench.tests import tiny

ROOT = registry.ROOT
BENCH = registry.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = registry.find_cell(BENCH, name)
    assert cell.kind in ("serve", "train", "cluster")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        spec = m["reader_spec"]
        assert spec["reader"] in readers.READERS
        if "work" in spec:
            assert callable(getattr(work, spec["work"]))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_on_the_cpu(name, trace):
    """Every code path of a run at a tiny size, the program's plain
    versions on the CPU: the result line's keys, and correct."""
    result = run.run_cell(tiny.cell(name), 2**31 + 11, 0.3, bool(trace),
                          torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    if trace:
        assert "busy_s" in result["device"] and "breakdown" in result
        assert result["metrics"] == {}  # no device: no device metric
    else:
        assert "setup_s" in result["metrics"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_forbidden_modules_by_whole_name():
    assert device.forbidden_modules(["audio_tokens_tpu_torch.export",
                                     "jaxtyping", "numpy"]) == []
    assert device.forbidden_modules(["audio_tokens_tpu.ops", "jax.numpy",
                                     "flax"]) == ["audio_tokens_tpu", "flax",
                                                  "jax"]


def test_run_imports_no_jax():
    """What ``perfbench.run`` and a rehearsal load: no jax, no JAX
    package (whole top-level names), in a fresh process."""
    code = ("import sys, torch; from perfbench import run; "
            "from perfbench.tests import tiny; "
            "run.run_cell(tiny.cell('lstm_k500.serve_b64'), 3, 0.2, False, "
            "torch.device('cpu')); "
            "from perfbench import device; print(device.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(audio_tokens_tpu|jax)",
                             text, re.M), path
    code = ("import sys; import perfbench.reference.frontend, "
            "perfbench.reference.lstm, perfbench.reference.bert, "
            "perfbench.reference.adamw, perfbench.reference.kmeans; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'audio_tokens_tpu', 'audio_tokens_tpu_torch', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_new_cell_and_metric_are_files_only(tmp_path):
    """A cell with a new traffic mix, and a per-layer metric with a reader
    of its own, added as new files and entries in a copy: they run with no
    edit to any file that was there."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = copy / "perfbench"
    mix = json.loads((pb / "traffic" / "serve_b64_r16.json").read_text())
    mix.update(batch=1)
    (pb / "traffic" / "serve_b1.json").write_text(json.dumps(mix))
    (pb / "workloads" / "lstm_k500.serve_b1.json").write_text(
        (pb / "workloads" / "lstm_k500.serve_b64.json").read_text())
    (pb / "metrics" / "copies_per_unit.json").write_text(
        json.dumps({"reader": "module"}))
    (pb / "metrics" / "copies_per_unit.py").write_text(
        "def read(spec, ctx):\n"
        "    return float(ctx.units) if ctx.trace.window_s > 0 else None\n")
    bench["workloads"].append({"name": "lstm_k500.serve_b1",
                               "config": "lstm_k500", "traffic": "serve_b1",
                               "chips": 1, "why": "one clip a request"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "lstm_k500.serve_b64" in m["workloads"]:
            m["workloads"].append("lstm_k500.serve_b1")
    bench["per_layer"].append({"name": "copies_per_unit", "unit": "1",
                               "better": "lower", "source": "device_trace",
                               "layer": "serving program",
                               "moves": "serve_clips_per_s",
                               "workloads": ["lstm_k500.serve_b1"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, torch; from pathlib import Path; "
            "from perfbench import run; from perfbench.tests import tiny; "
            "c = tiny.cell('lstm_k500.serve_b1', Path('.')); "
            "c.mix.update(batch=1); "
            "r = run.run_cell(c, 5, 0.2, True, torch.device('cpu')); "
            "print(json.dumps(r))")
    env = {"PYTHONPATH": f"{copy}:{ROOT}", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, text=True,
                         capture_output=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert result["metrics"]["copies_per_unit"]["value"] >= 1


def test_trace_reduction_union_and_gaps():
    """Busy time is the union of device intervals; a gap is named by the
    innermost harness span the host was in."""
    ev = [
        {"ph": "X", "name": tracing.WINDOW, "ts": 0, "dur": 100,
         "cat": "user_annotation"},
        {"ph": "X", "name": tracing.PREFIX + "serve", "ts": 0, "dur": 60,
         "cat": "user_annotation"},
        {"ph": "X", "name": tracing.PREFIX + "read", "ts": 60, "dur": 40,
         "cat": "user_annotation"},
        {"ph": "X", "name": "void k<1>(int)", "ts": 10, "dur": 30,
         "cat": "kernel", "args": {"correlation": 1}},
        {"ph": "X", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 20,
         "dur": 30, "cat": "gpu_memcpy", "args": {}},
        {"ph": "X", "name": "cudaLaunchKernel", "ts": 5, "dur": 1,
         "cat": "cuda_runtime", "args": {"correlation": 1}},
    ]
    tr = tracing.reduce_events(ev)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.kernel_seconds(["k"]) == pytest.approx(30e-6)
    assert tr.gaps[0] == ("read", pytest.approx(50e-6))
    assert {n for n, _ in tr.breakdown()["device_ops"]} == {"k",
                                                            "Memcpy HtoD"}
    lost = ev + [{"ph": "X", "name": "cudaLaunchKernel", "ts": 7, "dur": 1,
                  "cat": "cuda_runtime", "args": {"correlation": 2}}]
    with pytest.raises(RuntimeError, match="truncated"):
        tracing.reduce_events(lost)
