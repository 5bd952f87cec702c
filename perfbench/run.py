"""Run one cell of the benchmark once:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The run makes its inputs and weights from the
seed, builds the system under test (``audio_tokens_tpu_torch``) and warms
up every shape the cell uses (``setup_s``, from the process's start), then
measures for ``--seconds`` on the host clock (``--trace 0``: the cell's
end-to-end metrics) or profiles a shorter window of the same loop
(``--trace 1``: its per-layer metrics, the device's busy and window
seconds and a breakdown).  Once the window has closed it reads the memory
peak, frees the program, and holds what the timed path produced to the
plain reference (``correct``).  The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the line's last key.

Without the cards a cell asks for, or with the JAX stack or the JAX
package loaded once the window has closed, the run prints no result and
exits with another code than 0.

Everything a cell needs is found by name (``registry.py``): a new cell,
configuration, traffic mix or per-layer metric is new files and new
entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# a run is one process on one card: no process group from the environment
_GROUP_VARIABLES = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT", "AUDIO_TOKENS_COORDINATOR",
                    "AUDIO_TOKENS_NUM_PROCESSES", "AUDIO_TOKENS_PROCESS_ID")


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its kernels into ``build/kernels`` itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    for var in _GROUP_VARIABLES:
        os.environ.pop(var, None)


_environment()

import torch  # noqa: E402

T_IMPORTED = time.perf_counter()

from perfbench import device as devices  # noqa: E402
from perfbench import program, readers, registry, tracing  # noqa: E402


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float = T_START) -> dict:
    """One run -> the result line (a dict; ``checks`` last)."""
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    program.exact_float32()
    kind = importlib.import_module(f"perfbench.traffic.{cell.kind}")
    spans = tracing.Spans(trace)
    run = kind.Run(cell.config, cell.mix, seed, device, spans)
    t_setup = time.perf_counter()
    run.setup()
    devices.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print(f"setup: {T_IMPORTED - t_start:.3f} s to import torch, "
          f"{t_setup - T_IMPORTED:.3f} s more to start the cell, "
          f"{setup_s - (t_setup - t_start):.3f} s its set-up "
          f"({getattr(run, 'split', {})})", file=sys.stderr)
    traces: list = []
    if trace:
        window = min(seconds, cell.mix["trace_seconds"])
        with tracing.session(device, traces):
            with spans.span("window"):
                stats = run.window(window)
    else:
        stats = run.window(seconds)
    desc = devices.describe(device, cell.chips)
    run.release()
    numbers = run.check(stats)
    checks = {}
    for name, value in numbers.items():
        if name not in cell.limits:
            raise KeyError(f"no limit for {name!r} in workloads/"
                           f"{cell.name}.json")
        checks[name] = {"value": value, "limit": cell.limits[name]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        tr = traces[0]
        desc.update(busy_s=tr.busy_s, window_s=tr.window_s)
        ctx = readers.Context(cell.config, cell.mix, run.units(stats), tr)
        for m in cell.per_layer:
            value = readers.read(m["name"], m["reader_spec"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.end_to_end(stats), setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(stats["attempted"]),
              "failed": int(stats["attempted"]) - int(run.units(stats)),
              "metrics": metrics, "device": desc}
    if trace:
        result["breakdown"] = traces[0].breakdown()
    result["checks"] = checks
    return result


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = registry.find_cell(registry.load_benchmark(), args.workload)
    try:
        devices.require_cards(cell.chips)
    except devices.NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = devices.forbidden_modules()
    if found:
        print(f"perfbench: the process holds {', '.join(found)}: the port "
              "must run without the JAX stack and the JAX package",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
