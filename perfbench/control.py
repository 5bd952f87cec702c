"""Readings that set the limits of ``correct``, on the card at a cell's own
size (the benchmark's own runs never run this):

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--seconds 3]

For each of ``--seeds`` it makes a run's set-up, a short window at the
cell's own load, and the comparison with the reference: the program's
readings (one JSON line each, ``"side": "program"``).  For each of
``--control-seeds`` it puts the reference, one precision step below the
configuration's, in the program's place and judges it the same way
(``"side": "control"``); for a training cell also the faults planted in
the reference (``"side": "half_batch"``: the loss over half of each batch;
``"side": "logit"``: one logit altered where it is produced), and for a
clustering cell whether a fit replays as its iterations one at a time
(``"side": "replay"``).  All seeds
run in one process, so the build and the imports are paid once.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from perfbench import device as devices
from perfbench import program, registry, tracing


def _ints(text: str):
    return [int(s) for s in text.split(",") if s]


def readings(cell, seed: int, seconds: float, dev, control: bool):
    kind = importlib.import_module(f"perfbench.traffic.{cell.kind}")
    run = kind.Run(cell.config, cell.mix, seed, dev, tracing.Spans(False))
    t = time.perf_counter()
    run.setup()
    stats = run.window(seconds)
    run.release()
    out = [dict(side="program", seed=seed, **run.check(stats))]
    if control:
        if cell.kind == "serve":
            picked = [d[1] for d in run.sample(stats)]
            out.append(dict(side="control", seed=seed, **run.judge(
                [(i, run.control_side(i)) for i in picked])))
        else:
            out.append(dict(side="control", seed=seed, **run.control()))
        if cell.kind == "cluster":
            out.append(dict(side="replay", seed=seed, **run.replay_gap()))
        if cell.kind == "train":
            out.append(dict(side="half_batch", seed=seed, **run.half_batch()))
            out.append(dict(side="logit", seed=seed, **run.altered_logit()))
    for line in out:
        line["seconds"] = time.perf_counter() - t
    del run
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = registry.find_cell(registry.load_benchmark(), args.workload)
    devices.require_cards(cell.chips)
    program.exact_float32()
    dev = torch.device("cuda", 0)
    seeds = [(s, False) for s in args.seeds]
    seeds += [(s, True) for s in args.control_seeds]
    for seed, control in seeds:
        for line in readings(cell, seed, args.seconds, dev, control):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
