"""The control of ``correct``: the reference one precision step below the
configuration's, in the program's place, must come out not correct.  On
the card at a size a test run holds (the limits' readings at the cells'
own sizes are in PERF.md); on the CPU the readings' machinery at a tiny
size, where TF32 does not exist, with the training faults planted in the
reference."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import control, registry
from perfbench.tests import tiny

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]
# a size a test run holds on the card: the cells' widths, fewer clips
SMALL = {"serve": dict(batch=8, pool=2, short_per_batch=1, check_requests=2,
                       warm_requests=2),
         "train": dict(clips=256, batch=16, check_steps=3),
         "cluster": dict(clips=2000)}


def fails(cell, line) -> bool:
    return any(line[k] > v for k, v in cell.limits.items() if k in line)


@pytest.mark.parametrize("name", CELLS)
def test_readings_on_the_cpu(name):
    cell = tiny.cell(name)
    lines = control.readings(cell, 2**31 + 3, 0.2, torch.device("cpu"), True)
    sides = {line["side"]: line for line in lines}
    assert not fails(cell, sides["program"])
    assert "control" in sides
    if cell.kind == "train":
        assert fails(cell, sides["half_batch"]) and fails(cell, sides["logit"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = registry.find_cell(registry.load_benchmark(), name)
    cell = dataclasses.replace(cell, mix=dict(cell.mix, **SMALL[cell.kind]))
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        lines = control.readings(cell, seed, 1.0, torch.device("cuda", 0),
                                 True)
        sides = {line["side"]: line for line in lines}
        assert not fails(cell, sides["program"]), sides["program"]
        assert fails(cell, sides["control"]), sides["control"]
