"""Find a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names every cell, configuration
and metric; each piece lives in a file of its own under ``perfbench/``:

* ``configs/<config>.json``: the configuration's sizes as the program
  takes them (keys of ``AudioTokensConfig``), with its ``source``,
  ``reduced`` and ``assumed``;
* ``traffic/<traffic>.json``: a traffic mix, ``{"kind": ..., params}``;
  the kind's generator and loop is ``traffic/<kind>.py``;
* ``workloads/<cell>.json``: the cell's limits for ``correct``;
* ``metrics/<metric>.json``: a per-layer metric's reader and its inputs.

A later change adds a cell, configuration or metric by adding files and
entries; nothing here names one.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """Everything one run of one cell needs, read from the files."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with ``workloads`` applies to the cells it lists; one
    without to every cell that reports the end-to-end metric it moves (or,
    for an end-to-end metric, to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def find_cell(bench: dict, name: str, base: Path = HERE) -> Cell:
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")
    entry = entries[0]
    config = load_json(base / "configs" / f"{entry['config']}.json")
    mix = load_json(base / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(base / "workloads" / f"{name}.json")["limits"]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    for m in layer:
        m["reader_spec"] = load_json(base / "metrics" / f"{m['name']}.json")
    return Cell(name, entry["chips"], config, mix, limits, e2e, layer)
