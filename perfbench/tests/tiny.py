"""Cells cut to sizes a CPU test holds: every code path of a run, at
widths and counts far below the benchmark's.  Used by the CPU tests only;
the benchmark itself never shrinks a cell."""

from __future__ import annotations

import dataclasses
from pathlib import Path

from perfbench import registry

FRONT = dict(clip_seconds=0.25)
CONFIGS = {
    "lstm": dict(vocab_size=16, lstm_embed_dim=8, lstm_hidden_dim=12,
                 num_classes=7, max_seq_len=40, **FRONT),
    "bert": dict(vocab_size=16, hidden_size=128, num_layers=1,
                 num_classes=7, max_seq_len=40, transformer_max_position=40,
                 **FRONT),
}
MIXES = {
    "serve": dict(batch=4, pool=2, short_per_batch=1, short_seconds=0.1,
                  warm_requests=2, check_requests=2, trace_seconds=0.3,
                  rate=20.0),
    "train": dict(batch=4, clips=10, short_min=5, check_steps=3,
                  trace_seconds=0.3),
    "cluster": dict(clips=20, frames_per_clip=50, mixture=40, niter=3,
                    trace_seconds=0.3),
}
# leaves of a few hundred elements: AdamW's first steps turn each
# round-off-sized gradient whose sign float32 and float64 do not share into
# a whole step of lr, a larger share of such a leaf than at the cell's size
LIMITS = {"train": dict(change_gap=1e-4)}


def cell(name: str, root: Path = registry.ROOT) -> registry.Cell:
    c = registry.find_cell(registry.load_benchmark(root), name,
                           root / "perfbench")
    return dataclasses.replace(
        c, config=dict(c.config, **CONFIGS[c.config["model_type"]]),
        mix=dict(c.mix, **MIXES[c.kind]),
        limits=dict(c.limits, **LIMITS.get(c.kind, {})))
