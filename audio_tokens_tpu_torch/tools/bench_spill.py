"""Measure the K-means stream cache's disk-spill tier.

Counterpart of ``audio_tokens_tpu/tools/bench_spill.py``.  The clustering
leg of the 2M-clip projection rests on ``_DiskSpill`` (``ops/kmeans.py``)
writing the packed frame stream to disk on the first Lloyd pass and
replaying it as memmap views on the later ones, instead of decoding the
corpus again each iteration.  This tool times the tier at rehearsal scale:

  * write leg: sequential append of super-batch entries (the first pass's
    extra cost over plain streaming), flushed and fsynced;
  * cold replay: the file is evicted from the page cache with
    ``posix_fadvise(POSIX_FADV_DONTNEED)`` on the tool's own file first, so
    the read goes to the disk where the kernel honours the advice;
  * warm replay: the page-cache rate, the bound for corpora under host RAM.

Replay entries are copied into a super-batch buffer, as the feed's producer
thread copies each entry before its transfer, so the rate includes the
memmap -> RAM copy.  bf16 is stored as its uint16 bits, as the spill stores
it.

Usage: python -m audio_tokens_tpu_torch.tools.bench_spill [--gb 8] [--d 64]
       [--wire f32|bf16] [--rows-per-entry 1048576] [--path DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark -> the printed JSON object."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--gb", type=float, default=8.0,
                        help="total spill file size to write/replay")
    parser.add_argument("--d", type=int, default=64,
                        help="feature dim (10k rehearsal: n_mels*conv=64)")
    parser.add_argument("--wire", default="f32", choices=("f32", "bf16"))
    parser.add_argument("--rows-per-entry", type=int, default=1 << 20,
                        help="super-batch rows per spill entry")
    parser.add_argument("--path", default=None,
                        help="directory for the scratch file (default: a "
                             "tempdir on the same filesystem as CWD)")
    args = parser.parse_args(argv)

    from audio_tokens_tpu_torch.ops.kmeans import (WIRES, _DiskSpill,
                                                   _host_dtype, to_wire)

    wire = WIRES[args.wire]
    dtype = _host_dtype(wire)
    row_bytes = args.d * dtype.itemsize
    total_bytes = int(args.gb * 2**30)
    n_entries = max(1, total_bytes // (args.rows_per_entry * row_bytes))
    base = Path(args.path) if args.path else Path(tempfile.mkdtemp(
        prefix="audiotokens_spill_", dir="."))
    base.mkdir(parents=True, exist_ok=True)
    path = base / "spill_bench.bin"

    # one reusable entry: write timing measures bytes, not RNG
    rng = np.random.default_rng(0)
    entry = to_wire(rng.standard_normal(
        (args.rows_per_entry, args.d)).astype(np.float32), wire)
    gb = n_entries * args.rows_per_entry * row_bytes / 2**30
    print(f"spill file: {path}  ({n_entries} entries x "
          f"{args.rows_per_entry} rows x d={args.d} {args.wire} = {gb:.1f} "
          f"GB)", flush=True)

    spill = _DiskSpill(path, args.d, dtype, budget_mb=1 << 30)
    t0 = time.perf_counter()
    for _ in range(n_entries):
        if not spill.append(entry, args.rows_per_entry):
            raise RuntimeError(
                "spill budget exhausted mid-write; raise budget_mb — the "
                "measurement would silently cover fewer bytes than claimed")
    spill._f.flush()
    os.fsync(spill._f.fileno())
    t_write = time.perf_counter() - t0
    spill.seal()
    nbytes = spill.nbytes()

    # a memmap slice is a view (no IO): the feed's producer copies each
    # entry into its super-batch buffer before the transfer
    buf = np.empty_like(entry)

    def replay() -> float:
        t0 = time.perf_counter()
        for view, fill in spill.entries():
            buf[:fill] = view
        return time.perf_counter() - t0

    # cold: evict the file from the page cache so the read hits the disk
    with open(path, "rb") as f:
        os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
    t_cold = replay()
    t_warm = replay()

    result = {
        "gb": round(nbytes / 2**30, 2),
        "wire": args.wire,
        "write_mb_s": round(nbytes / 2**20 / t_write, 1),
        "cold_replay_mb_s": round(nbytes / 2**20 / t_cold, 1),
        "warm_replay_mb_s": round(nbytes / 2**20 / t_warm, 1),
        "write_s": round(t_write, 1),
        "cold_replay_s": round(t_cold, 1),
        "warm_replay_s": round(t_warm, 1),
    }
    print(json.dumps(result))
    spill.cleanup()
    if args.path is None:
        base.rmdir()
    return result


if __name__ == "__main__":
    main()
