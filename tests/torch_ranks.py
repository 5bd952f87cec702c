"""Ranks of the port on the CPU for the multi-process tests: a test module
runs itself as a script, one process a rank, over gloo
(``parallel/distributed.maybe_initialize`` through the ``AUDIO_TOKENS_*``
variables).

    procs = start(Path(__file__), world, out)   # the ranks start
    ...                                         # references meanwhile
    finish(procs, out)                          # wait; a failed rank fails

A rank runs ``python <module> PORT RANK WORLD OUT`` and ``join(...)`` in
it joins the group."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 240  # each rank's wait; every rank is killed past it
GROUP_TIMEOUT_S = 60  # a collective or barrier that waits longer fails


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(script: Path, world: int, out: Path) -> list:
    """``world`` ranks of ``script``, their output to ``out/rank_<r>.log``
    (files, not pipes: a full pipe would block a rank inside a collective
    and hang them all)."""
    port = _free_port()
    env = dict(os.environ)
    for k in ("AUDIO_TOKENS_COORDINATOR", "AUDIO_TOKENS_NUM_PROCESSES",
              "AUDIO_TOKENS_PROCESS_ID", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = []
    for r in range(world):
        with open(out / f"rank_{r}.log", "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(port), str(r), str(world),
                 str(out)], cwd=REPO, env=env, stdout=log_f,
                stderr=subprocess.STDOUT))
    return procs


def finish(procs: list, out: Path) -> None:
    """Wait for every rank (killed past WAIT_S); raise if one failed."""
    deadline = time.monotonic() + WAIT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (out / f"rank_{r}.log").read_text()[-4000:]
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{tail}")


def join(port: str, rank: int, world: int) -> None:
    """In a rank: join the gloo group of ``world`` CPU processes."""
    import logging
    from datetime import timedelta

    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s rank {rank} %(name)s %(message)s")
    os.environ["AUDIO_TOKENS_COORDINATOR"] = f"localhost:{port}"
    os.environ["AUDIO_TOKENS_NUM_PROCESSES"] = str(world)
    os.environ["AUDIO_TOKENS_PROCESS_ID"] = str(rank)
    sys.path.insert(0, str(REPO))
    import torch

    from audio_tokens_tpu_torch.parallel import distributed

    torch.set_num_threads(1)  # four ranks beside the test's own process

    assert distributed.maybe_initialize(
        None, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    assert distributed.backend() == "gloo"
