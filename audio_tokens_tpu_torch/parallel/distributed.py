"""Multi-process execution on ``torch.distributed`` (counterpart of
``audio_tokens_tpu/parallel/distributed.py``).

One process per card: the JAX package's ``data`` axis becomes the ranks of
the default process group.  Launch N processes with ``torchrun`` and
``distributed=True``, or with the JAX package's variables
(``AUDIO_TOKENS_COORDINATOR``, ``AUDIO_TOKENS_NUM_PROCESSES``,
``AUDIO_TOKENS_PROCESS_ID``, one process each).

Entry points:

  * ``maybe_initialize(config)``: call once at process start (every stage
    and the trainer do).  No-op when not configured, so single-process
    runs are unchanged; a group a launcher made already is taken as it is.
  * ``process_shard(items)``: this rank's strided slice of a work list
    (every rank derives the same global list, so sharding needs no
    traffic).
  * ``is_coordinator()``: True on rank 0, which alone writes the
    single-writer artifacts (checkpoints, metrics history, plots, stats).
  * ``all_reduce_``, ``broadcast_``, ``all_gather``: the tensor
    collectives, over every rank or over the ``group`` of a mesh axis
    (``parallel/mesh.make_mesh``; ``_staged`` alone decides where a tensor
    goes for one),
    and their host-array adapters ``all_sum_hosts``, ``broadcast_host``,
    ``all_gather_hosts``; ``barrier`` at stage boundaries.
  * ``local_device()``: this rank's card, its index among its host's ranks
    (``LOCAL_RANK``) modulo the card count.

The backend follows the topology and is logged: before the group is made,
every rank posts its host name and card count to the rendezvous store, and
all read the same table: ``nccl`` where every rank owns a card, ``gloo``
where ranks share a card (NCCL refuses two ranks on one device) or a host
has none.  A failed NCCL start fails the run.
The JAX ``put_sharded`` has no counterpart: the port builds no global
arrays, each rank holds its own rows.
"""

from __future__ import annotations

import logging
import os
import socket
from collections import Counter
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the group's timeout: a collective or barrier that waits longer fails the
# rank (a stage's slowest shard, or the coordinator's cache build, must
# finish within it)
DEFAULT_TIMEOUT = timedelta(minutes=30)


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value else default


def _topology(config) -> Optional[tuple]:
    """(coordinator "host:port", world size, rank) from the config fields,
    the ``AUDIO_TOKENS_*`` variables or, under ``distributed=True`` alone,
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``;
    None when nothing asks for more than one process."""
    coord = (getattr(config, "coordinator_address", "")
             or os.environ.get("AUDIO_TOKENS_COORDINATOR", ""))
    n_proc = int(getattr(config, "num_processes", 0)
                 or _env_int("AUDIO_TOKENS_NUM_PROCESSES", 0))
    pid = getattr(config, "process_id", -1)
    if pid is None or pid < 0:
        pid = _env_int("AUDIO_TOKENS_PROCESS_ID", -1)
    explicit = bool(coord or n_proc > 1)
    if not (explicit or getattr(config, "distributed", False)):
        return None
    if not coord and os.environ.get("MASTER_ADDR"):
        coord = (f"{os.environ['MASTER_ADDR']}:"
                 f"{os.environ.get('MASTER_PORT', '29500')}")
    if n_proc <= 0:
        n_proc = _env_int("WORLD_SIZE", 0)
    if pid < 0:
        pid = _env_int("RANK", -1)
    missing = [what for what, bad in (
        ("the coordinator (coordinator_address, AUDIO_TOKENS_COORDINATOR "
         "or MASTER_ADDR)", not coord),
        ("the process count (num_processes, AUDIO_TOKENS_NUM_PROCESSES or "
         "WORLD_SIZE)", n_proc <= 0),
        ("this process's rank (process_id, AUDIO_TOKENS_PROCESS_ID or "
         "RANK)", pid < 0)) if bad]
    if missing:
        raise ValueError("a multi-process run needs " + "; ".join(missing)
                         + ": launch with torchrun or set the "
                         "AUDIO_TOKENS_* variables")
    if pid >= n_proc:
        raise ValueError(f"process id {pid} out of range for {n_proc} "
                         "processes")
    return coord, n_proc, pid


# this rank's index among the ranks of its host, set when the group is made
# here (the card it takes under NCCL)
_local_index: Optional[int] = None


def plan_topology(table: Sequence[tuple], rank: int,
                  local_rank: Optional[int] = None) -> tuple:
    """(backend, local index) of ``rank`` from every rank's (host name,
    card count), in rank order.

    ``nccl`` when every rank of every host owns a card of its own, else
    ``gloo`` (ranks sharing a card, or a host without one): every rank
    reads the same table, so all pick the same backend.  The local index
    is torchrun's ``LOCAL_RANK`` where given, else the rank's place among
    its host's ranks."""
    per_host = Counter(host for host, _ in table)
    own_card = all(cards > 0 and per_host[host] <= cards
                   for host, cards in table)
    host = table[rank][0]
    if local_rank is None:
        local_rank = [r for r, (h, _) in enumerate(table)
                      if h == host].index(rank)
    return ("nccl" if own_card else "gloo"), local_rank


def _exchange_topology(store, n_proc: int, pid: int) -> list:
    """Every rank's (host name, card count), through the rendezvous
    store, before the process group exists."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    table = dist.PrefixStore("audio_tokens/topology", store)
    table.set(str(pid), f"{socket.gethostname()}\t{n_cards}")
    keys = [str(r) for r in range(n_proc)]
    table.wait(keys)
    rows = [table.get(k).decode().rsplit("\t", 1) for k in keys]
    return [(host, int(cards)) for host, cards in rows]


def maybe_initialize(config=None, timeout: timedelta = DEFAULT_TIMEOUT
                     ) -> bool:
    """Join the process group once, from the config or the environment.

    Returns True when running multi-process (joined now or earlier).  Safe
    to call from every entry point: a group that exists (made by an earlier
    call or by a launcher) is used as it is.  The group's ``timeout``
    bounds every collective and barrier."""
    global _local_index
    if dist.is_initialized():
        return dist.get_world_size() > 1
    topo = _topology(config)
    if topo is None:
        return False
    coord, n_proc, pid = topo
    store, _, _ = next(dist.rendezvous(f"tcp://{coord}", pid, n_proc,
                                       timeout=timeout))
    store.set_timeout(timeout)
    table = _exchange_topology(store, n_proc, pid)
    local_rank = os.environ.get("LOCAL_RANK", "")
    backend, _local_index = plan_topology(
        table, pid, int(local_rank) if local_rank else None)
    if backend == "nccl":
        torch.cuda.set_device(_local_index)
    dist.init_process_group(backend, store=store, world_size=n_proc,
                            rank=pid, timeout=timeout)
    host, cards = table[pid]
    logger.info(
        "torch.distributed initialized: rank %d/%d, backend %s, %d of the "
        "ranks on %s with %d card(s)%s", pid, n_proc, backend,
        sum(h == host for h, _ in table), host, cards,
        "; collectives on card tensors go through the host"
        if backend == "gloo" and cards else "")
    return n_proc > 1


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def is_coordinator() -> bool:
    """True on the rank that owns single-writer artifacts (checkpoints,
    metrics history, plots, stats reports)."""
    return process_index() == 0


def local_device() -> torch.device:
    """This rank's card: its index among its host's ranks (torchrun's
    ``LOCAL_RANK``) modulo the card count; ``cuda:0`` for a single
    process.  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card "
                           "unless the caller asks for the CPU")
    index = _local_index if dist.is_initialized() else None
    if index is None:  # no group, or one a launcher made
        index = _env_int("LOCAL_RANK", process_index())
    return torch.device("cuda", index % torch.cuda.device_count())


def default_device() -> torch.device:
    """The entry points' device when the caller gives none, once
    ``maybe_initialize`` ran: this rank's card in a process group, else
    ``cuda:0``."""
    if dist.is_initialized():
        return local_device()
    return torch.device("cuda", 0)


def process_shard(items: Sequence, index: Optional[int] = None,
                  count: Optional[int] = None) -> list:
    """This rank's strided slice of a globally known work list (strided,
    not contiguous, so per-clip cost spreads evenly)."""
    i = process_index() if index is None else index
    n = process_count() if count is None else count
    return list(items)[i::n]


def barrier(name: str) -> None:
    """Every rank waits here (no-op single-process).  At stage artifact
    boundaries: rank 0 wipes an output dir before the others write, and all
    wait for every shard's artifacts before the next stage.  ``name`` says
    in the log where a rank waited."""
    if not is_multiprocess():
        return
    logger.debug("barrier %s", name)
    if backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it: on the rank's card under NCCL, on
    the host under gloo (ranks sharing a card, or none).  ``t`` itself
    where it already lies there."""
    if backend() == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t.cpu()


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` (default: every rank), in
    place; returns ``t``."""
    s = _staged(t)
    dist.all_reduce(s, group=group)
    if s is not t:
        t.copy_(s)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """The ``t`` of ``group``'s rank ``src`` (its place in the group) on
    every rank of ``group``, in place; returns ``t``."""
    s = _staged(t)
    dist.broadcast(s, src if group is None
                   else dist.get_global_rank(group, src), group=group)
    if s is not t:
        t.copy_(s)
    return t


def all_gather(t: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim`` in rank
    order, on ``t``'s device (the list form, which both backends have)."""
    s = _staged(t.contiguous())
    out = [torch.empty_like(s) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, s, group=group)
    return torch.cat(out, dim).to(t.device)


def all_sum_hosts(value: np.ndarray) -> np.ndarray:
    """Element-wise sum of a host array across ranks (identity
    single-process), in the array's dtype: int64 counts stay exact."""
    value = np.asarray(value)
    if not is_multiprocess():
        return value
    return all_reduce_(torch.from_numpy(np.array(value))).numpy()


def broadcast_host(value: np.ndarray, src: int = 0) -> np.ndarray:
    """Rank ``src``'s host array on every rank (every rank passes an array
    of the same shape and dtype)."""
    value = np.asarray(value)
    if not is_multiprocess():
        return value
    return broadcast_(torch.from_numpy(np.array(value)), src).numpy()


def all_gather_hosts(value: np.ndarray) -> np.ndarray:
    """(world, *shape) stack of every rank's host array, in rank order."""
    value = np.asarray(value)
    if not is_multiprocess():
        return value[None]
    return all_gather(torch.from_numpy(np.array(value))[None]).numpy()


def local_row_bounds(n_rows: int, index: Optional[int] = None,
                     count: Optional[int] = None) -> tuple:
    """(lo, hi) rows this rank owns of an ``n_rows`` batch split
    contiguously across ranks."""
    i = process_index() if index is None else index
    n = process_count() if count is None else count
    if n_rows % n:
        raise ValueError(f"{n_rows} rows not divisible by {n} processes")
    per = n_rows // n
    return i * per, (i + 1) * per
