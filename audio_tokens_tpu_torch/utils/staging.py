"""A client's host batch on its way to the card: the serving program's input
copy.

``HostStager.to_device(x)`` takes one route by what ``x`` shows:

* **staged**: a pageable CPU tensor and a CUDA program.  The rows are cut
  into stripes, one a host thread, and each stripe into chunks of whole
  rows (``stage_plan``).  Each thread copies its chunks, one after the
  other, into pinned slots of its own and sends each chunk to the card by
  a ``non_blocking`` copy on a side stream as soon as it is filled, into
  one device tensor of ``x``'s shape and dtype: the chunks' copies run
  while the threads fill the next ones.  A slot is refilled only after
  the event recorded behind its last copy has completed.  The compute
  stream waits on the side stream; the host never synchronizes with the
  card.  Every byte of ``x`` has been read on the host when ``to_device``
  returns, so its owner may reuse it at once.  A batch of one chunk or
  less is one slot, filled on the calling thread.  The threads, slots and
  events are a native pool of the stager's (``csrc/staging.cu``), made at
  first use; a slot's pinned buffer comes with its first fill and grows
  only when a larger chunk needs it.
* **direct**: a pinned CPU tensor: one ``non_blocking`` copy on the compute
  stream, and its event, which the caller waits on before handing the
  client's buffer back.
* **bypassed**: a tensor already on a device, an empty one, or a CPU
  program: ``x.to(device)``.

Bytes are copied as they are (a float32 batch or the int16 wire alike); a
non-contiguous ``x`` lands contiguous.  Nothing is kept of the client's
tensor between calls.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

# measured on the H100's host (PERF.md §5): the link moves 54 GB/s from
# pinned memory; a thread copies pageable rows at ~7 GB/s, 8 threads at
# 33-58.  Of 4, 6 and 8 threads, 1 to 16 MiB chunks and 2 or 3 slots a
# thread, 8 threads and 2 MiB chunks staged the serving batch (56.6 MB)
# soonest, with the fill's streaming stores
STAGE_THREADS = 8
STAGE_CHUNK_BYTES = 2 << 20
STAGE_SLOTS = 2  # a thread's: one filling, one whose copy runs


@dataclass
class H2DStats:
    """Counts of ``HostStager``: batches by route, the staged chunks and
    bytes, and the fills that waited on a slot's copy still in flight."""

    staged: int = 0
    direct: int = 0
    bypassed: int = 0
    chunks: int = 0
    bytes: int = 0
    slot_waits: int = 0


def stripes(lo: int, hi: int, parts: int) -> List[Tuple[int, int]]:
    """[lo, hi) split into at most ``parts`` non-empty ranges of near-equal
    size, in order."""
    n = min(parts, hi - lo)
    return [(lo + (hi - lo) * p // n, lo + (hi - lo) * (p + 1) // n)
            for p in range(n)]


def stage_plan(rows: int, row_bytes: int, chunk_bytes: int, threads: int,
               slots: int):
    """The staged route's entries as (lo, hi, slot, worker) int arrays:
    ``rows`` in stripes, one a worker, each cut into chunks of at most
    ``chunk_bytes`` (at least one row) that take the worker's ``slots``
    slots in turn; a batch of at most one chunk is worker 0's alone.
    Entries come in rounds: every worker's first chunk, then its second."""
    if rows * row_bytes <= chunk_bytes:
        threads = 1
    per = max(1, chunk_bytes // max(row_bytes, 1))
    entries = []
    for w, (a, b) in enumerate(stripes(0, rows, threads)):
        for c, lo in enumerate(range(a, b, per)):
            entries.append((c, w, lo, min(lo + per, b), w * slots + c % slots))
    entries.sort()
    lo, hi, slot, worker = (np.array([e[i] for e in entries], dtype=dtype)
                            for i, dtype in ((2, np.int64), (3, np.int64),
                                             (4, np.int32), (1, np.int32)))
    return lo, hi, slot, worker


def route(x: torch.Tensor, device: torch.device) -> str:
    """"staged", "direct" or "bypassed" (module docstring)."""
    if device.type != "cuda" or x.device.type != "cpu" or x.numel() == 0:
        return "bypassed"
    return "direct" if x.is_pinned() else "staged"


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (``csrc/staging.cu`` built) with its functions' types."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.atk_stage_pool_new.argtypes = [I, I, I]
    lib.atk_stage_pool_new.restype = P
    lib.atk_stage_pool_free.argtypes = [P]
    lib.atk_stage_pool_free.restype = None
    lib.atk_stage.argtypes = [P, P, L, L, P, P, P, P, P, L, P,
                              ctypes.POINTER(L)]
    lib.atk_stage.restype = I
    lib.atk_error_string.argtypes = [I]
    lib.atk_error_string.restype = ctypes.c_char_p
    return lib


class HostStager:
    """The host -> card input path of one program (module docstring).
    ``to_device`` may be called from several threads; staged batches take
    the pool one at a time.  ``close`` (or the stager's collection) stops
    the pool's threads and frees its slots."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.threads, self.slots = STAGE_THREADS, STAGE_SLOTS
        self.chunk_bytes = STAGE_CHUNK_BYTES
        self.stats = H2DStats()
        self._lib = None
        self._pool = None  # the native pool's handle
        self._stream = None
        self._lock = threading.Lock()

    def to_device(self, x: torch.Tensor):
        """-> (``x`` on the device, the event of a copy that still reads
        ``x`` or None)."""
        how = route(x, self.device)
        if how == "bypassed":
            self.stats.bypassed += 1
            return x.to(self.device), None
        if how == "direct":
            self.stats.direct += 1
            return self._direct(x)
        with self._lock:
            return self._stage(x.detach()), None

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        if not x[0].is_contiguous():  # rows the threads copy as bytes
            x = x.contiguous()
        rows, row_bytes = x.shape[0], x[0].numel() * x.element_size()
        lo, hi, slot, worker = stage_plan(rows, row_bytes, self.chunk_bytes,
                                          self.threads, self.slots)
        dst = self._empty(x.shape, x.dtype)
        lib, pool = self._native()
        waits = ctypes.c_int64(0)
        ptr = ctypes.c_void_p
        rc = lib.atk_stage(
            pool, x.data_ptr(), x.stride(0) * x.element_size(), row_bytes,
            dst.data_ptr(), lo.ctypes.data_as(ptr), hi.ctypes.data_as(ptr),
            slot.ctypes.data_as(ptr), worker.ctypes.data_as(ptr), len(lo),
            self._side_handle(), ctypes.byref(waits))
        if rc:
            raise RuntimeError(f"staging the batch failed: CUDA error {rc} "
                               f"({lib.atk_error_string(rc).decode()})")
        self._compute_waits(dst)
        self.stats.staged += 1
        self.stats.chunks += len(lo)
        self.stats.bytes += rows * row_bytes
        self.stats.slot_waits += waits.value
        return dst

    def _native(self):
        if self._pool is None:
            self._lib = self._load()
            index = self.device.index
            self._pool = self._lib.atk_stage_pool_new(
                self.threads, self.threads * self.slots,
                torch.cuda.current_device() if index is None else index)
            if not self._pool:
                raise RuntimeError("the staging pool's events could not be "
                                   "made")
        return self._lib, self._pool

    def close(self) -> None:
        """Stop the pool's threads and free its slots (after their copies)."""
        if getattr(self, "_pool", None) is not None:
            self._lib.atk_stage_pool_free(self._pool)
            self._pool = None

    def __del__(self):
        self.close()

    # -- the card's side (a test's fakes replace these) ---------------------
    def _load(self) -> ctypes.CDLL:
        from audio_tokens_tpu_torch.ops import _build

        return bind(_build.load("staging"))

    def _direct(self, x: torch.Tensor):
        y = x.to(self.device, non_blocking=True)
        read = torch.cuda.Event()
        read.record(torch.cuda.current_stream(self.device))
        return y, read

    def _side(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _side_handle(self) -> int:
        return self._side().cuda_stream

    def _empty(self, shape, dtype) -> torch.Tensor:
        # on the side stream, which writes it: the allocator hands this
        # memory to no other stream's work still in flight
        with torch.cuda.stream(self._side()):
            return torch.empty(shape, dtype=dtype, device=self.device)

    def _compute_waits(self, dst: torch.Tensor) -> None:
        compute = torch.cuda.current_stream(self.device)
        compute.wait_stream(self._side())
        # freed, its memory waits for the compute stream's reads too
        dst.record_stream(compute)
