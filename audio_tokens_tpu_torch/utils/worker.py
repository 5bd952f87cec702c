"""Shared bounded producer-thread pipeline.

A copy of ``audio_tokens_tpu/utils/worker.py``, held equal to the original
by ``tests/test_torch_train_data.py``.  In the port it runs the
``BatchLoader``'s batch assembly: a daemon thread produces items into a
bounded queue while the consumer runs, with

  * a stop event checked on every (timed) put, so the producer exits
    promptly when the consumer stops early (break / exception) instead of
    blocking forever holding device-resident items;
  * exception forwarding: a producer-side error is re-raised in the
    consumer at the point of consumption;
  * a done sentinel terminating normal iteration.
"""

from __future__ import annotations

import queue as _queue
import threading


class BoundedProducer:
    """Runs ``items`` (any iterator/generator — its ``__next__`` does the
    production work) on a daemon thread, buffering up to ``depth`` results.

    Iterate the instance to consume; iteration re-raises producer
    exceptions.  The stop event is set when the consumer's iterator exits
    for ANY reason (exhaustion, break, exception); ``close()`` additionally
    drains the queue and joins the thread (use in a ``finally`` when item
    identity matters, e.g. buffers being recycled)."""

    _DONE = object()

    def __init__(self, items, depth: int = 2):
        self._q = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._consumed = False

        def produce():
            try:
                for item in items:
                    if not self._put(item):
                        return
                self._put(BoundedProducer._DONE)
            except BaseException as e:  # re-raised in the consumer
                self._put(e, force=True)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def _put(self, item, force: bool = False) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.25)
                return True
            except _queue.Full:
                continue
        if force:  # consumer gone: best-effort, never block
            try:
                self._q.put_nowait(item)
            except _queue.Full:
                pass
        return False

    def __iter__(self):
        # single-consumption: a second pass would block forever on the
        # empty queue (the producer already exited) — fail loud instead
        if self._consumed:
            raise RuntimeError(
                "BoundedProducer can only be iterated once; construct a "
                "fresh pipeline per pass"
            )
        self._consumed = True
        try:
            while True:
                item = self._q.get()
                if item is BoundedProducer._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self._stop.set()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=5)
