"""Async round prefetch: host plan assembly off the critical path.

The port's copy of ``repro.fed.cohort.prefetch``.  A daemon thread builds
the plans of rounds ``r .. r+depth`` ahead of the consumer and pushes them
through a bounded queue: while the card runs round r, the host samples
cohort r+1 and its copy to the card is already in flight.  Round order is
kept exactly, so prefetching never changes results, only wall-clock.

Producer exceptions are captured and re-raised at the consumer's
``next()``; ``close()`` (or the context manager) stops the thread promptly
even if the consumer stops early.

**State-ordering contract.**  Only *plans* (indices, masks, scalars) are
prefetched.  Per-client state (the ``ServerState.clients`` bank) is never
part of a plan: the round step gathers the bank rows named by the plan's
client ids when it runs, so state reads and writes stay round-ordered no
matter how far ahead the producer runs.  How a plan reaches the card is
the engine's business (``CohortEngine.round_plans``).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

_DONE = object()


class RoundPrefetcher:
    """Iterate ``(rnd, make_plan(rnd))`` for ``rounds`` rounds from
    ``start``, ``depth`` ahead."""

    def __init__(self, make_plan: Callable[[int], Any], rounds: int, depth: int = 2,
                 start: int = 0):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._rounds = rounds
        self._start = start
        self._make_plan = make_plan
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="cohort-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        """Block until ``item`` is queued or the consumer closed; True if
        it was queued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for r in range(self._start, self._start + self._rounds):
                if self._stop.is_set() or not self._put((r, self._make_plan(r))):
                    return
        except BaseException as e:  # noqa: BLE001 — surfaced to the consumer
            self._exc = e
        finally:
            self._put(_DONE)

    def __iter__(self) -> Iterator[tuple[int, Any]]:
        while True:
            item = self._q.get()
            if item is _DONE:
                if self._exc is not None:
                    raise self._exc
                return
            yield item

    def close(self) -> None:
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "RoundPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
