"""Virtual-clock executor: event-driven simulation of an asynchronous fleet.

:class:`BufferedSchedule` advances a virtual clock over client-completion
events (a time-ordered heap) and partitions them into server *ticks* — the
FedBuff-style buffered-async server aggregates the first ``fl.buffer_size``
non-dropped arrivals per tick, so in fleet terms one tick is one aggregation
round.  ``fl.cohort_size`` clients are kept in flight (the concurrency M):
every completion or dropout immediately frees its slot and a fresh client is
dispatched at that instant, drawn from the configured participation schedule
(``cohort.scheduler.sample_round``) skipping clients already in flight *or*
already aggregated in the tick being assembled — one tick never aggregates
the same client twice (the per-client state bank commits one row per client
per round), which needs ``num_clients >= cohort_size + buffer_size - 1``.

Versioning / staleness contract: the server's model version equals the tick
index — work dispatched while tick ``t`` is being assembled trains on the
post-tick-``t-1`` params ("version t"), so an update aggregated in tick
``u`` carries ``staleness = u - t`` server steps (>= 0).  The aggregation
discounts stale updates via
:func:`~repro_torch.fed.fleet.buffered.staleness_weights`.

Simulation approximations (the JAX package's, standard for memory-bounded
FedBuff simulation):

* a client's realized local work (RR streams, epoch draw, codec keys) is
  keyed by its *aggregation* tick, not its dispatch tick — this keeps
  ``plan.rnd`` a scalar and the round machinery unchanged;
* its wall time uses the *dispatch*-tick epoch draw (same distribution);
* deltas are computed at current params and staleness-discounted rather
  than replaying historical params.

The schedule is host-side, O(buffer log concurrency) per tick, lazily
simulated and cached per tick, so random re-access replays identical
outcomes and a resume replays it from tick 0.  Simulating forward mutates
it, so :meth:`BufferedSchedule.tick` holds a lock: the cohort engine's
prefetch thread and a caller on the main thread may both ask for ticks.
The port's counterpart of ``repro.fed.fleet.clock`` (host numpy).
"""
from __future__ import annotations

import heapq
import threading
from collections import deque
from typing import NamedTuple

import numpy as np

from ...configs.base import FLConfig
from ...data.federated import Population
from .faults import apply_faults
from .model import FleetModel

_MAX_POPS_PER_TICK = 100_000   # runaway guard (drop_prob ~ 1 pathologies)


class TickOutcome(NamedTuple):
    """One server tick: who got aggregated, who dropped, and when."""

    ids: np.ndarray            # [K] int64 aggregated clients (arrival order)
    probs: np.ndarray          # [K] float64 inclusion probs (at dispatch)
    staleness: np.ndarray      # [K] float64 server ticks since dispatch (>= 0)
    arrive: np.ndarray         # [K] float64 arrival offsets within the tick
    dropped_ids: np.ndarray    # [D] int64 clients whose failure landed here
    dropped_arrive: np.ndarray # [D] float64 their event offsets
    duration: float            # virtual time this tick spanned (K-th arrival)
    clock: float               # absolute virtual time at the flush


class BufferedSchedule:
    """Lazily simulated, per-tick-cached buffered-async round schedule."""

    def __init__(self, fl: FLConfig, population: Population,
                 fleet: FleetModel, *, probs: np.ndarray | None,
                 steps_fn) -> None:
        if fl.buffer_size < 1:
            raise ValueError(f"fl.buffer_size must be >= 1, got {fl.buffer_size}")
        self.fl = fl
        self.population = population
        self.fleet = fleet
        self.probs = probs
        self.steps_fn = steps_fn            # (client_id, tick) -> planned steps
        self.concurrency = fl.cohort_size
        self.buffer = fl.buffer_size
        self._lock = threading.Lock()
        self._heap: list = []               # (abs_time, seq, cid, version, prob, dropped)
        self._seq = 0
        self._in_flight: set[int] = set()
        # clients aggregated in the tick being assembled: blocked from
        # redispatch until the flush, so one tick never aggregates the same
        # client twice
        self._tick_block: set[int] = set()
        self._queue: deque = deque()        # (cid, prob) candidate stream
        self._stream_round = 0
        self._ticks: list[TickOutcome] = []
        self._clock = 0.0
        self.dispatched = 0
        # event log in pop order — (abs_time, kind, cid, version); times are
        # monotone non-decreasing by heap order
        self.events: list[tuple[float, str, int, int]] = []
        for _ in range(self.concurrency):
            self._dispatch(0.0, 0)

    # -- sampling stream ----------------------------------------------------

    def _next_candidate(self) -> tuple[int, float]:
        from ..cohort.scheduler import sample_round  # deferred: cohort imports the pipeline

        while not self._queue:
            s = sample_round(self.fl, self.population, self._stream_round,
                             slots=self.population.num_clients, probs=self.probs)
            self._stream_round += 1
            self._queue.extend(zip(np.asarray(s.ids, np.int64).tolist(),
                                   np.asarray(s.probs, np.float64).tolist()))
        return self._queue.popleft()

    def _dispatch(self, now: float, version: int) -> None:
        """Start one not-in-flight client at virtual time ``now`` on server
        version ``version``; its completion (or failure) event lands on the
        heap at ``now + wall``."""
        for _ in range(_MAX_POPS_PER_TICK):
            cid, prob = self._next_candidate()
            if cid not in self._in_flight and cid not in self._tick_block:
                break
        else:
            raise RuntimeError(
                "BufferedSchedule: could not draw a free client — is "
                "num_clients < cohort_size + buffer_size - 1?")
        steps = self.steps_fn(int(cid), int(version))
        rf = apply_faults(self.fl, self.fleet, np.array([cid]), version,
                          np.array([steps], np.int64))
        self._in_flight.add(cid)
        self._seq += 1
        self.dispatched += 1
        heapq.heappush(self._heap, (now + float(rf.wall[0]), self._seq,
                                    int(cid), int(version), float(prob),
                                    bool(rf.dropped[0])))

    # -- tick assembly ------------------------------------------------------

    def tick(self, t: int) -> TickOutcome:
        """Outcome of server tick ``t`` (simulating forward as needed)."""
        with self._lock:
            while len(self._ticks) <= int(t):
                self._advance()
            return self._ticks[int(t)]

    def _advance(self) -> None:
        t = len(self._ticks)
        ids, probs, stal, arr = [], [], [], []
        d_ids, d_arr = [], []
        pops = 0
        while len(ids) < self.buffer:
            abs_t, _, cid, version, prob, dropped = heapq.heappop(self._heap)
            self._in_flight.discard(cid)
            self.events.append((abs_t, "drop" if dropped else "arrive", cid, version))
            if dropped:
                d_ids.append(cid)
                d_arr.append(abs_t)
            else:
                ids.append(cid)
                probs.append(prob)
                stal.append(float(t - version))
                arr.append(abs_t)
                self._tick_block.add(cid)
            if len(ids) >= self.buffer:
                # the K-th arrival flushes the tick — aggregated clients are
                # free again from the next tick's window onward
                self._tick_block.clear()
            # the slot frees the instant the event lands; the replacement
            # trains on the server version of the tick being assembled
            self._dispatch(abs_t, t)
            pops += 1
            if pops > _MAX_POPS_PER_TICK:
                raise RuntimeError(
                    f"BufferedSchedule tick {t}: {pops} events without "
                    f"{self.buffer} arrivals — drop_prob too close to 1?")
        flush = arr[-1]
        out = TickOutcome(
            ids=np.asarray(ids, np.int64),
            probs=np.asarray(probs, np.float64),
            staleness=np.asarray(stal, np.float64),
            arrive=np.asarray(arr, np.float64) - self._clock,
            dropped_ids=np.asarray(d_ids, np.int64),
            dropped_arrive=np.asarray(d_arr, np.float64) - self._clock,
            duration=float(flush - self._clock),
            clock=float(flush),
        )
        self._clock = flush
        self._ticks.append(out)
