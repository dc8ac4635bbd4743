"""Span-based tracing of the host round loop (Chrome trace_event export).

The round loop is a pipeline of host phases — plan prefetch wait, host plan
assembly, H2D commit, round-step dispatch, metric fetch (the device sync),
eval, checkpoint — executed across two threads (the consumer loop and the
cohort-prefetch producer).  A :class:`Tracer` records each phase as a *span*
(begin + duration + args, thread-aware) and exports

* Chrome ``trace_event`` JSON (``write_chrome``) — load in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing`` to see both threads'
  timelines and queue-depth counters; and
* a JSONL event log (``write_jsonl``) — one event per line for ad-hoc
  analysis without a trace viewer.

Instrumentation sites call the *module-level* :func:`span` / :func:`counter`
/ :func:`instant`, which no-op (one global read, shared null context) unless
a tracer is active — so the train loop and the prefetch thread are always
instrumented and tracing costs nothing until someone turns it on:

    with obs.trace.capture(chrome="trace.json", jsonl="events.jsonl"):
        train(loss, params, pipeline, fl, rounds=100)

Spans are cheap (two ``perf_counter_ns`` calls + one list append), but they
are host-side wall-clock only: device-side timing stays in the benchmarks.
Span taxonomy (the names the built-in instrumentation emits):

========================== ================================================
``round/plan_wait``        consumer blocked on the next round's plan
``round/step_dispatch``    round-step call (ends when the host has queued it)
``round/metrics_fetch``    host float() of round metrics (device sync)
``round/eval`` / ``round/checkpoint`` / ``round/log``  periodic host work
``plan/assemble``          host index-plan assembly (sampling, RR, faults)
``plan/h2d_commit``        device_put of the plan's arrays (transfer start)
``prefetch/plan_build``    producer-side plan production (both above)
``prefetch/backpressure``  producer blocked on the bounded queue
``prefetch/queue_depth``   counter: plans ready ahead of the consumer
========================== ================================================

The port's copy of ``repro.obs.trace``.  CUDA launches are asynchronous
like JAX's dispatch, so ``round/step_dispatch`` ends when the host has
queued the round and the device wait lands in ``round/metrics_fetch``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator

# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------


class _Span:
    """One live span (context manager); records itself on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        self._tracer._add("X", self._name, self._t0, t1 - self._t0, self._args)


class _NullSpan:
    """Shared no-op span — what :func:`span` returns when tracing is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects events in memory; exports Chrome trace JSON and JSONL.

    Event storage is a plain list of tuples (appends are atomic under the
    GIL, so producer threads never contend with the consumer); timestamps
    are ``perf_counter_ns`` relative to tracer creation.
    """

    def __init__(self, name: str = "fedshuffle"):
        self.name = name
        self._t0 = time.perf_counter_ns()
        # (ph, name, tid, thread_name, t_ns, dur_ns, args)
        self._events: list[tuple] = []

    # -- recording ----------------------------------------------------------

    def _add(self, ph: str, name: str, t_ns: int, dur_ns: int, args: dict) -> None:
        th = threading.current_thread()
        self._events.append(
            (ph, name, th.ident, th.name, t_ns - self._t0, dur_ns, args))

    def span(self, name: str, **args: Any) -> _Span:
        return _Span(self, name, args)

    def instant(self, name: str, **args: Any) -> None:
        self._add("i", name, time.perf_counter_ns(), 0, args)

    def counter(self, name: str, **values: Any) -> None:
        self._add("C", name, time.perf_counter_ns(), 0, values)

    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> list[dict]:
        """The recorded events as dicts (ts/dur in microseconds)."""
        return [
            {"ph": ph, "name": name, "tid": tid, "thread": tname,
             "ts": t_ns / 1e3, "dur": dur_ns / 1e3, "args": args}
            for ph, name, tid, tname, t_ns, dur_ns, args in list(self._events)
        ]

    # -- export -------------------------------------------------------------

    def chrome_events(self) -> list[dict]:
        """Chrome ``trace_event`` array: thread metadata + X/C/i events."""
        pid = os.getpid()
        tids: dict[int, tuple[int, str]] = {}
        out: list[dict] = [{"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "args": {"name": self.name}}]
        body: list[dict] = []
        for ph, name, tid, tname, t_ns, dur_ns, args in list(self._events):
            if tid not in tids:
                # stable small tids (0 = first thread seen) read better in
                # Perfetto than raw pthread idents
                tids[tid] = (len(tids), tname)
            ev = {"ph": ph, "name": name, "pid": pid, "tid": tids[tid][0],
                  "ts": t_ns / 1e3}
            if ph == "X":
                ev["dur"] = dur_ns / 1e3
            elif ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = dict(args)
            body.append(ev)
        for small, tname in tids.values():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": small, "args": {"name": tname}})
        return out + body

    def write_chrome(self, path: str) -> None:
        """Perfetto-loadable ``{"traceEvents": [...]}`` JSON."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, f, default=float)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev, default=float) + "\n")


# ---------------------------------------------------------------------------
# Module-level active tracer (what instrumentation sites talk to)
# ---------------------------------------------------------------------------

_ACTIVE: Tracer | None = None


def active() -> Tracer | None:
    """The currently installed tracer (None = tracing off)."""
    return _ACTIVE


def start(tracer: Tracer | None = None, name: str = "fedshuffle") -> Tracer:
    """Install ``tracer`` (or a fresh one) as the active tracer."""
    global _ACTIVE
    _ACTIVE = tracer if tracer is not None else Tracer(name=name)
    return _ACTIVE


def stop() -> Tracer | None:
    """Uninstall and return the active tracer (instrumentation goes no-op)."""
    global _ACTIVE
    t, _ACTIVE = _ACTIVE, None
    return t


def span(name: str, **args: Any):
    """A span on the active tracer — the shared no-op when tracing is off."""
    t = _ACTIVE
    return t.span(name, **args) if t is not None else _NULL_SPAN


def instant(name: str, **args: Any) -> None:
    t = _ACTIVE
    if t is not None:
        t.instant(name, **args)


def counter(name: str, **values: Any) -> None:
    t = _ACTIVE
    if t is not None:
        t.counter(name, **values)


@contextmanager
def capture(chrome: str | None = None, jsonl: str | None = None,
            name: str = "fedshuffle") -> Iterator[Tracer]:
    """Trace the enclosed block; write the exports on exit.

    Reentrant: a nested capture shadows (and then restores) the outer
    tracer, so library code can trace itself under an application trace.
    """
    global _ACTIVE
    prev = _ACTIVE
    tracer = Tracer(name=name)
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev
        if chrome:
            tracer.write_chrome(chrome)
        if jsonl:
            tracer.write_jsonl(jsonl)
