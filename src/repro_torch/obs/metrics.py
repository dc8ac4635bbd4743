"""Metric registry: counters / gauges / histograms behind a Sink protocol.

The runtime's metric surface was a 50-line ``MetricLogger`` accumulating
per-round rows; this module is the layer underneath it — typed instruments
(:class:`Counter`, :class:`Gauge`, :class:`Histogram`) owned by a
:class:`MetricRegistry` that streams row records to pluggable sinks:

* ``memory`` — :class:`InMemorySink`, the in-process record list tests and
  ``MetricLogger.rows`` read;
* ``jsonl``  — :class:`JSONLSink`, one JSON record per line (the CI metric
  artifact format);
* ``csv``    — :class:`CSVSink`, buffered rows flushed as CSV with the
  *union* of keys across all rows in first-seen order (keys appearing
  mid-run — ``eval_*`` on a later round, fleet metrics after a warm start —
  land in their own column instead of being dropped).

Sinks are registered exactly like codecs and fleets (:data:`SINKS` +
:func:`register_sink`; resolve a ``"name[:arg]"`` spec via
:func:`build_sink`), so downstream planes (DP accounting, sharded-mesh
runs) can add exporters without touching this module.

``utils.logging.MetricLogger`` is a thin client of a registry holding one
memory sink; ``fed.train_loop`` attaches file sinks and folds the round's
device histogram counts into registry :class:`Histogram` instruments when
``fl.telemetry`` asks for metrics.  The port's copy of
``repro.obs.metrics``.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Iterable, Mapping

import numpy as np

# ---------------------------------------------------------------------------
# Row formatting (shared by CSVSink and MetricLogger)
# ---------------------------------------------------------------------------


def union_keys(rows: Iterable[Mapping]) -> list:
    """All keys across ``rows`` in first-seen order (not just ``rows[0]``)."""
    keys: dict = {}
    for r in rows:
        for k in r:
            keys.setdefault(k, None)
    return list(keys)


def format_csv(rows: list) -> str:
    """CSV over the union of row keys; absent cells are empty."""
    if not rows:
        return ""
    keys = union_keys(rows)
    lines = [",".join(str(k) for k in keys)]
    for r in rows:
        lines.append(",".join("" if r.get(k) is None else str(r.get(k, ""))
                              for k in keys))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------


class InMemorySink:
    """Keeps records in a list — the test / MetricLogger backing store."""

    def __init__(self):
        self.records: list[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class JSONLSink:
    """One JSON object per record, streamed to ``path``."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(record, default=float) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class CSVSink:
    """Buffers records, writes union-of-keys CSV on close."""

    def __init__(self, path: str):
        self.path = path
        self._rows: list[dict] = []

    def emit(self, record: dict) -> None:
        self._rows.append(record)

    def close(self) -> None:
        with open(self.path, "w") as f:
            f.write(format_csv(self._rows))
            if self._rows:
                f.write("\n")


SINKS: dict[str, Callable[..., Any]] = {
    "memory": InMemorySink,
    "jsonl": JSONLSink,
    "csv": CSVSink,
}


def register_sink(name: str, make: Callable[..., Any], *,
                  overwrite: bool = False) -> None:
    """Register ``make(arg?) -> Sink`` under ``name`` (build_sink spec key)."""
    if not overwrite and name in SINKS:
        raise ValueError(
            f"metric sink {name!r} already registered (pass overwrite=True to replace)")
    SINKS[name] = make


def build_sink(spec: str):
    """Resolve a ``"name"`` / ``"name:arg"`` spec (e.g. ``"jsonl:m.jsonl"``)."""
    name, _, arg = spec.partition(":")
    if name not in SINKS:
        raise ValueError(f"unknown metric sink {name!r}; have {sorted(SINKS)}")
    return SINKS[name](arg) if arg else SINKS[name]()


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------


class Counter:
    """Monotone count (rounds run, compiles seen, plans produced)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-written value (queue depth, lr multiplier, bank bytes)."""

    def __init__(self, name: str):
        self.name = name
        self.value: float | None = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bin histogram (host side).

    ``edges`` is the full static edge array ``[bins + 1]`` (see
    ``obs.hist`` for the edge builders); values outside the range clamp
    into the first / last bin, so the bin cardinality never changes — the
    same contract the in-round histograms hold.  ``merge_counts`` folds a
    device-computed ``[bins]`` count vector (one round's summary)
    into the running totals.
    """

    def __init__(self, name: str, edges):
        self.name = name
        self.edges = np.asarray(edges, np.float64)
        if self.edges.ndim != 1 or self.edges.size < 2:
            raise ValueError(f"histogram {name!r}: edges must be [bins+1], "
                             f"got shape {self.edges.shape}")
        self.counts = np.zeros(self.edges.size - 1, np.float64)

    @property
    def bins(self) -> int:
        return self.counts.size

    def observe(self, values, weights=None) -> None:
        v = np.atleast_1d(np.asarray(values, np.float64))
        idx = np.clip(np.searchsorted(self.edges, v, side="right") - 1,
                      0, self.bins - 1)
        w = (np.ones_like(v) if weights is None
             else np.atleast_1d(np.asarray(weights, np.float64)))
        np.add.at(self.counts, idx, w)

    def merge_counts(self, counts) -> None:
        c = np.asarray(counts, np.float64)
        if c.shape != self.counts.shape:
            raise ValueError(
                f"histogram {self.name!r}: merge of {c.shape} counts into "
                f"{self.counts.shape} bins")
        self.counts += c

    @property
    def total(self) -> float:
        return float(self.counts.sum())

    def summary(self) -> dict:
        return {"edges": self.edges.tolist(), "counts": self.counts.tolist(),
                "total": self.total}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


class MetricRegistry:
    """Named instruments + row streaming to sinks.

    Instruments are get-or-create by name (asking for an existing name with
    a different type raises — a silent re-type would corrupt both users).
    ``emit_row`` streams one record (a per-round metric row) to every sink;
    ``snapshot``/``dump_summary`` export the instruments' final state.
    """

    def __init__(self, name: str = "run", sinks: Iterable = ()):
        self.name = name
        self.sinks: list = list(sinks)
        self._instruments: dict[str, Any] = {}

    def add_sink(self, sink) -> None:
        self.sinks.append(sink)

    def _get(self, name: str, kind, *args):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = kind(name, *args)
        elif not isinstance(inst, kind):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, not {kind.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, edges=None) -> Histogram:
        if name not in self._instruments and edges is None:
            raise ValueError(f"histogram {name!r}: first use must pass edges")
        return self._get(name, Histogram, *(() if edges is None else (edges,)))

    def instruments(self) -> dict:
        return dict(self._instruments)

    def _drop_sink(self, sink, op: str, exc: Exception) -> None:
        """Disable a failing sink: one warning, then it never runs again.

        Telemetry must not kill training — a full disk or a removed
        directory under a jsonl/csv sink raises out of ``emit``/``close``,
        and letting that propagate would abort the train loop over a
        logging problem.  The other sinks keep streaming."""
        from ..utils.logging import warn  # deferred: utils.logging imports us

        warn(f"metric sink failed during {op}; disabling it",
             sink=type(sink).__name__, error=f"{type(exc).__name__}: {exc}")
        if sink in self.sinks:
            self.sinks.remove(sink)
        try:
            sink.close()
        except Exception:
            pass  # best-effort: the sink is already being dropped

    def emit_row(self, record: Mapping) -> None:
        rec = dict(record)
        for sink in list(self.sinks):
            try:
                sink.emit(rec)
            except Exception as exc:
                self._drop_sink(sink, "emit", exc)

    def snapshot(self) -> dict:
        out: dict = {"name": self.name, "counters": {}, "gauges": {},
                     "histograms": {}}
        for name, inst in self._instruments.items():
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            elif isinstance(inst, Histogram):
                out["histograms"][name] = inst.summary()
        return out

    def dump_summary(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, default=float)

    def close(self) -> None:
        for sink in list(self.sinks):
            try:
                sink.close()
            except Exception as exc:
                self._drop_sink(sink, "close", exc)
