"""Level-aware structured logger + per-run metric accumulation.

``log`` / ``debug`` / ``warn`` emit one-line structured records gated by a
process log level — ``FEDSHUFFLE_LOG={debug,info,warn,quiet}`` from the
environment, or :func:`set_log_level` programmatically (launchers keep their
chatty per-round lines; a sweep sets ``quiet`` instead of redirecting
stdout).  ``log(msg, **kv)`` keeps its historical signature at info level.

:class:`MetricLogger` keeps its historical per-round row API (``append`` /
``rows`` / ``csv`` / ``dump`` / ``print_csv``) but is now a thin client of
an :class:`repro_torch.obs.metrics.MetricRegistry` holding one in-memory sink —
``train`` attaches file sinks (JSONL / CSV) to the same registry, and CSV
output uses the *union* of keys across rows in first-seen order, so columns
appearing mid-run (``eval_*`` on an eval round, fleet metrics) get their own
column instead of being silently dropped.  The port's copy of
``repro.utils.logging``.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any

from ..obs.metrics import InMemorySink, MetricRegistry, format_csv, union_keys

LOG_LEVELS = ("debug", "info", "warn", "quiet")

_LEVEL: str | None = None  # resolved lazily so tests can monkeypatch the env


def _resolve_level() -> str:
    level = os.environ.get("FEDSHUFFLE_LOG", "info").strip().lower()
    if level not in LOG_LEVELS:
        raise ValueError(
            f"FEDSHUFFLE_LOG={level!r} is not one of {LOG_LEVELS}")
    return level


def log_level() -> str:
    """The effective log level (env ``FEDSHUFFLE_LOG`` unless overridden)."""
    return _LEVEL if _LEVEL is not None else _resolve_level()


def set_log_level(level: str | None) -> None:
    """Override the process log level (None = back to the environment)."""
    global _LEVEL
    if level is not None and level not in LOG_LEVELS:
        raise ValueError(f"log level {level!r} is not one of {LOG_LEVELS}")
    _LEVEL = level


def _emit(level: str, msg: str, kv: dict) -> None:
    if LOG_LEVELS.index(level) < LOG_LEVELS.index(log_level()):
        return
    ts = time.strftime("%H:%M:%S")
    tag = "" if level == "info" else f" {level.upper()}"
    extras = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{ts}]{tag} {msg} {extras}".rstrip(),
          file=sys.stderr if level == "warn" else sys.stdout, flush=True)


def log(msg: str, **kv: Any) -> None:
    """Info-level structured line (the historical ``log`` signature)."""
    _emit("info", msg, kv)


def debug(msg: str, **kv: Any) -> None:
    _emit("debug", msg, kv)


def warn(msg: str, **kv: Any) -> None:
    """Warn-level line (stderr); shown at every level except ``quiet``."""
    _emit("warn", msg, kv)


class MetricLogger:
    """Per-round metric rows on top of a ``MetricRegistry`` + memory sink.

    Construct with an existing ``registry`` to share instruments/sinks with
    a caller (``train`` does); otherwise a private registry is created.
    """

    def __init__(self, name: str = "run", registry: MetricRegistry | None = None):
        self.name = name
        self._mem = InMemorySink()
        self.registry = registry if registry is not None else MetricRegistry(name=name)
        self.registry.add_sink(self._mem)

    @property
    def rows(self) -> list:
        return self._mem.records

    def append(self, **kv: Any) -> None:
        self.registry.emit_row(
            {k: (float(v) if hasattr(v, "item") else v) for k, v in kv.items()})

    def last(self) -> dict:
        return self.rows[-1] if self.rows else {}

    def csv(self) -> str:
        return format_csv(self.rows)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.rows:
                f.write(json.dumps(r, default=float) + "\n")

    def print_csv(self, every: int = 1, file=sys.stdout) -> None:
        if not self.rows:
            return
        keys = union_keys(self.rows)
        print(",".join(keys), file=file)
        for i, r in enumerate(self.rows):
            if i % every == 0 or i == len(self.rows) - 1:
                print(",".join("" if r.get(k) is None else str(r.get(k, ""))
                               for k in keys), file=file)
