"""Structured log lines + per-run metric rows.

``log(msg, **kv)`` prints one timestamped line, gated like the JAX package's
logger by ``FEDSHUFFLE_LOG={debug,info,warn,quiet}``.  :class:`MetricLogger`
keeps the per-round rows (``append`` / ``rows`` / ``last`` / ``csv``); CSV
output uses the union of keys across rows in first-seen order, so columns
that appear mid-run (``eval_*`` on an eval round) get their own column.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Any

LOG_LEVELS = ("debug", "info", "warn", "quiet")


def log(msg: str, **kv: Any) -> None:
    """Info-level structured line (silent at ``FEDSHUFFLE_LOG=warn|quiet``)."""
    level = os.environ.get("FEDSHUFFLE_LOG", "info").strip().lower()
    if level not in LOG_LEVELS:
        raise ValueError(f"FEDSHUFFLE_LOG={level!r} is not one of {LOG_LEVELS}")
    if LOG_LEVELS.index(level) > LOG_LEVELS.index("info"):
        return
    extras = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{time.strftime('%H:%M:%S')}] {msg} {extras}".rstrip(), file=sys.stdout, flush=True)


class MetricLogger:
    """Per-round metric rows (dicts of Python scalars)."""

    def __init__(self, name: str = "run"):
        self.name = name
        self.rows: list[dict] = []

    def append(self, **kv: Any) -> None:
        self.rows.append({k: (float(v) if hasattr(v, "item") else v) for k, v in kv.items()})

    def last(self) -> dict:
        return self.rows[-1] if self.rows else {}

    def csv(self) -> str:
        keys = list(dict.fromkeys(k for r in self.rows for k in r))
        lines = [",".join(keys)]
        lines += [",".join("" if r.get(k) is None else str(r[k]) for k in keys) for r in self.rows]
        return "\n".join(lines)
