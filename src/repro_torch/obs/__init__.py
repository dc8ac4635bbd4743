"""Observability plane: tracing, metric registry, in-round distribution
summaries.

Three layers, all inert by default (``FLConfig.telemetry = "off"`` keeps
every configuration's ServerState and metric keys as they are; tracing
no-ops until a tracer is installed):

* :mod:`repro_torch.obs.trace`   — span-based host-loop tracing, Chrome
  ``trace_event`` / JSONL export (open in Perfetto), thread-aware (the
  prefetch producer reports plan-build spans and queue depth).
* :mod:`repro_torch.obs.metrics` — counters / gauges / histograms behind a
  ``Sink`` protocol (memory / jsonl / csv, extensible via
  :func:`register_sink`); ``utils.logging.MetricLogger`` is a thin client.
* :mod:`repro_torch.obs.hist`    — fixed-shape histograms the round step
  emits from its slot-order ``[C]`` arrays (step counts, update norms,
  staleness, wire bytes, suspicion, the DP clip scale).

``fl.telemetry`` selects what runs: ``"metrics"`` adds the in-round
histograms + registry accounting, ``"trace"`` only the host spans,
``"full"`` both.  The port's counterpart of ``repro.obs`` without
``sentinels`` (XLA compile counting), which waits for compiled round steps;
so the rows carry no ``jax_compiles``.
"""
from . import hist, metrics, trace
from .hist import HIST_PREFIX, fixed_histogram, log_edges, pow2_edges
from .metrics import (SINKS, CSVSink, Histogram, InMemorySink, JSONLSink, MetricRegistry,
                      build_sink, format_csv, register_sink, union_keys)
from .trace import Tracer, capture

TELEMETRY_MODES = ("off", "metrics", "trace", "full")


def metrics_enabled(telemetry: str) -> bool:
    """Whether ``fl.telemetry`` asks for in-round summaries + registry rows."""
    return telemetry in ("metrics", "full")


def tracing_requested(telemetry: str) -> bool:
    """Whether ``fl.telemetry`` asks for host span tracing."""
    return telemetry in ("trace", "full")


def validate_telemetry_config(fl) -> None:
    """Bind-time validation of the telemetry knobs: bad values fail at bind,
    not rounds into a run."""
    if fl.telemetry not in TELEMETRY_MODES:
        raise ValueError(
            f"unknown telemetry mode {fl.telemetry!r}; have {TELEMETRY_MODES}")
    if fl.telemetry_bins < 2:
        raise ValueError(
            f"fl.telemetry_bins must be >= 2, got {fl.telemetry_bins}")


__all__ = [
    "CSVSink", "HIST_PREFIX", "Histogram", "InMemorySink", "JSONLSink",
    "MetricRegistry", "SINKS", "TELEMETRY_MODES", "Tracer", "build_sink", "capture",
    "fixed_histogram", "format_csv", "hist", "log_edges", "metrics", "metrics_enabled",
    "pow2_edges", "register_sink", "trace", "tracing_requested", "union_keys",
    "validate_telemetry_config",
]
