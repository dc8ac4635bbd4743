"""End-to-end federated training driver (the host loop around the round step).

Handles pipeline iteration, LR schedules (constant / cosine / WSD /
staircase), periodic eval, checkpointing, resume and metric logging.  Rounds
arrive in the layout ``fl.exec_mode`` asks for: padded ``RoundBatch`` /
``IndexPlan`` or bucketed ``BucketedBatch`` / ``BucketedPlan`` (a round
whose slots overflow the buckets comes padded); on the cohort engine they
are prefetched ``fl.prefetch`` rounds ahead.  With the fleet plane on, each
row also carries the cumulative ``virtual_time`` (the sum of the rounds'
``round_virtual_time``).

Observability (``repro_torch.obs``): every host phase of the loop is wrapped
in a trace span (``round/plan_wait``, ``round/step_dispatch``,
``round/metrics_fetch``, ``round/eval``, ``round/checkpoint``,
``round/log``), no-ops unless a tracer is active.  CUDA launches are
asynchronous, as JAX's dispatch is: ``round/step_dispatch`` ends when the
host has queued the round, and the wait for the device lands in
``round/metrics_fetch`` (``float(v)`` synchronizes).  When ``fl.telemetry``
asks for metrics, the round's ``hist_*`` device counts are folded into
registry :class:`~repro_torch.obs.metrics.Histogram` instruments (never into
the scalar row).  Passing ``telemetry_dir=`` streams the rows to
``metrics.jsonl``, writes a ``summary.json`` instrument snapshot, and (when
``fl.telemetry`` requests tracing and no tracer is already active) captures
``trace.json`` / ``events.jsonl`` for the whole run.  With DP on
(``repro_torch.fed.privacy``) every row carries the accountant's
cumulative ``dp_epsilon`` (also a registry gauge) and each checkpoint's
metadata its ``dp_accounting`` record.  The port's counterpart of
``repro.fed.train_loop``; its rows carry no ``jax_compiles`` (XLA compile
counting waits for compiled round steps) and add ``elapsed_s``.
"""
from __future__ import annotations

import os
import time
from contextlib import ExitStack
from dataclasses import dataclass
from typing import Any, Callable

from ..configs.base import FLConfig
from ..data.federated import FederatedPipeline
from ..obs import trace, tracing_requested
from ..obs.hist import HIST_PREFIX
from ..obs.metrics import JSONLSink, MetricRegistry
from ..utils.checkpoint import save_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger, log
from .cohort.engine import CohortEngine
from .privacy import accountant_for, dp_active, dp_checkpoint_record
from .rounds import build_round_step
from .server import ServerState, cosine_schedule, wsd_schedule
from .strategy import BoundStrategy, FedStrategy, bind_strategy

SCHEDULES: dict[str, Callable[[int, int], float]] = {
    "constant": lambda r, total: 1.0,
    "cosine": cosine_schedule,
    "wsd": wsd_schedule,
    # the paper's staircase: x0.1 at 50% and 75% of the rounds (App. F)
    "staircase": lambda r, total: 0.1 ** ((r >= total // 2) + (r >= (3 * total) // 4)),
}


@dataclass
class TrainResult:
    state: ServerState
    metrics: MetricLogger
    registry: MetricRegistry | None = None


def train(
    loss_fn: Callable,
    init_params: Any,
    pipeline: "FederatedPipeline | CohortEngine",
    fl: FLConfig,
    rounds: int,
    *,
    strategy: FedStrategy | BoundStrategy | None = None,
    eval_fn: Callable[[Any], dict] | None = None,
    eval_every: int = 50,
    schedule: str = "constant",
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    log_every: int = 50,
    name: str = "run",
    state: ServerState | None = None,
    start_round: int = 0,
    telemetry_dir: str | None = None,
    device=None,
) -> TrainResult:
    """Run rounds ``start_round..rounds`` on ``device`` (``cuda`` unless
    given; a cohort engine's bank must live there).  ``init_params`` is a
    flat dict of tensors on that device; it is copied, not consumed.

    Resume: pass the ``ServerState`` that ``utils.checkpoint.
    load_server_state`` restored as ``state`` and the round it had
    completed as ``start_round``.  Schedules and round seeds are keyed by
    the absolute round, so a resumed run replays the unbroken one bitwise.
    The round step updates the state's bank in place, so ``state`` must not
    be used again.  ``checkpoint_path`` saves the params (JAX's format) every
    ``checkpoint_every`` rounds and at the end.  ``telemetry_dir``: see the
    module docstring."""
    device = resolve_device(device)
    sched = SCHEDULES[schedule]
    strat = bind_strategy(strategy, fl, loss_fn, num_clients=fl.num_clients)
    if state is None:
        state = strat.init(init_params)
    elif int(state.rnd) != start_round:
        # rnd counts completed rounds; a mismatched resume would silently
        # replay or skip rounds and break the bitwise-resume guarantee
        raise ValueError(
            f"state.rnd = {int(state.rnd)} but start_round = {start_round}; "
            f"resume from the round the checkpointed state had completed.")

    # cohort engine: rounds arrive as device IndexPlans (BucketedPlans)
    # gathered through the resident data plane; legacy: host-assembled
    # RoundBatches (BucketedBatches)
    engine = pipeline if isinstance(pipeline, CohortEngine) else None
    if engine is not None and engine.fl != fl:
        raise ValueError("fl differs from the config the CohortEngine was built over")
    if engine is None and fl.engine == "cohort":
        engine = CohortEngine.from_pipeline(pipeline, device=device)
    step = build_round_step(loss_fn, strat, fl, num_clients=fl.num_clients,
                            plane=engine.plane if engine else None, device=device)

    registry = MetricRegistry(name=name)
    ml = MetricLogger(name=name, registry=registry)
    # registry Histograms over the round step's own edge table: each
    # round's device [bins] counts merge into the run's accumulators
    hists = {k: registry.histogram(k, edges) for k, edges in step.telemetry_hist_edges.items()}
    # cumulative eps(delta) is a pure function of (fl, completed rounds), so
    # a resumed run reports bitwise the same epsilon at every round
    acct = accountant_for(fl) if dp_active(fl) else None
    t0 = time.time()

    def round_iter():
        if engine is None:
            for r in range(start_round, rounds):
                yield r, pipeline.round_batch(r)
        else:
            with engine.round_plans(rounds - start_round, start=start_round) as it:
                yield from it

    def checkpoint(r: int, completed: int) -> None:
        with trace.span("round/checkpoint", round=r):
            meta = {"round": r, "elapsed_s": time.time() - t0, "name": name}
            if acct is not None:
                meta["dp_accounting"] = dp_checkpoint_record(fl, completed)
            save_checkpoint(checkpoint_path, state.params, meta)

    with ExitStack() as stack:
        if telemetry_dir is not None:
            os.makedirs(telemetry_dir, exist_ok=True)
            registry.add_sink(JSONLSink(os.path.join(telemetry_dir, "metrics.jsonl")))
            if tracing_requested(fl.telemetry) and trace.active() is None:
                stack.enter_context(trace.capture(
                    chrome=os.path.join(telemetry_dir, "trace.json"),
                    jsonl=os.path.join(telemetry_dir, "events.jsonl"), name=name))
        virtual_time = 0.0
        rit = round_iter()
        try:
            while True:
                with trace.span("round/plan_wait"):
                    try:
                        r, batch = next(rit)
                    except StopIteration:
                        break
                with trace.span("round/step_dispatch", round=r):
                    state, mets = step(state, batch, sched(r, rounds))
                with trace.span("round/metrics_fetch", round=r):
                    row = {"round": r, "lr_mult": sched(r, rounds),
                           **{k: float(v) for k, v in mets.items()
                              if not k.startswith(HIST_PREFIX)}}
                    for k, h in hists.items():
                        if k in mets:
                            h.merge_counts(mets[k].cpu().numpy())
                if "round_virtual_time" in row:
                    # the cumulative virtual clock fleet runs plot loss
                    # against (present only with the fleet plane on)
                    virtual_time += row["round_virtual_time"]
                    row["virtual_time"] = virtual_time
                if acct is not None:
                    # the privacy budget spent through this round (r + 1 done)
                    row["dp_epsilon"] = acct.epsilon(r + 1)
                    registry.gauge("dp_epsilon").set(row["dp_epsilon"])
                if "total_comm_mbytes" in row:
                    # cumulative bytes on the wire, both directions
                    registry.counter("total_comm_mbytes").inc(row["total_comm_mbytes"])
                if "rounds_rejected" in row:
                    # the robust plane's run totals: rare spikes, so the
                    # summary reports the cumulative counts
                    registry.counter("rounds_rejected").inc(row["rounds_rejected"])
                    registry.counter("quarantined_clients").inc(
                        row.get("quarantined_clients", 0.0))
                if eval_fn is not None and (r % eval_every == 0 or r == rounds - 1):
                    with trace.span("round/eval", round=r):
                        row.update({f"eval_{k}": float(v)
                                    for k, v in eval_fn(state.params).items()})
                row["elapsed_s"] = time.time() - t0
                ml.append(**row)
                if log_every and (r % log_every == 0 or r == rounds - 1):
                    with trace.span("round/log", round=r):
                        log(f"[{name}] round {r}/{rounds}",
                            **{k: f"{v:.5f}" if isinstance(v, float) else v
                               for k, v in row.items() if k != "round"})
                if checkpoint_path and checkpoint_every and (r + 1) % checkpoint_every == 0:
                    checkpoint(r, r + 1)
        finally:
            rit.close()      # an early stop ends the prefetch thread
            if telemetry_dir is not None:
                registry.dump_summary(os.path.join(telemetry_dir, "summary.json"))
                registry.close()
    if checkpoint_path:
        checkpoint(rounds - 1, rounds)
    return TrainResult(state=state, metrics=ml, registry=registry)
