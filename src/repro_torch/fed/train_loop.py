"""End-to-end federated training driver (the host loop around the round step).

Handles pipeline iteration, LR schedules (constant / staircase), periodic
eval and metric logging.  Rounds arrive in the layout ``fl.exec_mode`` asks
for: padded ``RoundBatch`` / ``IndexPlan`` or bucketed ``BucketedBatch`` /
``BucketedPlan`` (a round whose slots overflow the buckets comes padded).
The port's counterpart of ``repro.fed.train_loop``; checkpointing, the
cosine / WSD schedules and the observability plane are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

from ..configs.base import FLConfig
from ..data.federated import FederatedPipeline
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger, log
from .cohort.engine import CohortEngine
from .rounds import build_round_step
from .server import ServerState
from .strategy import BoundStrategy, FedStrategy, bind_strategy

SCHEDULES: dict[str, Callable[[int, int], float]] = {
    "constant": lambda r, total: 1.0,
    # the paper's staircase: x0.1 at 50% and 75% of the rounds (App. F)
    "staircase": lambda r, total: 0.1 ** ((r >= total // 2) + (r >= (3 * total) // 4)),
}


@dataclass
class TrainResult:
    state: ServerState
    metrics: MetricLogger


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
    log_every: int = 50,
    name: str = "run",
    device=None,
) -> TrainResult:
    """Run ``rounds`` rounds on ``device`` (``cuda`` unless given; a cohort
    engine's bank must live there).  ``init_params`` is a flat dict of
    tensors on that device; it is copied, not consumed."""
    device = resolve_device(device)
    if schedule not in SCHEDULES:
        raise NotImplementedError(f"schedule {schedule!r} is not ported yet; have {sorted(SCHEDULES)}")
    sched = SCHEDULES[schedule]
    strat = bind_strategy(strategy, fl, loss_fn, num_clients=fl.num_clients)
    state = strat.init(init_params)

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

    ml = MetricLogger(name=name)
    t0 = time.time()

    def round_iter():
        if engine is None:
            for r in range(rounds):
                yield r, pipeline.round_batch(r)
        else:
            with engine.round_plans(rounds) as it:
                yield from it

    for r, batch in round_iter():
        state, mets = step(state, batch, sched(r, rounds))
        row = {"round": r, "lr_mult": sched(r, rounds),
               **{k: float(v) for k, v in mets.items()}}
        if eval_fn is not None and (r % eval_every == 0 or r == rounds - 1):
            row.update({f"eval_{k}": float(v) for k, v in eval_fn(state.params).items()})
        row["elapsed_s"] = time.time() - t0
        ml.append(**row)
        if log_every and (r % log_every == 0 or r == rounds - 1):
            log(f"[{name}] round {r}/{rounds}",
                **{k: f"{v:.5f}" if isinstance(v, float) else v
                   for k, v in row.items() if k != "round"})
    return TrainResult(state=state, metrics=ml)
