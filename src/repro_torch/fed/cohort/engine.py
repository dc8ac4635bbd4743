"""CohortEngine: the population-scale round producer.

Owns everything between "population" and "round step":

* a :class:`~repro_torch.fed.cohort.plane.DevicePlane` (task uploaded once,
  rounds gathered on the device),
* index-plan assembly (reusing the legacy pipeline's host logic, so the host
  RR backend is bitwise-identical to ``FederatedPipeline.round_batch``),
* the RR backend choice (host PCG / host feistel / device plain torch /
  device CUDA kernel),
* async round prefetch (:class:`~repro_torch.fed.cohort.prefetch.RoundPrefetcher`).

Per-round host work is O(cohort) scalars + the [C, K_max] mask (plus the
[C, K_max, B] int32 indices for host backends).  Typical use::

    engine = CohortEngine.build(task, population, fl)
    step = build_round_step(loss_fn, strategy, fl, plane=engine.plane)
    with engine.round_plans(rounds) as it:
        for r, plan in it:
            state, metrics = step(state, plan)

On a card the producer thread copies each plan to the card on the default
stream, the stream the round step runs on, so the round that reads a plan
is ordered after its copy.  The copy waits behind the round in flight;
the host plan is a millisecond of a round of a second or more (PERF.md,
the train-loop row), so there is nothing a stream of its own would hide.
The port's counterpart of ``repro.fed.cohort.engine``.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ...configs.base import FLConfig
from ...data.federated import BucketedPlan, FederatedPipeline, IndexPlan, Population
from ...kernels.rr_perm.ref import rr_indices, stream_key
from ...utils.device import resolve_device
from .plan import as_device_plan
from .plane import DevicePlane, build_plane
from .prefetch import RoundPrefetcher

HOST_BACKENDS = ("host", "host_feistel")
DEVICE_BACKENDS = ("device_ref", "device")
BACKENDS = HOST_BACKENDS + DEVICE_BACKENDS


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown rr_backend {backend!r}; have {BACKENDS}")
    return backend


@dataclass
class CohortEngine:
    pipeline: FederatedPipeline     # host index-plan assembly (legacy logic)
    plane: DevicePlane
    rr_backend: str = "host"

    @classmethod
    def build(cls, task: Any, population: Population, fl: FLConfig, *,
              rr_backend: str | None = None, device=None) -> "CohortEngine":
        """The engine with its bank on ``device`` (``cuda`` unless given)."""
        return cls.from_pipeline(FederatedPipeline(task, population, fl),
                                 rr_backend=rr_backend, device=device)

    @classmethod
    def from_pipeline(cls, pipeline: FederatedPipeline, *,
                      rr_backend: str | None = None, device=None) -> "CohortEngine":
        backend = _check_backend(rr_backend or pipeline.fl.rr_backend)
        plane = build_plane(pipeline.task, pipeline.population, pipeline.fl,
                            device=resolve_device(device), rr_backend=backend)
        return cls(pipeline=pipeline, plane=plane, rr_backend=backend)

    @property
    def fl(self) -> FLConfig:
        return self.pipeline.fl

    @property
    def device(self):
        return self.plane.device

    @property
    def k_max(self) -> int:
        return self.pipeline.k_max

    @property
    def fleet(self):
        """The pipeline's :class:`~repro_torch.fed.fleet.model.FleetModel`
        (None when the fleet plane is off).  Fleet math lives entirely in
        the pipeline's index-plan assembly (sync fault passes, the buffered
        virtual-clock schedule), so the engine's plans carry the fleet meta
        fields with no engine-side changes."""
        return self.pipeline.fleet

    def index_plan(self, rnd: int) -> "IndexPlan | BucketedPlan":
        """One round's host plan under the configured RR backend (bucketized
        when ``fl.exec_mode == "bucketed"``; a bucket-overflow round falls
        back to the padded IndexPlan with a warning, results unchanged)."""
        plan = self._padded_index_plan(rnd)
        if self.fl.exec_mode == "bucketed":
            return self.pipeline.bucketize(plan)
        return plan

    def _padded_index_plan(self, rnd: int) -> IndexPlan:
        if self.rr_backend == "host":
            return self.pipeline.index_plan(rnd, with_idx=True)
        plan = self.pipeline.index_plan(rnd, with_idx=False)
        if self.rr_backend == "host_feistel":
            # numpy mirror of exactly what the device backends compute —
            # including the plane's rr/wr mode choice
            prekey = stream_key(self.fl.seed, plan.meta.client_id.astype(np.uint32),
                                np.uint32(rnd & 0xFFFFFFFF))
            idx = rr_indices(prekey, plan.sizes, plan.spe, self.fl.local_batch,
                             self.k_max, rounds=self.fl.rr_rounds, mode=self.plane.mode)
            return plan._replace(idx=idx)
        return plan  # device backends: the round step regenerates the streams

    def device_plan(self, rnd: int) -> "IndexPlan | BucketedPlan":
        return as_device_plan(self.index_plan(rnd), self.device)

    @contextmanager
    def round_plans(self, rounds: int, *, prefetch: int | None = None, start: int = 0):
        """Iterate ``(rnd, device_plan)`` for rounds ``start .. start+rounds``
        with async prefetch (depth from ``fl.prefetch``; 0 runs no thread)."""
        depth = self.fl.prefetch if prefetch is None else prefetch
        if depth <= 0:
            yield ((r, self.device_plan(r)) for r in range(start, start + rounds))
            return
        # the producer thread has a current device of its own: name the card
        device = self.device
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with RoundPrefetcher(lambda r: as_device_plan(self.index_plan(r), device), rounds,
                             depth=depth, start=start) as pf:
            yield iter(pf)
