"""Host IndexPlan -> device IndexPlan conversion (the meta-transfer path).

Shares ``fed.rounds.as_device_meta`` (meta floats -> float32, ids -> int64)
so a round step fed a materialized plan is bitwise-identical to one fed a
host-assembled RoundBatch.
"""
from __future__ import annotations

import torch

from ...data.federated import IndexPlan
from ..rounds import as_device_meta, to_device


def as_device_plan(plan: IndexPlan, device) -> IndexPlan:
    """A host plan's arrays as tensors on ``device`` (the round stays an int)."""
    return IndexPlan(
        idx=None if plan.idx is None else to_device(plan.idx, device, torch.int32),
        step_mask=to_device(plan.step_mask, device, torch.float32),
        meta=as_device_meta(plan.meta, device),
        sizes=to_device(plan.sizes, device, torch.int32),
        spe=to_device(plan.spe, device, torch.int32),
        rnd=int(plan.rnd),
    )
