"""Host plan -> device plan conversion (the meta-transfer path).

Shares ``fed.rounds.as_device_meta`` (meta floats -> float32, ids -> int64)
so a round step fed a materialized plan is bitwise-identical to one fed a
host-assembled RoundBatch.  A ``BucketedPlan`` moves its buckets' occupied
rows only (``fed.rounds.as_device_buckets``).
"""
from __future__ import annotations

import torch

from ...data.federated import BucketedPlan, IndexPlan
from ..rounds import as_device_buckets, as_device_meta, to_device


def as_device_plan(plan: "IndexPlan | BucketedPlan", device) -> "IndexPlan | BucketedPlan":
    """A host plan's arrays as tensors on ``device`` (the round stays an int;
    a bucketed plan's re-based ``pos`` stays on the host)."""
    meta = as_device_meta(plan.meta, device)
    sizes = to_device(plan.sizes, device, torch.int32)
    spe = to_device(plan.spe, device, torch.int32)
    if isinstance(plan, BucketedPlan):
        buckets, pos = as_device_buckets(plan.buckets, plan.pos, device)
        return BucketedPlan(buckets=buckets, meta=meta, pos=pos, sizes=sizes, spe=spe,
                            rnd=int(plan.rnd))
    return IndexPlan(
        idx=None if plan.idx is None else to_device(plan.idx, device, torch.int32),
        step_mask=to_device(plan.step_mask, device, torch.float32),
        meta=meta, sizes=sizes, spe=spe, rnd=int(plan.rnd))
