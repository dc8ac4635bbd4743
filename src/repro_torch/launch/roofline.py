"""Parameter and token counts of an architecture and an input shape (the
port's ``param_counts`` and ``tokens_for`` of ``repro.launch.roofline``).

``param_counts`` builds the params of the full-size config on the meta
device (shapes alone, no allocation); its active count takes the routed
experts (every leaf under ``/experts/``) at ``top_k / num_experts``, the
JAX package's rule.  The rest of the JAX module reads the dry-run
artifacts of a TPU mesh lowering, which the port does not make.
"""
from __future__ import annotations

import functools

from ..configs.base import INPUT_SHAPES
from ..configs.registry import get_arch


@functools.cache
def param_counts(arch_name: str) -> tuple[int, int]:
    """(total, active) parameter counts of ``arch_name`` at full size."""
    from ..models.model import build_model

    cfg = get_arch(arch_name)
    shapes = build_model(cfg).init(0, "meta")
    total = sum(v.numel() for v in shapes.values())
    active = total
    if cfg.moe is not None:
        expert = sum(v.numel() for k, v in shapes.items() if "/experts/" in k)
        active = total - expert + int(expert * cfg.moe.top_k / cfg.moe.num_experts)
    return total, active


def tokens_for(shape_name: str) -> int:
    """Tokens a lowered step of ``shape_name`` processes: batch x sequence
    for a train or prefill shape, one a sequence for a decode shape."""
    s = INPUT_SHAPES[shape_name]
    if s.kind in ("train", "prefill"):
        return s.global_batch * s.seq_len
    return s.global_batch
