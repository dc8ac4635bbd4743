"""``--arch <id>`` registry: the architectures the port runs.

Every assigned architecture of the JAX package's registry
(``repro.configs.registry``): ``hymba-1.5b``, ``qwen1.5-0.5b``,
``seamless-m4t-medium``, ``llava-next-mistral-7b``, ``mamba2-1.3b``,
``minicpm-2b``, ``chatglm3-6b``, ``qwen2-72b``, ``deepseek-v2-lite-16b``
and ``deepseek-v3-671b``, and the paper's three task configs
``charlm-tiny``, ``vision-tiny`` and ``charlm-100m``; ``ASSIGNED``, the
ten assigned ones in the JAX package's order; and the assigned input
shapes by name (``get_shape``).
"""
from __future__ import annotations

from . import (
    chatglm3_6b,
    deepseek_v2_lite_16b,
    deepseek_v3_671b,
    hymba_1_5b,
    llava_next_mistral_7b,
    mamba2_1_3b,
    minicpm_2b,
    qwen1_5_0_5b,
    qwen2_72b,
    seamless_m4t_medium,
)
from .base import INPUT_SHAPES, ArchConfig, ShapeConfig
from .paper_tasks import PAPER_ARCHS

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (hymba_1_5b, qwen1_5_0_5b, seamless_m4t_medium, llava_next_mistral_7b,
              mamba2_1_3b, minicpm_2b, chatglm3_6b, qwen2_72b, deepseek_v2_lite_16b,
              deepseek_v3_671b)}
ARCHS.update(PAPER_ARCHS)

# the assigned architectures, in the JAX package's order (the dry run's --all)
ASSIGNED = [
    "qwen2-72b",
    "chatglm3-6b",
    "hymba-1.5b",
    "seamless-m4t-medium",
    "llava-next-mistral-7b",
    "deepseek-v3-671b",
    "mamba2-1.3b",
    "deepseek-v2-lite-16b",
    "minicpm-2b",
    "qwen1.5-0.5b",
]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]
