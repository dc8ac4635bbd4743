"""``--arch <id>`` registry: the architectures the port runs.

The JAX package's registry (``repro.configs.registry``) holds every
assigned architecture; the port holds those it implements (the paper's
three task configs ``charlm-tiny``, ``vision-tiny`` and ``charlm-100m``,
and every assigned architecture but the moe family's: ``hymba-1.5b``,
``qwen1.5-0.5b``, ``seamless-m4t-medium``, ``llava-next-mistral-7b``,
``mamba2-1.3b``, ``minicpm-2b``, ``chatglm3-6b`` and ``qwen2-72b``).  The
two deepseek architectures raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

from . import (
    chatglm3_6b,
    hymba_1_5b,
    llava_next_mistral_7b,
    mamba2_1_3b,
    minicpm_2b,
    qwen1_5_0_5b,
    qwen2_72b,
    seamless_m4t_medium,
)
from .base import ArchConfig
from .paper_tasks import PAPER_ARCHS

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (hymba_1_5b, qwen1_5_0_5b, seamless_m4t_medium, llava_next_mistral_7b,
              mamba2_1_3b, minicpm_2b, chatglm3_6b, qwen2_72b)}
ARCHS.update(PAPER_ARCHS)

_ZOO = "ROADMAP 'Modules to port', item 10 (the rest of the model zoo)"
NOT_PORTED: dict[str, str] = {
    "deepseek-v3-671b": _ZOO + ": MLA and the moe family",
    "deepseek-v2-lite-16b": _ZOO + ": MLA and the moe family",
}


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet ({NOT_PORTED[name]})")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
