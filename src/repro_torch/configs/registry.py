"""``--arch <id>`` registry: the architectures the port runs.

The JAX package's registry (``repro.configs.registry``) holds every
assigned architecture; the port holds those it implements (the paper's
three task configs ``charlm-tiny``, ``vision-tiny`` and ``charlm-100m``,
``hymba-1.5b``, ``qwen1.5-0.5b``, ``seamless-m4t-medium`` and
``llava-next-mistral-7b``).  Any other architecture of the JAX registry
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

from . import hymba_1_5b, llava_next_mistral_7b, qwen1_5_0_5b, seamless_m4t_medium
from .base import ArchConfig
from .paper_tasks import PAPER_ARCHS

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (hymba_1_5b, qwen1_5_0_5b, seamless_m4t_medium, llava_next_mistral_7b)}
ARCHS.update(PAPER_ARCHS)

_ZOO = "ROADMAP 'Modules to port', item 10 (the rest of the model zoo)"
NOT_PORTED: dict[str, str] = {
    "qwen2-72b": _ZOO + ": the dense archs",
    "chatglm3-6b": _ZOO + ": the 'half' RoPE serving path",
    "deepseek-v3-671b": _ZOO + ": MLA and the moe family",
    "mamba2-1.3b": _ZOO + ": the ssm family's blocks",
    "deepseek-v2-lite-16b": _ZOO + ": MLA and the moe family",
    "minicpm-2b": _ZOO + ": the dense archs",
}


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet ({NOT_PORTED[name]})")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
