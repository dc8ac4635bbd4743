"""FedShuffleGen (Algorithm 4) and its special cases, over torch tensors.

FedShuffleGen is parametrized by
  * ``c_i``     — local step-size normalization (client i steps with eta_l/c_i),
  * ``w~_i``    — aggregation weight,
  * ``q_i^S``   — aggregation normalization (possibly cohort-dependent).

The server applies  ``x <- x + eta_g * sum_{i in S} (w~_i / q_i^S) Delta_i``
with ``Delta_i = y_i - x`` (the descent form the paper's proofs use).

Special cases (App. E.2):

| algorithm    | c_i            | w~_i                | q_i^S                  |
|--------------|----------------|---------------------|------------------------|
| fedshuffle   | K_i (steps)    | w_i                 | p_i                    |
| fedavg       | 1              | w_i                 | p_i  (unbiased agg)    |
| fedavg_so    | 1              | w_i                 | (b/n)*sum_{j in S} w_j |
| fednova      | 1              | w_i * tau_eff / K_i | p_i                    |
| fedavg_min   | 1 (+equalized K via pipeline)   | w_i | p_i            |
| fedavg_mean  | 1 (+equalized K via pipeline)   | w_i | p_i            |
| gen (hybrid) | K_i^planned    | w_i * K_i^planned / K_i^actual | p_i     |

Each of the three choices is a registered primitive (``C_KINDS`` /
``W_KINDS`` / ``Q_KINDS``) over the [C] float32 tensors of a device
``ClientMeta``; a ``GenSpec`` names one primitive per slot, and
``register_c_kind`` / ``register_w_kind`` / ``register_q_kind`` add more.
The port's counterpart of ``repro.core.algorithms``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class GenSpec:
    """The (c, w~, q) parametrization of FedShuffleGen."""

    c: str = "steps"
    w: str = "w"
    q: str = "p"


# c-kind: (steps, planned) -> 1/c_i.  "steps" also uses the *planned* step
# count: a client fixes its step size before training (it cannot know it will
# be interrupted), which is why the "gen" hybrid adds update rescaling.
C_KINDS: dict[str, Callable] = {
    "one": lambda steps, planned: torch.ones_like(steps),
    "steps": lambda steps, planned: 1.0 / planned,
    "steps_planned": lambda steps, planned: 1.0 / planned,
}

# w-kind: (meta, steps, planned) -> w~_i
W_KINDS: dict[str, Callable] = {
    "w": lambda meta, steps, planned: meta.weight,
    # tau_eff from the cohort, debiased by p (exact for full participation)
    "nova": lambda meta, steps, planned: meta.weight * torch.sum(
        meta.valid * (meta.weight / meta.prob) * steps) / steps,
    "nova_actual": lambda meta, steps, planned: meta.weight * planned / steps,
}


def _q_sum_one(meta, num_clients, cohort_size):
    # Algorithm 2 line 15: Delta = (n/b) * (1/sum_{j in S} w_j) * sum w_i Delta_i
    q = torch.sum(meta.valid * meta.weight) * (cohort_size / num_clients)
    return torch.clamp_min(q, 1e-12)


# q-kind: (meta, num_clients, cohort_size) -> q_i^S
Q_KINDS: dict[str, Callable] = {
    "p": lambda meta, num_clients, cohort_size: meta.prob,
    "sum_one": _q_sum_one,
}

def _register(registry: dict, slot: str, name: str, fn: Callable,
              overwrite: bool = False) -> None:
    if not overwrite and name in registry:
        raise ValueError(
            f"{slot}-kind {name!r} already registered (pass overwrite=True to replace)")
    registry[name] = fn


def register_c_kind(name: str, fn: Callable, *, overwrite: bool = False) -> None:
    """fn(steps, planned) -> 1/c_i ([C])."""
    _register(C_KINDS, "c", name, fn, overwrite)


def register_w_kind(name: str, fn: Callable, *, overwrite: bool = False) -> None:
    """fn(meta, steps, planned) -> w~_i ([C])."""
    _register(W_KINDS, "w", name, fn, overwrite)


def register_q_kind(name: str, fn: Callable, *, overwrite: bool = False) -> None:
    """fn(meta, num_clients, cohort_size) -> q_i^S ([C] or 0-d)."""
    _register(Q_KINDS, "q", name, fn, overwrite)


PRESETS: dict[str, GenSpec] = {
    "fedshuffle": GenSpec(c="steps", w="w", q="p"),
    "fedavg": GenSpec(c="one", w="w", q="p"),
    "fedavg_so": GenSpec(c="one", w="w", q="sum_one"),
    "fedshuffle_so": GenSpec(c="steps", w="w", q="sum_one"),  # Fig.1 panel 3 ablation
    "fednova": GenSpec(c="one", w="nova", q="p"),
    "fedavg_min": GenSpec(c="one", w="w", q="p"),
    "fedavg_mean": GenSpec(c="one", w="w", q="p"),
    "gen": GenSpec(c="steps_planned", w="nova_actual", q="p"),
}


def spec_for(algorithm: str) -> GenSpec:
    if algorithm not in PRESETS:
        raise KeyError(f"unknown algorithm {algorithm!r}; have {sorted(PRESETS)}")
    return PRESETS[algorithm]


def _steps(meta):
    return torch.clamp_min(meta.num_steps, 1.0), torch.clamp_min(meta.num_steps_planned, 1.0)


def lr_scale(spec: GenSpec, meta) -> torch.Tensor:
    """Per-client 1/c_i ([C])."""
    if spec.c not in C_KINDS:
        raise ValueError(spec.c)
    return C_KINDS[spec.c](*_steps(meta))


def agg_coeff(spec: GenSpec, meta, *, num_clients: int, cohort_size: int) -> torch.Tensor:
    """Per-client aggregation coefficient w~_i / q_i^S * valid_i ([C])."""
    if spec.w not in W_KINDS:
        raise ValueError(spec.w)
    if spec.q not in Q_KINDS:
        raise ValueError(spec.q)
    steps, planned = _steps(meta)
    wt = W_KINDS[spec.w](meta, steps, planned)
    q = Q_KINDS[spec.q](meta, num_clients, cohort_size)
    return meta.valid * wt / q
