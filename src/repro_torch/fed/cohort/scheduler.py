"""Participation schedules: who trains in round r, and with what p_i.

The port's copy of ``repro.fed.cohort.scheduler``, seeded exactly like the
JAX package.  The paper's *proper samplings* (full / uniform / independent
importance sampling, §3) are i.i.d. across rounds: the ``iid`` schedule.
When independent sampling realizes more clients than the padded slot
count, the overflow is dropped uniformly at random and a warning records
the event.

Regularized participation (Malinovsky et al. 2023) structures WHO
participates across a period so every client trains exactly once a period;
these schedules are deterministic given the round index and O(cohort) a
round:

* ``uniform_floyd`` — uniform b-of-n via Floyd's algorithm, O(b);
* ``cyclic`` — a fixed partition into ceil(n/b) groups, visited round-robin;
* ``cyclic_shuffled`` — the same, with the partition re-drawn every period
  by pushing the b slot positions through the stateless swap-or-not
  permutation of [0, n) (the numpy mirror in ``kernels.rr_perm.ref``).

Schedules are pluggable: ``register_participation(name, fn)`` with
``fn(fl, population, rnd, slots, probs) -> CohortSample``.  Deterministic
schedules report ``p_i = 1``.
"""
from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import numpy as np

from ...configs.base import FLConfig
from ...core.sampling import probs as sampling_probs
from ...data.federated import Population
from ...kernels.rr_perm.ref import key_combine, stream_key, swap_or_not


def _rng(*keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(entropy=[int(k) & 0xFFFFFFFF for k in keys]))


class CohortSample(NamedTuple):
    ids: np.ndarray      # realized cohort (client ids, <= slots of them)
    probs: np.ndarray    # inclusion probability per realized id


def _iid(fl: FLConfig, population: Population, rnd: int, slots: int,
         probs: np.ndarray | None) -> CohortSample:
    """The paper's proper samplings — seeded exactly like the legacy path."""
    n = population.num_clients
    if probs is None:
        probs = sampling_probs(fl.sampling, n, fl.cohort_size, population.weights)
    r = _rng(fl.seed, 0xC0407, rnd)
    if fl.sampling == "full":
        return CohortSample(np.arange(n), np.ones(n))
    if fl.sampling == "uniform":
        ids = r.choice(n, size=fl.cohort_size, replace=False)
        return CohortSample(ids, probs[ids])
    mask = r.random(n) < probs
    ids = np.nonzero(mask)[0]
    if len(ids) == 0:  # proper sampling a.s. nonempty in expectation; resample guard
        ids = np.array([int(r.integers(0, n))])
    if len(ids) > slots:
        drop = len(ids) - slots
        warnings.warn(
            f"independent sampling realized {len(ids)} clients for {slots} "
            f"cohort slots (round {rnd}); dropping {drop} uniformly at random."
            f" This round's cohort is a subsample — the w~/q estimator loses "
            f"exactness; raise the slot bound if it recurs.",
            RuntimeWarning, stacklevel=2,
        )
        keep = np.sort(r.choice(len(ids), size=slots, replace=False))
        ids = ids[keep]
    return CohortSample(ids, probs[ids])


def _uniform_floyd(fl: FLConfig, population: Population, rnd: int, slots: int,
                   probs: np.ndarray | None) -> CohortSample:
    """Uniform b-of-n without replacement in O(b) (Floyd's algorithm)."""
    n, b = population.num_clients, min(fl.cohort_size, population.num_clients)
    r = _rng(fl.seed, 0xF10D, rnd)
    chosen: set[int] = set()
    out = []
    for j in range(n - b, n):
        t = int(r.integers(0, j + 1))
        if t in chosen:
            t = j
        chosen.add(t)
        out.append(t)
    ids = np.array(sorted(out), dtype=np.int64)
    return CohortSample(ids, np.full(len(ids), b / n))


def _cyclic_ids(fl: FLConfig, population: Population, rnd: int, shuffled: bool) -> np.ndarray:
    n, b = population.num_clients, min(fl.cohort_size, population.num_clients)
    period = -(-n // b)
    pos = (rnd % period) * b + np.arange(b, dtype=np.int64)
    pos = pos[pos < n]
    if not shuffled:
        return pos
    # period-keyed stateless permutation of [0, n): position -> client id,
    # the cipher evaluated at the cohort's positions only
    key = key_combine(stream_key(fl.seed, np.uint32(0xCE11), np.uint32(rnd // period)),
                      np.uint32(0x5C11ED))
    ids = swap_or_not(pos.astype(np.uint32), np.uint32(n), key, fl.rr_rounds)
    return np.sort(ids.astype(np.int64))


def _cyclic(fl, population, rnd, slots, probs) -> CohortSample:
    ids = _cyclic_ids(fl, population, rnd, shuffled=False)
    return CohortSample(ids, np.ones(len(ids)))


def _cyclic_shuffled(fl, population, rnd, slots, probs) -> CohortSample:
    ids = _cyclic_ids(fl, population, rnd, shuffled=True)
    return CohortSample(ids, np.ones(len(ids)))


PARTICIPATION: dict[str, Callable] = {
    "iid": _iid,
    "uniform_floyd": _uniform_floyd,
    "cyclic": _cyclic,
    "cyclic_shuffled": _cyclic_shuffled,
}


def register_participation(name: str, fn: Callable, *, overwrite: bool = False) -> None:
    """fn(fl, population, rnd, slots, probs) -> CohortSample."""
    if not overwrite and name in PARTICIPATION:
        raise ValueError(
            f"participation schedule {name!r} already registered (pass overwrite=True to replace)")
    PARTICIPATION[name] = fn


def sample_round(fl: FLConfig, population: Population, rnd: int, *,
                 slots: int, probs: np.ndarray | None = None) -> CohortSample:
    """Realize round ``rnd``'s cohort under the configured schedule."""
    schedule = fl.participation
    if schedule not in PARTICIPATION:
        raise ValueError(
            f"unknown participation schedule {schedule!r}; have {sorted(PARTICIPATION)}")
    sample = PARTICIPATION[schedule](fl, population, rnd, slots, probs)
    if len(sample.ids) > slots:
        raise ValueError(
            f"schedule {schedule!r} realized {len(sample.ids)} clients for {slots} slots")
    return sample
