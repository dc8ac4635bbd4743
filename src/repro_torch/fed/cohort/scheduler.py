"""Participation schedules: who trains in round r, and with what p_i.

The port's copy of ``repro.fed.cohort.scheduler`` with its ``iid`` schedule:
the paper's *proper samplings* (full / uniform / independent importance
sampling, §3), i.i.d. across rounds and seeded exactly like the JAX
package.  When independent sampling realizes more clients than the padded
slot count, the overflow is dropped uniformly at random and a warning
records the event.  The regularized schedules (``uniform_floyd``,
``cyclic``, ``cyclic_shuffled``) are not ported yet.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np

from ...configs.base import FLConfig
from ...core.sampling import probs as sampling_probs
from ...data.federated import Population


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


PARTICIPATION = {"iid": _iid}


def sample_round(fl: FLConfig, population: Population, rnd: int, *,
                 slots: int, probs: np.ndarray | None = None) -> CohortSample:
    """Realize round ``rnd``'s cohort under the configured schedule."""
    if fl.participation not in PARTICIPATION:
        raise NotImplementedError(
            f"participation schedule {fl.participation!r} is not ported yet; "
            f"have {sorted(PARTICIPATION)}")
    return PARTICIPATION[fl.participation](fl, population, rnd, slots, probs)
