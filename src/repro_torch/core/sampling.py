"""Proper client samplings (paper §3) and their theory constants (numpy;
the port's copy of ``repro.core.sampling``).

A *sampling* S is a random subset of [n] with inclusion probabilities
``p_i = Pr[i in S] > 0``.  The convergence rates depend on ``s_i`` with
``P - p p^T <= Diag(p_1 s_1, ..., p_n s_n)`` and on ``M = max_i s_i w_i / p_i``.

Closed forms implemented (Horváth & Richtárik 2019):
  * full participation:     p_i = 1,       s_i = 0
  * uniform b-of-n (w/o rep.): p_i = b/n,  s_i = (n-b)/(n-1)
  * independent (importance):  p_i = min(1, b*w_i), s_i = 1 - p_i
"""
from __future__ import annotations

import numpy as np


def probs(kind: str, n: int, b: int, weights: np.ndarray | None = None) -> np.ndarray:
    if kind == "full":
        return np.ones(n)
    if kind == "uniform":
        return np.full(n, b / n)
    if kind == "independent":
        assert weights is not None
        return np.minimum(1.0, b * np.asarray(weights))
    raise ValueError(kind)


def s_vector(kind: str, n: int, b: int, weights: np.ndarray | None = None) -> np.ndarray:
    if kind == "full":
        return np.zeros(n)
    if kind == "uniform":
        return np.full(n, (n - b) / max(1, n - 1))
    if kind == "independent":
        return 1.0 - probs(kind, n, b, weights)
    raise ValueError(kind)


def M_term(kind: str, n: int, b: int, weights: np.ndarray) -> float:
    """M = max_i s_i w_i / p_i — the partial-participation constant in Thm 5.1.

    Importance sampling (p_i ∝ w_i) minimizes this, giving the paper's linear
    cohort-size speedup M = (1 - min w_i)/b."""
    p = probs(kind, n, b, weights)
    s = s_vector(kind, n, b, weights)
    return float(np.max(s * np.asarray(weights) / p))


def expected_cohort(kind: str, n: int, b: int, weights: np.ndarray | None = None) -> float:
    return float(np.sum(probs(kind, n, b, weights)))
