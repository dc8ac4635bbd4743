"""Host-side RDP/moments accountant for DP-FedShuffle.

Tracks cumulative ``(eps, delta)`` privacy loss of the server's Gaussian
mechanism under client-subsampling amplification.  Per round the mechanism
is a subsampled Gaussian with noise multiplier ``z = fl.dp_noise_mult``
(``fed/privacy/dp.py`` scales sigma by the exact weighted-sum sensitivity, so
``z`` is the ratio that matters) at the participation schedule's sampling
rate ``q`` (``cohort_size / num_clients``; 1 for full participation).

Renyi-DP bound (Mironov 2017; Mironov-Talwar-Zhang 2019, integer orders):

    RDP(alpha) = 1/(alpha-1) * log( sum_{k=0..alpha} C(alpha, k)
                 * (1-q)^(alpha-k) * q^k * exp(k(k-1) / (2 z^2)) )

composed linearly over rounds, then converted with the classic bound

    eps(delta) = min_alpha [ rounds * RDP(alpha) + log(1/delta)/(alpha-1) ].

Everything is computed in log space (``math.lgamma`` + logsumexp — plain
numpy, no scipy), so small ``z`` / large alpha never overflow.  The
amplification lemma assumes Poisson sampling; the repo's uniform
fixed-cohort schedules are accounted at the same rate — the standard
approximation, stated in the README.

Determinism contract: cumulative epsilon is a *pure function* of
``(noise_mult, sampling_rate, delta, rounds)`` — no accumulator state — so
a run resumed from a checkpoint (which restores the round counter) reports
bitwise-identical epsilon at every subsequent round.  The checkpoint
sidecar carries a ``dp_accounting`` record (:func:`dp_checkpoint_record`)
and :func:`check_dp_resume` refuses resumes that silently change the
mechanism the spent budget was accounted under.

The port's copy of ``repro.fed.privacy.accountant`` (pure ``math`` and
numpy): the same arithmetic in the same order, so epsilon is bitwise the
JAX package's.
"""
from __future__ import annotations

import math

import numpy as np

# integer Renyi orders: dense where the minimum usually lands, sparse tail
# for tiny q / huge round counts
DEFAULT_ORDERS: tuple[int, ...] = tuple(range(2, 65)) + (80, 96, 128, 192, 256, 512)


def _logsumexp(terms) -> float:
    m = max(terms)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(t - m) for t in terms))


def _log_comb(a: int, k: int) -> float:
    return (math.lgamma(a + 1) - math.lgamma(k + 1) - math.lgamma(a - k + 1))


def rdp_subsampled_gaussian(q: float, noise_mult: float, orders) -> np.ndarray:
    """Per-round RDP at each integer order (the Mironov binomial bound)."""
    z2 = 2.0 * noise_mult * noise_mult
    out = np.zeros(len(orders), dtype=np.float64)
    for i, a in enumerate(orders):
        a = int(a)
        if a < 2:
            raise ValueError(f"RDP orders must be integers >= 2, got {a}")
        if q >= 1.0:
            out[i] = a / z2                      # plain Gaussian mechanism
            continue
        lq, l1q = math.log(q), math.log1p(-q)
        terms = [_log_comb(a, k) + k * lq + (a - k) * l1q + k * (k - 1) / z2
                 for k in range(a + 1)]
        out[i] = _logsumexp(terms) / (a - 1)
    return out


class RDPAccountant:
    """Stateless cumulative-epsilon tracker (see module docstring)."""

    def __init__(self, *, noise_mult: float, sampling_rate: float,
                 delta: float, orders=DEFAULT_ORDERS):
        if not noise_mult > 0:
            raise ValueError(f"accountant needs noise_mult > 0, got {noise_mult!r}")
        if not 0 < sampling_rate <= 1:
            raise ValueError(
                f"accountant needs sampling rate in (0, 1], got {sampling_rate!r}")
        if not 0 < delta < 1:
            raise ValueError(f"accountant needs delta in (0, 1), got {delta!r}")
        self.noise_mult = float(noise_mult)
        self.sampling_rate = float(sampling_rate)
        self.delta = float(delta)
        self.orders = tuple(int(a) for a in orders)
        self._rdp_per_round = rdp_subsampled_gaussian(
            self.sampling_rate, self.noise_mult, self.orders)

    def epsilon(self, rounds: int) -> float:
        """Cumulative eps(delta) after ``rounds`` completed rounds."""
        if rounds <= 0:
            return 0.0
        orders = np.asarray(self.orders, dtype=np.float64)
        eps = (rounds * self._rdp_per_round
               + math.log(1.0 / self.delta) / (orders - 1.0))
        return float(eps.min())


def sampling_rate(fl) -> float:
    """The participation schedule's per-round client sampling rate."""
    if fl.sampling == "full":
        return 1.0
    return min(1.0, fl.cohort_size / max(1, fl.num_clients))


def accountant_for(fl) -> RDPAccountant:
    """The accountant matching ``fl``'s bound DP mechanism."""
    return RDPAccountant(noise_mult=fl.dp_noise_mult,
                         sampling_rate=sampling_rate(fl), delta=fl.dp_delta)


# ---------------------------------------------------------------------------
# checkpoint persistence — the sidecar record that makes resumed epsilon
# auditable and mechanism drift a hard error
# ---------------------------------------------------------------------------

def dp_checkpoint_record(fl, rounds: int) -> dict:
    """The ``dp_accounting`` block persisted in checkpoint metadata."""
    acct = accountant_for(fl)
    return {
        "noise_mult": float(fl.dp_noise_mult),
        "clip": float(fl.dp_clip),
        "delta": float(fl.dp_delta),
        "sampling_rate": acct.sampling_rate,
        "rounds": int(rounds),
        "epsilon": acct.epsilon(int(rounds)),
    }


def check_dp_resume(record: dict | None, fl) -> None:
    """Refuse resuming a DP run under a different mechanism than the one the
    checkpointed budget was accounted for (eps would silently lie)."""
    if record is None:
        raise ValueError(
            "checkpoint has no dp_accounting record but fl.dp='on' — the "
            "saved budget cannot be attributed to this mechanism; save with "
            "fl= (or metadata=dp_checkpoint_record(...)) when dp is on")
    want = {"noise_mult": float(fl.dp_noise_mult), "clip": float(fl.dp_clip),
            "delta": float(fl.dp_delta), "sampling_rate": sampling_rate(fl)}
    for key, val in want.items():
        got = record.get(key)
        if got is None or abs(float(got) - val) > 1e-12 * max(1.0, abs(val)):
            raise ValueError(
                f"DP resume mismatch: checkpoint accounted {key}={got!r} but "
                f"fl binds {key}={val!r} — changing the mechanism mid-run "
                f"invalidates the cumulative epsilon; keep the knobs fixed "
                f"or start a fresh accounting history")
