"""Central registry of counter-based RNG stream tags (the port's own copy).

Every source of randomness in the system is a *counter-based* stream: a
deterministic integer hash chain (``repro_torch.kernels.rr_perm.ref``:
``fmix32`` / ``key_combine`` / ``stream_key``) keyed on ``(seed, client,
round, ...)`` plus a **domain tag** that separates subsystems and, within a
domain, a **subtag** that separates independent draws.  Nothing is stateful,
so the legacy loop, the cohort engine and a resumed run all regenerate
bitwise-identical streams.  The values equal the JAX package's
(``repro.utils.tags``), so both packages draw the same streams.

Adding a stream
---------------
1. add the domain tag to :data:`DOMAIN_TAGS` (or a subtag to
   :data:`SUBTAGS` under its domain),
2. derive keys as ``key_combine(stream_key(seed, client, rnd), TAG)`` then
   ``key_combine(..., SUBTAG)`` — never fold raw tag arithmetic yourself,
3. add it to the JAX package's registry too: the port's tests hold the
   two registries equal.

Values are arbitrary but must be unique within their table and fit uint32.
"""
from __future__ import annotations

# ---------------------------------------------------------------------------
# Domain tags: one per subsystem drawing from the hash chain.
# ---------------------------------------------------------------------------

#: Random-reshuffling permutations (swap-or-not cipher; kernels/rr_perm and
#: the host mirror in data/reshuffle.py).  This is the *base* domain: the
#: rr_perm ``stream_key`` folds it in before any other domain's tag, so every
#: other domain is a tagged branch off the RR chain.
TAG_RR = 0xA11CE

#: With-replacement baseline sampling streams (data/reshuffle.py host path).
TAG_WR = 0xB0B

#: Uplink codec randomness — stochastic rounding, rand-k slot choice
#: (fed/comm/codecs.py ``round_keys``).
TAG_COMM = 0x0C0DEC

#: Heterogeneous-fleet device model — tier assignment, latency, dropout,
#: straggler draws (fed/fleet/model.py).
TAG_FLEET = 0xF1EE7

#: Byzantine-robustness plane — adversary selection and in-jit attack noise
#: (fed/robust/attacks.py).
TAG_ROBUST = 0xBADC0DE

#: Privacy plane — DP Gaussian noise and secure-aggregation pair masks
#: (fed/privacy/).
TAG_PRIVACY = 0x5EC4E7

DOMAIN_TAGS: dict[str, int] = {
    "rr": TAG_RR,
    "wr": TAG_WR,
    "comm": TAG_COMM,
    "fleet": TAG_FLEET,
    "robust": TAG_ROBUST,
    "privacy": TAG_PRIVACY,
}

# ---------------------------------------------------------------------------
# Subtags: independent draws *within* a domain.  Unique per domain (the
# domain tag is already folded in, so cross-domain reuse would be harmless —
# but the collision test holds them globally unique anyway to keep audits
# trivial).
# ---------------------------------------------------------------------------

# comm (fed/comm/codecs.py): the downlink broadcast draws off the SAME
# TAG_COMM chain as the uplink codec keys but with this subtag folded in, so
# a round where both directions compress never correlates the server's
# stochastic rounding with the client's.
SUB_COMM_DOWNLINK = 0xD0DEC

# fleet (fed/fleet/model.py)
SUB_FLEET_TIER = 0x71E2
SUB_FLEET_LATENCY = 0x1A7E
SUB_FLEET_DROPOUT = 0xD209
SUB_FLEET_STRAGGLER = 0x57A6

# robust (fed/robust/attacks.py)
SUB_ROBUST_ADVERSARY = 0xAD5E7
SUB_ROBUST_NOISE = 0x2015E

# privacy (fed/privacy/)
SUB_DP_NOISE = 0xDB015E     # server-side Gaussian noise, per (seed, round)
SUB_SECAGG_MASK = 0x3A5CED  # pairwise antisymmetric masks, per (seed, pair, round)

SUBTAGS: dict[str, dict[str, int]] = {
    "comm": {
        "downlink": SUB_COMM_DOWNLINK,
    },
    "fleet": {
        "tier": SUB_FLEET_TIER,
        "latency": SUB_FLEET_LATENCY,
        "dropout": SUB_FLEET_DROPOUT,
        "straggler": SUB_FLEET_STRAGGLER,
    },
    "robust": {
        "adversary": SUB_ROBUST_ADVERSARY,
        "noise": SUB_ROBUST_NOISE,
    },
    "privacy": {
        "dp_noise": SUB_DP_NOISE,
        "secagg_mask": SUB_SECAGG_MASK,
    },
}

__all__ = [
    "DOMAIN_TAGS", "SUBTAGS",
    "TAG_RR", "TAG_WR", "TAG_COMM", "TAG_FLEET", "TAG_ROBUST", "TAG_PRIVACY",
    "SUB_COMM_DOWNLINK",
    "SUB_FLEET_TIER", "SUB_FLEET_LATENCY", "SUB_FLEET_DROPOUT",
    "SUB_FLEET_STRAGGLER", "SUB_ROBUST_ADVERSARY", "SUB_ROBUST_NOISE",
    "SUB_DP_NOISE", "SUB_SECAGG_MASK",
]
