"""Random-reshuffling index streams (the paper's RR vs with-replacement);
the port's numpy copy of ``repro.data.reshuffle``.

Everything here is host-side numpy: per-(client, round, epoch) permutations are
deterministic functions of the seed, so any round of any run can be
reconstructed exactly (important for the exact-MVR variant which revisits the
same permutation at two different parameter vectors).
"""
from __future__ import annotations

import numpy as np

from ..utils.tags import TAG_RR, TAG_WR

def _rng(*keys: int) -> np.random.Generator:
    """Deterministic generator from a tuple of integer keys."""
    seq = np.random.SeedSequence(entropy=list(int(k) & 0xFFFFFFFF for k in keys))
    return np.random.default_rng(seq)


def epoch_permutation(seed: int, client: int, rnd: int, epoch: int, n: int) -> np.ndarray:
    """The RR permutation Pi for (client, round, epoch) over n local samples."""
    return _rng(seed, TAG_RR, client, rnd, epoch).permutation(n)


def with_replacement(seed: int, client: int, rnd: int, epoch: int, n: int) -> np.ndarray:
    """The baseline the paper contrasts with: i.i.d. sampling w/ replacement."""
    return _rng(seed, TAG_WR, client, rnd, epoch).integers(0, n, size=n)


def feistel_permutation(seed: int, client: int, rnd: int, epoch: int, n: int,
                        rounds: int = 24) -> np.ndarray:
    """Counter-based RR permutation (swap-or-not cipher) — same role as
    :func:`epoch_permutation` but stateless integer math instead of a host
    PCG stream, so the cohort engine's device backends regenerate the exact
    same stream on-accelerator (``repro_torch.kernels.rr_perm``)."""
    from ..kernels.rr_perm.ref import permutation_np  # deferred: keeps numpy-only imports light

    return permutation_np(seed, client, rnd, epoch, n, rounds=rounds)


def local_step_indices(
    seed: int,
    client: int,
    rnd: int,
    n_samples: int,
    epochs: int,
    batch: int,
    k_max: int,
    reshuffle: bool = True,
    order_fn=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Index matrix [k_max, batch] + mask [k_max] for one client's local work.

    The client performs ``epochs`` passes over its ``n_samples`` points in
    batches of ``batch`` (last partial batch of an epoch is wrapped within the
    same epoch's permutation, keeping every epoch exactly one pass as in the
    paper's Algorithm 1).  Steps beyond the client's real count are masked.

    ``order_fn(seed, client, rnd, epoch, n) -> [n]`` overrides the per-epoch
    order source (e.g. :func:`feistel_permutation` for the cohort engine's
    host_feistel backend); default keeps the seed PCG streams.
    """
    if order_fn is None:
        order_fn = epoch_permutation if reshuffle else with_replacement
    steps_per_epoch = max(1, -(-n_samples // batch))
    k_i = epochs * steps_per_epoch
    if k_i > k_max:
        raise ValueError(f"client {client}: K_i={k_i} exceeds k_max={k_max}")
    idx = np.zeros((k_max, batch), dtype=np.int32)
    mask = np.zeros((k_max,), dtype=np.float32)
    step = 0
    for e in range(epochs):
        order = order_fn(seed, client, rnd, e, n_samples)
        # wrap the tail so each epoch is exactly one full pass
        padded = np.resize(order, steps_per_epoch * batch)
        for s in range(steps_per_epoch):
            idx[step] = padded[s * batch : (s + 1) * batch]
            mask[step] = 1.0
            step += 1
    return idx, mask


def steps_for(n_samples: int, epochs: int, batch: int) -> int:
    return epochs * max(1, -(-n_samples // batch))
