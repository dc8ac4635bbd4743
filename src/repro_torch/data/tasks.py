"""Synthetic federated tasks (the port's numpy copies of ``repro.data.tasks``).

The paper's datasets are replaced by synthetic tasks with *matched
heterogeneity structure*:

* ``QuadraticTask`` — the paper's eq. (36) exactly (this one is not synthetic).
* ``DuplicatedQuadraticTask`` — its §4.1 duplicated-point variant.
* ``PopulationQuadraticTask`` — eq. (36) scaled to a population of clients
  over a shared basis (a closed-form sample map, no per-client metadata).
* ``CharLMTask``    — Shakespeare stand-in: per-client Markov-chain language
  with client-specific transition skew and log-normal dataset sizes.
* ``VisionTask``    — CIFAR100 stand-in: class-prototype patches + Dirichlet
  (LDA-like) per-client label skew, equal split.
* ``TokenTask``     — generic LM tokens for the assigned-architecture smoke
  runs (client-biased unigram streams over the arch's vocab), with optional
  Gaussian stubs such as ``patches`` or ``frames``.

Every task exposes ``batch(client, idx_matrix) -> dict`` of numpy arrays and
``spec()`` describing one data point, so the pipeline is model-agnostic.
Each draws from numpy exactly as the JAX package's task does, so both give
the same batches bit for bit.

Two optional protocol extensions:

* **held-out split** — ``heldout_ids(client, count)`` returns sample ids that
  training never touches.  Procedural tasks reserve ids >= ``HELDOUT_BASE``.
* **device bank** — ``bank()`` (dict of [N, ...] arrays holding every
  distinct sample once) + ``bank_rows(client_ids, idx)`` (a pure, broadcast-
  only map from (client, local sample id) to bank row, valid for numpy
  arrays and torch tensors).  Tasks without them get a materialized
  per-client table bank (``repro_torch.fed.cohort.plane``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Training sample ids live in [0, HELDOUT_BASE); held-out ids start here.
# Procedural tasks generate both from the same keyed stream, so any id is
# valid data — the split is a disjoint-id contract, not a different source.
HELDOUT_BASE = 1 << 20


def _rng(*keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(entropy=[int(k) & 0xFFFFFFFF for k in keys]))


# ---------------------------------------------------------------------------
# Quadratic (paper eq. 36)
# ---------------------------------------------------------------------------


@dataclass
class QuadraticTask:
    """f(x) = (1/|D|) sum_j ||x - e_j||^2 with basis-vector data points.

    ``assignment[i]`` lists the data-point ids owned by client i; the paper's
    default is d=6 points split 1/2/3 over three clients.
    """

    dim: int = 6
    assignment: tuple = ((0,), (1, 2), (3, 4, 5))

    def __post_init__(self):
        self.points = np.eye(self.dim, dtype=np.float32)

    @property
    def num_clients(self) -> int:
        return len(self.assignment)

    def sizes(self) -> np.ndarray:
        return np.array([len(a) for a in self.assignment], dtype=np.int64)

    def batch(self, client: int, idx: np.ndarray) -> dict:
        ids = np.asarray(self.assignment[client], dtype=np.int64)[idx]
        return {"e": self.points[ids]}

    def spec(self) -> dict:
        return {"e": (np.float32, (self.dim,))}

    def heldout_ids(self, client: int, count: int) -> np.ndarray:
        """Quadratic data is finite (eq. 36 has no generative process), so the
        held-out 'split' revisits the client's own points — the objective
        value at them is still the eval of record."""
        n = len(self.assignment[client])
        return np.arange(count, dtype=np.int64) % n

    def optimum(self) -> np.ndarray:
        return self.points.mean(axis=0)

    def fedavg_biased_point(self) -> np.ndarray:
        """x~ = sum |D_i|^2 e_i / sum |D_i|^2 for the duplicated-point variant
        (each client's points collapsed to its mean, §4.1)."""
        sizes = self.sizes().astype(np.float64)
        means = np.stack([self.points[list(a)].mean(axis=0) for a in self.assignment])
        return (sizes[:, None] ** 2 * means).sum(0) / (sizes**2).sum()

    def loss_np(self, x: np.ndarray) -> float:
        return float(np.mean(np.sum((x[None, :] - self.points) ** 2, axis=-1)))


@dataclass
class DuplicatedQuadraticTask(QuadraticTask):
    """§4.1 variant: client i holds |D_i| *copies* of a single point e_i, so
    FedAvg with local shuffling == FedAvg with E*|D_i| local steps and the
    biased fixed point is exactly x~ = sum |D_i|^2 e_i / sum |D_i|^2."""

    copies: tuple = (1, 2, 3)

    def __post_init__(self):
        self.dim = len(self.copies)
        self.points = np.eye(self.dim, dtype=np.float32)
        self.assignment = tuple(tuple([i] * c) for i, c in enumerate(self.copies))

    def batch(self, client: int, idx: np.ndarray) -> dict:
        return {"e": np.broadcast_to(self.points[client], idx.shape + (self.dim,)).copy()}

    def bank(self) -> dict:
        return {"e": self.points}

    def bank_rows(self, client_ids, idx):
        # every sample of client i IS e_i — broadcast the slot's client id
        return client_ids[:, None, None] + 0 * idx

    def optimum(self) -> np.ndarray:
        sizes = np.asarray(self.copies, dtype=np.float64)
        return (sizes[:, None] * self.points).sum(0) / sizes.sum()

    def fedavg_biased_point(self) -> np.ndarray:
        sizes = np.asarray(self.copies, dtype=np.float64)
        return (sizes[:, None] ** 2 * self.points).sum(0) / (sizes**2).sum()

    def loss_np(self, x: np.ndarray) -> float:
        sizes = np.asarray(self.copies, dtype=np.float64)
        per = np.sum((x[None, :] - self.points) ** 2, axis=-1)
        return float((sizes * per).sum() / sizes.sum())


@dataclass
class PopulationQuadraticTask:
    """Population-scale quadratic: many clients over a shared basis.

    The natural scale-up of eq. (36): a shared bank of ``dim`` basis points
    e_0..e_{dim-1}; client ``i``'s local sample ``j`` is the point
    ``(i * PHI + j) mod dim`` (a client-rotated walk over the basis; with
    ``samples_per_client < dim`` clients own distinct heterogeneous slices,
    with ``samples_per_client >= dim`` every client covers the full basis).
    Both the host ``batch`` and the device ``bank_rows`` evaluate the same
    closed form, so the data plane needs no per-client metadata.

    All arithmetic is done mod-``dim`` termwise (dim**2 << 2**31), so int32
    host and device implementations agree bit for bit.
    """

    dim: int = 16
    num_clients: int = 1000
    samples_per_client: int = 16
    _PHI = 1000003

    def __post_init__(self):
        self.points = np.eye(self.dim, dtype=np.float32)

    def sizes(self) -> np.ndarray:
        return np.full(self.num_clients, self.samples_per_client, dtype=np.int64)

    def _rows(self, client, idx):
        d = self.dim
        return ((client % d) * (self._PHI % d) + idx % d) % d

    def batch(self, client: int, idx: np.ndarray) -> dict:
        return {"e": self.points[self._rows(int(client), np.asarray(idx))]}

    def spec(self) -> dict:
        return {"e": (np.float32, (self.dim,))}

    def heldout_ids(self, client: int, count: int) -> np.ndarray:
        return HELDOUT_BASE + np.arange(count, dtype=np.int64)

    def bank(self) -> dict:
        return {"e": self.points}

    def bank_rows(self, client_ids, idx):
        return self._rows(client_ids[:, None, None], idx)

    def optimum(self) -> np.ndarray:
        return self.points.mean(axis=0)

    def loss_np(self, x: np.ndarray) -> float:
        return float(np.mean(np.sum((x[None, :] - self.points) ** 2, axis=-1)))


# ---------------------------------------------------------------------------
# Char-LM (Shakespeare stand-in)
# ---------------------------------------------------------------------------


@dataclass
class CharLMTask:
    """Markov-chain character LM with per-client transition skew.

    The global chain T is sparse-ish (each state prefers ~4 successors).
    Client i's chain is T re-labelled by a client-specific permutation applied
    with probability ``heterogeneity`` — matching the paper's setting where
    clients are different Shakespeare characters (same alphabet, different
    conditional distributions).
    """

    vocab: int = 128
    seq_len: int = 128
    num_clients: int = 16
    heterogeneity: float = 0.5
    seed: int = 7

    def __post_init__(self):
        r = _rng(self.seed, 0x5EED)
        logits = r.normal(size=(self.vocab, self.vocab)).astype(np.float64)
        # sharpen: each row prefers a few successors
        keep = np.argsort(logits, axis=1)[:, -6:]
        sharp = np.full_like(logits, -8.0)
        np.put_along_axis(sharp, keep, np.take_along_axis(logits, keep, 1) + 2.0, 1)
        self.T = np.exp(sharp) / np.exp(sharp).sum(1, keepdims=True)
        self.client_perm = np.stack(
            [_rng(self.seed, 0xC11E27, i).permutation(self.vocab) for i in range(self.num_clients)]
        )

    def _client_T(self, client: int) -> np.ndarray:
        p = self.client_perm[client]
        Tp = self.T[p][:, p]
        h = self.heterogeneity
        return (1 - h) * self.T + h * Tp

    def _generate(self, client: int, ids: np.ndarray) -> np.ndarray:
        T = self._client_T(client)
        cdf = np.cumsum(T, axis=1)
        n = ids.shape[0]
        toks = np.zeros((n, self.seq_len + 1), dtype=np.int32)
        # sample-id-keyed uniforms: deterministic per (client, sample id)
        u = np.stack([_rng(self.seed, 0xDA7A, client, int(s)).random(self.seq_len + 1) for s in ids])
        toks[:, 0] = (u[:, 0] * self.vocab).astype(np.int32)
        for t in range(1, self.seq_len + 1):
            rows = cdf[toks[:, t - 1]]
            toks[:, t] = (rows < u[:, t : t + 1]).sum(axis=1).clip(0, self.vocab - 1)
        return toks

    def batch(self, client: int, idx: np.ndarray) -> dict:
        """idx [..., ] of sample ids -> tokens [..., seq_len+1] (memoized)."""
        if not hasattr(self, "_cache"):
            self._cache = {}
        flat = idx.reshape(-1)
        missing = np.array(sorted({int(s) for s in flat if (client, int(s)) not in self._cache}),
                           dtype=np.int64)
        if missing.size:
            gen = self._generate(client, missing)
            for s, row in zip(missing, gen):
                self._cache[(client, int(s))] = row
        toks = np.stack([self._cache[(client, int(s))] for s in flat])
        return {"tokens": toks.reshape(idx.shape + (self.seq_len + 1,))}

    def spec(self) -> dict:
        return {"tokens": (np.int32, (self.seq_len + 1,))}

    def heldout_ids(self, client: int, count: int) -> np.ndarray:
        return HELDOUT_BASE + np.arange(count, dtype=np.int64)


# ---------------------------------------------------------------------------
# Vision (CIFAR100 stand-in)
# ---------------------------------------------------------------------------


@dataclass
class VisionTask:
    """Class prototypes in patch space + Dirichlet label skew per client."""

    num_classes: int = 100
    num_patches: int = 64
    d_model: int = 128
    num_clients: int = 16
    alpha: float = 0.3            # Dirichlet concentration (low => skewed)
    noise: float = 0.5
    seed: int = 11

    def __post_init__(self):
        r = _rng(self.seed, 0xF00D)
        self.protos = r.normal(size=(self.num_classes, self.num_patches, self.d_model)).astype(np.float32)
        self.client_label_p = np.stack(
            [_rng(self.seed, 0x1ABE1, i).dirichlet([self.alpha] * self.num_classes)
             for i in range(self.num_clients)]
        )

    def _label(self, client: int, sample: int) -> int:
        u = _rng(self.seed, 0x11, client, sample).random()
        return int((np.cumsum(self.client_label_p[client]) < u).sum().clip(0, self.num_classes - 1))

    def batch(self, client: int, idx: np.ndarray) -> dict:
        flat = idx.reshape(-1)
        labels = np.array([self._label(client, int(s)) for s in flat], dtype=np.int32)
        noise = np.stack(
            [_rng(self.seed, 0xBEEF, client, int(s)).normal(size=(self.num_patches, self.d_model))
             for s in flat]
        ).astype(np.float32)
        patches = self.protos[labels] + self.noise * noise
        # tokens [BOS=0, label]: the model predicts the label token from the
        # patch prefix -> classification expressed as 1-step LM (unified loss).
        toks = np.stack([np.zeros_like(labels), labels], axis=-1).astype(np.int32)
        return {
            "patches": patches.reshape(idx.shape + (self.num_patches, self.d_model)),
            "tokens": toks.reshape(idx.shape + (2,)),
        }

    def spec(self) -> dict:
        return {
            "patches": (np.float32, (self.num_patches, self.d_model)),
            "tokens": (np.int32, (2,)),
        }

    def heldout_ids(self, client: int, count: int) -> np.ndarray:
        return HELDOUT_BASE + np.arange(count, dtype=np.int64)


# ---------------------------------------------------------------------------
# Generic token task (assigned-arch smoke runs)
# ---------------------------------------------------------------------------


@dataclass
class TokenTask:
    """Client-biased unigram token streams over an arbitrary vocab."""

    vocab: int = 512
    seq_len: int = 64
    num_clients: int = 8
    seed: int = 3
    extras: dict = field(default_factory=dict)  # e.g. {"frames": (T, d)} stubs

    def batch(self, client: int, idx: np.ndarray) -> dict:
        flat = idx.reshape(-1)
        toks = np.stack(
            [
                _rng(self.seed, 0x70CE2, client, int(s)).integers(
                    client % max(1, self.vocab // 8), self.vocab, size=self.seq_len + 1
                )
                for s in flat
            ]
        ).astype(np.int32)
        out = {"tokens": toks.reshape(idx.shape + (self.seq_len + 1,))}
        for name, shape in self.extras.items():
            arrs = np.stack(
                [_rng(self.seed, 0xE872A5, client, int(s)).normal(size=shape) for s in flat]
            ).astype(np.float32)
            out[name] = arrs.reshape(idx.shape + tuple(shape))
        return out

    def spec(self) -> dict:
        s = {"tokens": (np.int32, (self.seq_len + 1,))}
        for name, shape in self.extras.items():
            s[name] = (np.float32, tuple(shape))
        return s

    def heldout_ids(self, client: int, count: int) -> np.ndarray:
        return HELDOUT_BASE + np.arange(count, dtype=np.int64)
