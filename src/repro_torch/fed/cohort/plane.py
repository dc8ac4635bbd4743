"""Device-resident data plane: upload the task once, gather per round.

The legacy pipeline copies O(C * K_max * B * sample) fresh data bytes to the
device every round.  The plane inverts that: every distinct sample lives on
the device ONCE (the *bank*), and a round is materialized by gathering bank
rows (``index_select``) through the round's [C, K_max, B] index matrix.  The
host ships only the index plan — int32 indices and O(cohort) scalars, or no
indices at all when a device RR backend regenerates them.

Two bank layouts:

* **procedural** — the task exposes ``bank()`` and ``bank_rows(client_ids,
  idx)`` (a pure broadcast-arithmetic map from (client, local sample id) to
  bank row);
* **table** — fallback for any task: each client's samples are materialized
  once through ``task.batch`` into a flat [total_samples, ...] bank with an
  offsets vector.

Padding slots carry ``client_id = -1``.  Row indices wrap like Python (and
``jnp.take``) indexing, so -1 reads the last row, exactly as the JAX
package's gather does; the slot's coefficient is 0, so its data only has to
be finite.  A ``BucketedPlan`` is gathered bucket by bucket, over each
bucket's occupied rows and its K_b steps (the device RR backends generate
one bucket's streams a launch).  The port's counterpart of
``repro.fed.cohort.plane``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ...configs.base import FLConfig
from ...data.federated import Bucket, BucketedBatch, BucketedPlan, IndexPlan, Population, RoundBatch
from ...kernels.rr_perm import ops as rr_ops
from ...kernels.rr_perm.ref import rr_indices_torch, stream_key_torch


def _wrap(rows: torch.Tensor, n: int) -> torch.Tensor:
    """Python-style negative indices (-1 -> n - 1) for ``index_select``."""
    return torch.where(rows < 0, rows + n, rows)


@dataclass
class DevicePlane:
    """An uploaded task bank + the round materialization rule."""

    bank: dict                     # name -> tensor [N, ...] on ``device``
    rows_fn: Callable              # (client_ids [C], idx [C,K,B]) -> rows [C,K,B]
    fl: FLConfig
    device: torch.device
    mode: str = "rr"               # "rr" | "wr" (equalized / no-reshuffle)
    rr_backend: str = "host"       # host | host_feistel | device_ref | device

    def gather(self, client_ids: torch.Tensor, idx: torch.Tensor) -> dict:
        """Bank rows for (clients, indices) -> data dict [C, K, B, ...]."""
        rows = self.rows_fn(client_ids, idx.to(torch.int64))
        out = {}
        for name, leaf in self.bank.items():
            flat = _wrap(rows.reshape(-1), leaf.shape[0])
            out[name] = leaf.index_select(0, flat).reshape(rows.shape + leaf.shape[1:])
        return out

    def _indices(self, client_id, sizes, spe, rnd: int, K: int) -> torch.Tensor:
        """Regenerate the RR streams on the device (stateless, O(slots)).
        The streams are counter-based per (epoch, position), so a K < K_max
        generation is exactly the K-step prefix of the full stream."""
        prekey = stream_key_torch(self.fl.seed, client_id, rnd)
        args = (prekey, sizes, spe)
        kw = dict(B=self.fl.local_batch, K=K, rounds=self.fl.rr_rounds, mode=self.mode)
        if self.rr_backend == "device":
            return rr_ops.rr_indices(*args, **kw)
        return rr_indices_torch(*args, **kw)

    def materialize(self, plan: "IndexPlan | BucketedPlan") -> "RoundBatch | BucketedBatch":
        """Device index plan -> device round batch."""
        if isinstance(plan, BucketedPlan):
            buckets = []
            for b in plan.buckets:
                cids = plan.meta.client_id.index_select(0, b.slots)
                idx = b.idx
                if idx is None:
                    idx = self._indices(cids, plan.sizes.index_select(0, b.slots),
                                        plan.spe.index_select(0, b.slots), plan.rnd,
                                        int(b.step_mask.shape[1]))
                buckets.append(Bucket(data=self.gather(cids, idx), idx=None,
                                      step_mask=b.step_mask, slots=b.slots))
            return BucketedBatch(buckets=tuple(buckets), meta=plan.meta, pos=plan.pos)
        idx = plan.idx
        if idx is None:
            idx = self._indices(plan.meta.client_id, plan.sizes, plan.spe, plan.rnd,
                                int(plan.step_mask.shape[1]))
        data = self.gather(plan.meta.client_id, idx)
        return RoundBatch(data=data, step_mask=plan.step_mask, meta=plan.meta)


def _table_bank(task, population: Population, device: torch.device):
    """Materialize every client's samples once -> flat bank + offsets."""
    sizes = np.asarray(population.sizes, dtype=np.int64)
    offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    parts = []
    for cid, n_i in enumerate(sizes):
        sample = task.batch(cid, np.arange(int(n_i)).reshape(1, -1))
        parts.append({k: v[0] for k, v in sample.items()})
    bank = {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}
    offs = torch.as_tensor(offsets[:-1], device=device)

    def rows_fn(client_ids, idx):
        return offs.index_select(0, _wrap(client_ids, len(sizes)))[:, None, None] + idx

    return bank, rows_fn


def build_plane(task, population: Population, fl: FLConfig, *, device: torch.device,
                rr_backend: str | None = None) -> DevicePlane:
    """Upload the task's data plane for (task, population, fl) to ``device``."""
    from ..strategy import equalized_mode  # deferred: avoids import cycle

    if hasattr(task, "bank") and hasattr(task, "bank_rows"):
        bank_np, rows_fn = task.bank(), task.bank_rows
    else:
        bank_np, rows_fn = _table_bank(task, population, device)
    bank = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in bank_np.items()}
    mode = "wr" if (equalized_mode(fl.algorithm) is not None or not fl.reshuffle) else "rr"
    return DevicePlane(bank=bank, rows_fn=rows_fn, fl=fl, device=device, mode=mode,
                       rr_backend=rr_backend or fl.rr_backend)
