"""Federated data pipeline: population metadata + per-round batch assembly.

The port's numpy copy of ``repro.data.federated``, both execution layouts
and the fleet plane's hooks (``repro_torch.fed.fleet``: sync-mode fault
passes, the buffered server's ticks as cohorts, deadline caps folded into
the bucket layout).  It turns (task, FLConfig) into the static-shape host
arrays a round consumes:

* ``Population`` — client dataset sizes |D_i| (equal / log-normal / zipf
  imbalance), objective weights w_i = |D_i|/|D|.
* ``IndexPlan`` — the *index-level* description of a round: RR index matrices
  [C, K_max, B] (or None when the device generates them), step masks and
  per-client scalars.
* ``RoundBatch`` — the materialized plan: data [C, K_max, B, ...] gathered
  through ``task.batch``.
* ``BucketedPlan`` / ``BucketedBatch`` — the bucketed layout
  (``fl.exec_mode="bucketed"``): the cohort's slots partitioned into static
  step buckets, one [C_b, K_b] slice each, plus the slot-order map ``pos``.

``FederatedPipeline`` is the **legacy / reference path**: it materializes
every round batch on the host.  The cohort engine (``repro_torch.fed.cohort``)
reuses ``index_plan`` and leaves the gather to a device-resident data plane;
with the host RR backend both paths are bitwise-identical.  Every array here
is numpy; ``repro_torch.fed.rounds.as_device_batch`` moves them to a device.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np

from ..configs.base import FLConfig
from .reshuffle import local_step_indices, steps_for
from .tasks import HELDOUT_BASE


def _rng(*keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(entropy=[int(k) & 0xFFFFFFFF for k in keys]))


def _chernoff_bound(mu: float) -> int:
    """Upper bound on a ~mean-``mu`` occupancy count with 4-sigma-ish slack.

    Shared by the independent-sampling cohort-slot padding and the bucketed
    layout's per-bucket capacities: overflow past it is pathological, not
    routine."""
    return int(np.ceil(mu + 4.0 * np.sqrt(mu) + 4.0))


class ClientMeta(NamedTuple):
    """Per-cohort-slot scalars consumed by the algorithms (all [C]).

    The trailing fleet-plane fields default to None for hand-built metas;
    the pipeline always fills real arrays — zeros when the fleet plane is
    off, so the default path computes nothing new."""

    weight: Any              # w_i = |D_i|/|D|
    prob: Any                # p_i (inclusion probability of the sampling S)
    num_samples: Any         # |D_i|
    epochs: Any              # E_i this round
    num_steps: Any           # actual local steps this round (after interrupts)
    num_steps_planned: Any   # K_i = E_i * ceil(|D_i|/B) (planned)
    valid: Any               # 1.0 if the slot holds a sampled client else 0.0
    client_id: Any           # int ids; -1 on padding slots
    # heterogeneous fleet plane (repro_torch.fed.fleet); zeros outside
    # buffered / faulty configurations
    staleness: Any = None    # server ticks the slot's update is stale (>= 0)
    arrive_time: Any = None  # virtual arrival offset within the round/tick
    dropped: Any = None      # 1.0 where a sampled client dropped out (valid=0)


class RoundBatch(NamedTuple):
    data: Any                # dict, leaves [C, K_max, B, ...]
    step_mask: Any           # [C, K_max]
    meta: ClientMeta


class IndexPlan(NamedTuple):
    """A round described by indices instead of data — what the cohort engine
    ships to the device.  ``idx`` is None when a device RR backend
    regenerates the stream from (seed, client, round) alone; ``sizes`` /
    ``spe`` are the int32 per-slot scalars that keying needs (both 1 on
    padding slots)."""

    idx: Any                 # [C, K_max, B] int32 | None
    step_mask: Any           # [C, K_max] float32
    meta: ClientMeta
    sizes: Any               # [C] int32
    spe: Any                 # [C] int32 (steps per epoch)
    rnd: int


# ---------------------------------------------------------------------------
# Bucketed execution layout.  The padded layout runs every slot for K_max
# steps, masked; the bucketed one partitions the slots into step buckets
# (edge K_b, capacity C_b), both derived ONCE from population statistics.
# Per-slot index streams and masks are *prefixes* of the padded ones (the RR
# streams are counter-based per position), and every cross-client aggregate
# runs on slot-order-reassembled full arrays, which is what keeps the two
# layouts bitwise-identical.
# ---------------------------------------------------------------------------


class BucketLayout(NamedTuple):
    """Static bucket shapes: step edge K_b and slot capacity C_b per bucket."""

    edges: tuple             # ascending step caps; last >= every possible K_i
    caps: tuple              # slot capacity per bucket (same length as edges)


class Bucket(NamedTuple):
    """One bucket's slice of a round: up to C_b slots running K_b steps.

    ``slots`` maps bucket position -> original cohort slot (padding positions
    point at slot 0 — their masks are all-zero, and they are never read
    back).  ``bucketize`` fills positions 0, 1, ... in slot order, so the
    occupied positions are a prefix.  ``data`` is None until materialized;
    ``idx`` is None when a device RR backend regenerates the streams.
    """

    data: Any                # dict [C_b, K_b, B, ...] | None (plan stage)
    idx: Any                 # [C_b, K_b, B] int32 | None
    step_mask: Any           # [C_b, K_b] float32
    slots: Any               # [C_b] int32


class BucketedBatch(NamedTuple):
    """The bucketed counterpart of ``RoundBatch``: per-bucket data slices plus
    the slot-order reassembly map.  ``meta`` stays in original [C] slot order
    so every aggregation / normalization reduction is bitwise-identical to
    the padded layout.  ``pos[c]`` is slot c's position in the bucket
    concatenation; unassigned (invalid) slots point one past the end."""

    buckets: tuple           # of Bucket (data materialized)
    meta: ClientMeta         # [C] original slot order
    pos: Any                 # [C] int32 into [sum_b C_b + 1]


class BucketedPlan(NamedTuple):
    """Index-level description of a bucketed round (cohort-engine transport).

    Like ``IndexPlan`` but with the heavy [*, K, B] tensors bucketized;
    ``sizes`` / ``spe`` / ``meta`` stay full-[C] (the plane takes per-bucket
    views through ``Bucket.slots``)."""

    buckets: tuple           # of Bucket (data=None)
    meta: ClientMeta         # [C]
    pos: Any                 # [C] int32
    sizes: Any               # [C] int32
    spe: Any                 # [C] int32
    rnd: int


@dataclass
class Population:
    """The client population and its imbalance structure."""

    num_clients: int
    sizes: np.ndarray        # |D_i|, int64 [n]

    @classmethod
    def build(cls, fl: FLConfig, sizes: np.ndarray | None = None) -> "Population":
        if sizes is not None:
            return cls(len(sizes), np.asarray(sizes, dtype=np.int64))
        n = fl.num_clients
        r = _rng(fl.seed, 0x512E)
        if fl.imbalance == "equal":
            s = np.full(n, fl.mean_samples, dtype=np.int64)
        elif fl.imbalance == "lognormal":
            s = np.round(np.exp(r.normal(np.log(fl.mean_samples), 0.9, size=n))).astype(np.int64)
        elif fl.imbalance == "zipf":
            ranks = np.arange(1, n + 1, dtype=np.float64)
            s = np.round(fl.mean_samples * n * (ranks**-1.2) / (ranks**-1.2).sum() * 1.0).astype(np.int64)
        else:
            raise ValueError(fl.imbalance)
        return cls(n, np.maximum(s, fl.min_samples))

    @property
    def weights(self) -> np.ndarray:
        return (self.sizes / self.sizes.sum()).astype(np.float64)


@dataclass
class FederatedPipeline:
    """Assembles static-shape round batches for a (task, population, FLConfig)."""

    task: Any
    population: Population
    fl: FLConfig

    def __post_init__(self):
        e_max = max(self.fl.epochs, self.fl.epochs_max)
        spe_all = np.maximum(1, -(-self.population.sizes // self.fl.local_batch))
        self.k_max = self.fl.k_max or int((spe_all * e_max).max())
        self._weights = self.population.weights
        self._probs = self.inclusion_probs()
        # heterogeneous fleet plane: None with every knob at its default, so
        # the frozen path builds nothing and computes nothing new
        from ..fed import fleet as _fleet  # deferred: the fleet plane imports Population

        self.fleet = _fleet.build_fleet(self.fl, self.population)
        if self.fleet is not None:
            _fleet.validate_fleet_config(self.fl)
        self._fault_names = _fleet.parse_faults(self.fl.faults)
        self.cohort_slots = self._cohort_slots()
        self._fleet_sched = None
        if self.fl.server_mode == "buffered":
            self._fleet_sched = _fleet.BufferedSchedule(
                self.fl, self.population, self.fleet,
                probs=self._probs, steps_fn=self._fleet_steps)
        self._bucket_layout: BucketLayout | None = None

    def _cohort_slots(self) -> int:
        if self.fl.server_mode == "buffered":
            # one server tick aggregates exactly buffer_size arrivals; failed
            # clients ride trailing padding slots, sized by Chernoff slack
            # over the expected failure count per K arrivals (overflow past
            # the slack warns and truncates the *dropped* record, never the
            # aggregated arrivals)
            p = 0.0
            if "dropout" in self._fault_names:
                p += float(self.fl.drop_prob)
            if "abort" in self._fault_names and self.fleet is not None:
                p += float(np.mean(self.fleet.deadline_caps(self.fl.round_deadline) < 1))
            p = min(p, 0.99)
            slack = _chernoff_bound(self.fl.buffer_size * p / (1.0 - p)) if p > 0 else 0
            return self.fl.buffer_size + slack
        if self.fl.sampling == "full":
            return self.population.num_clients
        if self.fl.sampling == "uniform":
            return self.fl.cohort_size
        # independent sampling: |S| is random with mean mu = sum_i p_i; pad to
        # a Chernoff-style bound so silent truncation is pathological
        bound = _chernoff_bound(float(self._probs.sum()))
        b = self.fl.cohort_size
        return min(self.population.num_clients, max(2 * b, b + 4, bound))

    # -- sampling ----------------------------------------------------------

    def inclusion_probs(self) -> np.ndarray:
        """p_i for the configured proper sampling (paper §3)."""
        n, b = self.population.num_clients, self.fl.cohort_size
        if self.fl.sampling == "full":
            return np.ones(n)
        if self.fl.sampling == "uniform":
            return np.full(n, b / n)
        if self.fl.sampling == "independent":
            # importance sampling: p_i = min(1, b * w_i)  (paper §5)
            return np.minimum(1.0, b * self._weights)
        raise ValueError(self.fl.sampling)

    def _sample(self, rnd: int):
        """Realize S^r through the participation scheduler -> (ids, probs)."""
        from ..fed.cohort.scheduler import sample_round  # deferred: avoids import cycle

        return sample_round(self.fl, self.population, rnd,
                            slots=self.cohort_slots, probs=self._probs)

    def epochs_for(self, rnd: int, client: int) -> int:
        if self.fl.epochs_max <= self.fl.epochs:
            return self.fl.epochs
        return int(_rng(self.fl.seed, 0xE70C, rnd, client).integers(self.fl.epochs, self.fl.epochs_max + 1))

    def _fleet_steps(self, cid: int, rnd: int) -> int:
        """Planned local steps of one (client, round) — the wall-time driver
        the buffered schedule dispatches with (mirrors the per-slot math in
        ``index_plan``: epoch draw, interrupt cut, k_max clamp)."""
        n_i = int(self.population.sizes[int(cid)])
        steps = steps_for(n_i, self.epochs_for(rnd, int(cid)), self.fl.local_batch)
        if self.fl.drop_last_steps:
            steps = max(1, steps - self.fl.drop_last_steps)
        return min(steps, self.k_max)

    # -- index-plan assembly ----------------------------------------------

    def _equalized_steps(self, rnd: int, cohort: np.ndarray) -> int | None:
        """Equalized-K strategies (FedAvgMin / FedAvgMean): a common fixed K
        for the whole cohort, as the registered strategy declares."""
        from ..fed.strategy import equalized_mode  # deferred: avoids import cycle

        mode = equalized_mode(self.fl.algorithm)
        if mode is None:
            return None
        ks = [
            steps_for(int(self.population.sizes[int(c)]), self.epochs_for(rnd, int(c)),
                      self.fl.local_batch)
            for c in cohort
        ]
        return int(min(ks)) if mode == "min" else int(round(np.mean(ks)))

    def index_plan(self, rnd: int, *, with_idx: bool = True) -> IndexPlan:
        """The index-level round description (everything but the data bytes).

        ``with_idx=False`` skips host RR generation entirely (a device
        backend regenerates the streams) — the host then does only
        O(cohort) scalar work plus the [C, K_max] mask.
        """
        tick = None
        if self._fleet_sched is not None:
            # buffered-async: the cohort is server tick ``rnd``'s first-K
            # arrivals from the virtual-clock executor, not a fresh sample
            tick = self._fleet_sched.tick(rnd)
            cohort, probs_slot = tick.ids, tick.probs
        else:
            sample = self._sample(rnd)
            cohort, probs_slot = sample.ids, sample.probs
        C, K, B = self.cohort_slots, self.k_max, self.fl.local_batch
        w = self._weights
        fixed_k = self._equalized_steps(rnd, cohort)

        idx_all = np.zeros((C, K, B), dtype=np.int32) if with_idx else None
        step_mask = np.zeros((C, K), dtype=np.float32)
        sizes = np.ones(C, dtype=np.int32)
        spe = np.ones(C, dtype=np.int32)
        meta = ClientMeta(
            weight=np.zeros(C), prob=np.ones(C), num_samples=np.ones(C),
            epochs=np.ones(C), num_steps=np.ones(C), num_steps_planned=np.ones(C),
            valid=np.zeros(C), client_id=np.full(C, -1, dtype=np.int64),
            staleness=np.zeros(C), arrive_time=np.zeros(C), dropped=np.zeros(C),
        )

        for slot, cid in enumerate(cohort):
            cid = int(cid)
            n_i = int(self.population.sizes[cid])
            e_i = self.epochs_for(rnd, cid)
            steps_per_epoch = max(1, -(-n_i // B))
            if fixed_k is not None:
                # equalized-steps heuristics sample *with replacement* (Table 4)
                steps = min(fixed_k, K)
                if with_idx:
                    rr = _rng(self.fl.seed, 0xF1CED, rnd, cid)
                    idx_all[slot, :steps] = rr.integers(0, n_i, size=(steps, B))
                mask = np.zeros((K,), np.float32)
                mask[:steps] = 1.0
                planned = steps
            else:
                planned = steps_for(n_i, e_i, B)
                if with_idx:
                    idx_all[slot], mask = local_step_indices(
                        self.fl.seed, cid, rnd, n_i, e_i, B, K,
                        reshuffle=self.fl.reshuffle,
                    )
                else:
                    if planned > K:
                        raise ValueError(f"client {cid}: K_i={planned} exceeds k_max={K}")
                    mask = np.zeros((K,), np.float32)
                    mask[:planned] = 1.0
            # system interruptions (Fig. 4): drop the last steps of the plan
            if self.fl.drop_last_steps:
                done = int(mask.sum())
                cut = max(1, done - self.fl.drop_last_steps)
                mask[cut:] = 0.0
            step_mask[slot] = mask
            sizes[slot] = n_i
            spe[slot] = steps_per_epoch
            meta.weight[slot] = w[cid]
            meta.prob[slot] = probs_slot[slot]
            meta.num_samples[slot] = n_i
            meta.epochs[slot] = e_i
            meta.num_steps[slot] = float(mask.sum())
            meta.num_steps_planned[slot] = planned
            meta.valid[slot] = 1.0
            meta.client_id[slot] = cid

        if self.fleet is not None:
            if tick is None:
                self._apply_fleet_sync(rnd, cohort, step_mask, meta)
            else:
                self._apply_fleet_buffered(tick, step_mask, meta)
        return IndexPlan(idx=idx_all, step_mask=step_mask, meta=meta,
                         sizes=sizes, spe=spe, rnd=int(rnd))

    def _apply_fleet_sync(self, rnd: int, cohort, step_mask, meta) -> None:
        """Sync-mode fleet pass over the filled slots: realize tier wall
        times and fault scenarios, cut masks at deadline step caps, turn
        dropped clients into padding (valid=0, mask zeroed) in place."""
        from ..fed.fleet import apply_faults  # deferred: the fleet plane imports Population

        m = len(cohort)
        if m == 0:
            return
        ids = meta.client_id[:m].astype(np.int64)
        rf = apply_faults(self.fl, self.fleet, ids, rnd, meta.num_steps[:m].astype(np.int64))
        K = step_mask.shape[1]
        cap = np.minimum(np.maximum(rf.steps_cap, 1), K)
        # masks are step-prefixes, so a cut at cap stays a prefix
        step_mask[:m] *= (np.arange(K)[None, :] < cap[:, None]).astype(np.float32)
        step_mask[:m][rf.dropped] = 0.0
        meta.num_steps[:m] = np.maximum(step_mask[:m].sum(axis=1), 1.0)
        meta.arrive_time[:m] = rf.wall
        meta.dropped[:m] = rf.dropped.astype(np.float64)
        meta.valid[:m][rf.dropped] = 0.0

    def _apply_fleet_buffered(self, tick, step_mask, meta) -> None:
        """Buffered-mode fleet pass: staleness/arrival offsets from the tick
        (dropout and straggler were realized inside the schedule — only the
        deterministic abort step caps re-apply to the realized masks), plus
        the tick's dropped clients recorded on trailing padding slots."""
        m = len(tick.ids)
        meta.staleness[:m] = tick.staleness
        meta.arrive_time[:m] = tick.arrive
        if "abort" in self._fault_names and self.fl.round_deadline > 0:
            K = step_mask.shape[1]
            cap = self.fleet.deadline_caps(self.fl.round_deadline)[tick.ids]
            cap = np.minimum(np.maximum(cap, 1), K)
            step_mask[:m] *= (np.arange(K)[None, :] < cap[:, None]).astype(np.float32)
            meta.num_steps[:m] = np.maximum(step_mask[:m].sum(axis=1), 1.0)
        d = np.asarray(tick.dropped_ids, np.int64)
        if len(d) == 0:
            return
        room = len(meta.valid) - m
        if len(d) > room:
            warnings.warn(
                f"buffered tick recorded {len(d)} dropped clients but only "
                f"{room} padding slots exist; truncating the dropped record "
                f"(aggregation is unaffected).", RuntimeWarning, stacklevel=3)
            d = d[:room]
        sl = slice(m, m + len(d))
        meta.client_id[sl] = d
        meta.dropped[sl] = 1.0
        meta.arrive_time[sl] = tick.dropped_arrive[:len(d)]

    # -- bucketed layout (padding-free execution) ---------------------------

    @property
    def bucket_layout(self) -> BucketLayout:
        """Static (edges, caps) for this population — computed once, so the
        bucketed round's shapes never change across rounds."""
        if self._bucket_layout is None:
            self._bucket_layout = self._build_bucket_layout()
        return self._bucket_layout

    def _build_bucket_layout(self) -> BucketLayout:
        from ..fed.strategy import equalized_mode  # deferred: avoids import cycle

        C = self.cohort_slots
        single = BucketLayout(edges=(self.k_max,), caps=(C,))
        nb = max(1, int(self.fl.buckets))
        # equalized-K strategies give the whole cohort one (round-dependent)
        # step count — per-client bucketing has nothing to cut, so the layout
        # degenerates to a single full-width bucket
        if nb == 1 or equalized_mode(self.fl.algorithm) is not None:
            return single
        e_max = max(self.fl.epochs, self.fl.epochs_max)
        spe_all = np.maximum(1, -(-self.population.sizes // self.fl.local_batch))
        k_pop = (spe_all * e_max).astype(np.int64)
        if self.fl.drop_last_steps:
            # interrupts shorten every client's realized mask identically
            k_pop = np.maximum(1, k_pop - self.fl.drop_last_steps)
        if "abort" in self._fault_names and self.fleet is not None \
                and self.fl.round_deadline > 0:
            # deadline aborts cap realized steps *deterministically* per
            # client — folding the caps in maps device tiers onto step
            # buckets, so slow tiers land in narrow buckets and the loop
            # never pays for work the deadline forbids
            caps_pop = self.fleet.deadline_caps(self.fl.round_deadline)
            k_pop = np.minimum(k_pop, np.maximum(1, caps_pop))
        qs = np.quantile(k_pop, [(b + 1) / nb for b in range(nb)], method="higher")
        edges = sorted({int(q) for q in qs})
        edges[-1] = max(edges[-1], int(k_pop.max()))
        n = self.population.num_clients
        caps, lo = [], 0
        for e in edges:
            mem = (k_pop > lo) & (k_pop <= e)
            n_b = int(mem.sum())
            lo = e
            if n_b == 0:
                caps.append(0)
                continue
            if self.fl.sampling == "full":
                cap = n_b                       # every member shows up, exactly
            else:
                # Chernoff-style slack over the expected per-round occupancy,
                # mirroring the independent-sampling slot bound: overflow past
                # the cap spills into a wider bucket; past the last bucket the
                # round falls back to the padded layout (bitwise-identical)
                if self.fl.sampling == "independent":
                    mu = float(self._probs[mem].sum())
                else:
                    mu = C * n_b / n
                cap = _chernoff_bound(mu)
            caps.append(min(C, n_b, cap))
        keep = [i for i, c in enumerate(caps) if c > 0]
        if not keep:
            return single
        return BucketLayout(edges=tuple(edges[i] for i in keep),
                            caps=tuple(caps[i] for i in keep))

    def bucketize(self, plan: IndexPlan) -> "BucketedPlan | IndexPlan":
        """Partition a round's slots into the static bucket layout.

        Greedy in slot order: each valid slot lands in the narrowest bucket
        that fits its realized step count and still has capacity, spilling
        into wider buckets when full (wider is always semantically fine — the
        extra steps are masked no-ops).  If even the widest eligible buckets
        are full, the round falls back to the padded ``IndexPlan`` unchanged
        (same results) with a warning.
        """
        edges, caps = self.bucket_layout
        nb, C = len(edges), self.cohort_slots
        if nb == 1 and edges[0] >= self.k_max and caps[0] >= C:
            # degenerate layout (equalized presets, fl.buckets=1, equal
            # imbalance): one full-width bucket computes exactly the padded
            # loop — skip the per-round repacking and run the plan as-is
            return plan
        occ: list[list[int]] = [[] for _ in range(nb)]
        for c in range(C):
            if plan.meta.valid[c] <= 0:
                continue
            k_req = int(round(float(plan.meta.num_steps[c])))
            b = 0
            while b < nb and (edges[b] < k_req or len(occ[b]) >= caps[b]):
                b += 1
            if b == nb:
                warnings.warn(
                    f"bucketed layout overflow in round {int(plan.rnd)}: slot "
                    f"{c} (K_i={k_req}) fits no bucket with free capacity "
                    f"(edges={edges}, caps={caps}); falling back to the "
                    f"padded layout for this round. Results are unchanged; "
                    f"raise fl.buckets or the cap slack if this recurs.",
                    RuntimeWarning, stacklevel=2,
                )
                return plan
            occ[b].append(c)
        pos = np.full(C, sum(caps), dtype=np.int32)
        buckets, offset = [], 0
        for b in range(nb):
            k_b, c_b = edges[b], caps[b]
            slots = np.zeros(c_b, dtype=np.int32)
            mask = np.zeros((c_b, k_b), dtype=np.float32)
            idx = (None if plan.idx is None
                   else np.zeros((c_b, k_b, self.fl.local_batch), dtype=np.int32))
            for p, c in enumerate(occ[b]):
                slots[p] = c
                mask[p] = plan.step_mask[c, :k_b]
                if idx is not None:
                    idx[p] = plan.idx[c, :k_b]
                pos[c] = offset + p
            offset += c_b
            buckets.append(Bucket(data=None, idx=idx, step_mask=mask, slots=slots))
        return BucketedPlan(buckets=tuple(buckets), meta=plan.meta, pos=pos,
                            sizes=plan.sizes, spe=plan.spe, rnd=plan.rnd)

    def bucketed_plan(self, rnd: int, *, with_idx: bool = True) -> "BucketedPlan | IndexPlan":
        return self.bucketize(self.index_plan(rnd, with_idx=with_idx))

    # -- batch materialization (the legacy / reference data path) ----------

    def round_batch(self, rnd: int) -> "RoundBatch | BucketedBatch":
        plan = self.index_plan(rnd, with_idx=True)
        if self.fl.exec_mode == "bucketed":
            bplan = self.bucketize(plan)
            if isinstance(bplan, BucketedPlan):
                return self._materialize_bucketed(bplan)
        return self._materialize_padded(plan)

    def _materialize_padded(self, plan: IndexPlan) -> RoundBatch:
        C, K, B = self.cohort_slots, self.k_max, self.fl.local_batch
        data = {name: np.zeros((C, K, B) + tuple(shape), dtype=dt)
                for name, (dt, shape) in self.task.spec().items()}
        for slot in np.nonzero(plan.meta.valid > 0)[0]:
            sample = self.task.batch(int(plan.meta.client_id[slot]), plan.idx[slot])
            for name in data:
                data[name][slot] = sample[name]
        return RoundBatch(data=data, step_mask=plan.step_mask, meta=plan.meta)

    def _materialize_bucketed(self, plan: BucketedPlan) -> BucketedBatch:
        B = self.fl.local_batch
        spec = self.task.spec()
        out, offset = [], 0
        for b in plan.buckets:
            c_b, k_b = b.step_mask.shape
            data = {name: np.zeros((c_b, k_b, B) + tuple(shape), dtype=dt)
                    for name, (dt, shape) in spec.items()}
            for p in range(c_b):
                c = int(b.slots[p])
                if int(plan.pos[c]) != offset + p:
                    continue                    # padding position (all masked)
                sample = self.task.batch(int(plan.meta.client_id[c]), b.idx[p])
                for name in data:
                    data[name][p] = sample[name]
            offset += c_b
            out.append(Bucket(data=data, idx=None, step_mask=b.step_mask, slots=b.slots))
        return BucketedBatch(buckets=tuple(out), meta=plan.meta, pos=plan.pos)

    def eval_batch(self, rnd: int = 0, per_client: int = 2) -> dict:
        """A small held-out batch pooled across clients (host eval): each
        leaf [num_clients * per_client, ...], client-major.

        Ids come from the task's explicit held-out split (``heldout_ids``);
        tasks without one fall back to the ``HELDOUT_BASE`` offset
        convention (train ids live strictly below it)."""
        parts = []
        for cid in range(self.population.num_clients):
            if hasattr(self.task, "heldout_ids"):
                ids = np.asarray(self.task.heldout_ids(cid, per_client))
            else:
                ids = HELDOUT_BASE + np.arange(per_client, dtype=np.int64)
            parts.append(self.task.batch(cid, ids.reshape(1, per_client)))
        return {name: np.concatenate([p[name] for p in parts], axis=1)[0] for name in parts[0]}
