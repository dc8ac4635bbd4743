"""Helpers for the bucketed execution layout (``fl.exec_mode="bucketed"``).

The bucketed round runs the cohort one step bucket at a time — ``[C_b, K_b,
B]`` instead of the padded ``[C, K_max, B]`` — and then *reassembles* the
per-client results into full ``[C]`` slot-order stacks before anything
cross-client happens.  That reassembly is the bitwise contract: every
aggregation, normalization and metric reduction sees exactly the stack the
padded layout would have produced (per-client outputs are bitwise-equal
because the bucketed index streams and masks are prefixes of the padded
ones, and masked steps are exact no-ops), so the two layouts cannot drift.

The host plan (``FederatedPipeline.bucketize``) keeps the JAX package's
static layout exactly: every bucket has its ``C_b`` rows and ``pos`` indexes
their concatenation.  The JAX package runs every one of those rows, because
its compiled shapes must not change between rounds; the rows past a
bucket's occupied prefix are padding whose results it never reads.  The
port runs eagerly, so a round's row count costs it nothing: when a round
moves to the device, :func:`occupied` cuts each bucket to its occupied
prefix (``bucketize`` fills positions 0, 1, ... in slot order), drops the
empty buckets and re-bases ``pos`` onto the concatenation of the rows that
remain.  A bucket keeps at least ``MIN_ROWS`` rows: one occupied row runs
beside a copy of itself whose step mask is all zeros, because a batch of
one takes other GEMMs than a batch of two or more, which sum in another
order, on the card and on the CPU (a batch of 2..7 rows gives the bits the
same rows get in the padded batch of 8).  The copy holds finite data (a
masked step still takes its gradient), and its slot is the occupied row's
own, so every per-slot view a bucket takes is finite too; :func:`unbucket`
never copies it into the [C] stack.  The device-side ``BucketedPlan`` /
``BucketedBatch`` hold only those rows; their ``pos`` stays a host array (it
steers the sequential mode's slot loop, :func:`slot_inputs`, which never
visits the copy, and tells :func:`run_buckets` each bucket's occupied
rows).  :func:`run_buckets` runs the vmapped mode a bucket at a time.  The
port's counterpart of ``repro.fed.bucketing``.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..data.federated import Bucket, BucketedBatch


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and tuples of tensors."""
    if isinstance(tree, tuple):
        return tuple(_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


# the fewest rows a bucket's batch runs (see the module docstring)
MIN_ROWS = 2


def occupied(buckets: tuple, pos) -> tuple[tuple, np.ndarray]:
    """A host layout's buckets cut to their occupied rows (a lone occupied
    row run beside its masked copy, ``MIN_ROWS``), empty buckets dropped,
    and ``pos`` re-based onto the concatenation of the kept rows (invalid
    slots point one past its end).  ``buckets`` and ``pos`` are the host
    (numpy) fields of a ``BucketedPlan`` or ``BucketedBatch``; a layout
    whose slots are tensors was cut already (a device plan or batch) and is
    returned as it is."""
    if any(isinstance(b.slots, torch.Tensor) for b in buckets):
        return buckets, pos
    pos = np.asarray(pos)
    new_pos = np.empty_like(pos, dtype=np.int32)
    held = np.zeros(pos.shape, dtype=bool)
    kept, offset, new_offset = [], 0, 0
    for b in buckets:
        slots = np.asarray(b.slots)
        c_b = slots.shape[0]
        here = pos[slots] == offset + np.arange(c_b)
        occ = int(here.sum())
        if not here[:occ].all():
            raise ValueError("a bucket's occupied rows are not a prefix of it")
        offset += c_b
        if occ == 0:
            continue
        new_pos[slots[:occ]] = new_offset + np.arange(occ)
        held[slots[:occ]] = True
        # the occupied rows, then copies of row 0 up to MIN_ROWS, masked off
        run = np.arange(max(occ, MIN_ROWS))
        rows = np.where(run < occ, run, 0)
        mask = b.step_mask[rows] * (run < occ)[:, None].astype(b.step_mask.dtype)
        new_offset += rows.size
        kept.append(Bucket(
            data=None if b.data is None else {k: v[rows] for k, v in b.data.items()},
            idx=None if b.idx is None else b.idx[rows],
            step_mask=mask, slots=slots[rows]))
    new_pos[~held] = new_offset
    return tuple(kept), new_pos


def occupied_rows(batch) -> list[int]:
    """Each bucket's occupied rows in a device ``BucketedBatch`` (or plan):
    the slots whose ``pos`` falls in its rows; a bucket may run more
    (``MIN_ROWS``)."""
    starts = np.cumsum([0] + [b.step_mask.shape[0] for b in batch.buckets])
    pos = np.asarray(batch.pos)
    return [int(((pos >= lo) & (pos < hi)).sum()) for lo, hi in zip(starts[:-1], starts[1:])]


def slot_inputs(batch) -> list:
    """Per cohort slot, in slot order, its ``(data, step_mask)`` views: row c
    of a padded ``RoundBatch``, or a device ``BucketedBatch``'s occupied row
    of the slot (its bucket's K_b steps), None for a slot no bucket holds."""
    if not isinstance(batch, BucketedBatch):
        return [({k: v[c] for k, v in batch.data.items()}, batch.step_mask[c])
                for c in range(batch.step_mask.shape[0])]
    starts = np.cumsum([0] + [b.step_mask.shape[0] for b in batch.buckets])
    out = []
    for j in np.asarray(batch.pos).tolist():
        if j >= starts[-1]:
            out.append(None)
            continue
        i = int(np.searchsorted(starts, j, side="right")) - 1
        b, p = batch.buckets[i], j - int(starts[i])
        out.append(({k: v[p] for k, v in b.data.items()}, b.step_mask[p]))
    return out


def take_slots(tree, slots: torch.Tensor):
    """A bucket's view of a full-[C] per-slot tree (or tensor): its rows at
    ``slots``, the bucket's occupied slots."""
    return _map(lambda t: t.index_select(0, slots), tree)


def unbucket(parts: Iterable, slots: Iterable, C: int, like):
    """Per-bucket outputs over their rows (tensors, or dicts and tuples of
    them, with [rows_b, ...] leaves) -> a zero-filled [C, ...] slot-order
    stack, each bucket's first len(s) rows copied to its occupied slots
    ``s`` (int64 tensors); rows past them (a lone row's masked copy) are
    never read.  Slots no bucket holds read exact zeros, as the padded
    layout's fully masked slots compute.  ``parts`` may be a generator: each
    part is released once copied.  ``like``, one slot's output of the same
    structure, gives the shapes when there is no part (an empty cohort)."""
    out = None
    for part, s in zip(parts, slots):
        if out is None:
            out = _map(lambda t: t.new_zeros((C, *t.shape[1:])), part)
        _map(lambda o, t: o.index_copy_(0, s, t[:s.shape[0]]), out, part)
    if out is None:
        out = _map(lambda t: t.new_zeros((C, *t.shape)), like)
    return out


def run_buckets(fn, batch: BucketedBatch, like, *per_slot):
    """``fn(data_b, mask_b, *views_b)`` on each bucket's rows, reassembled
    by :func:`unbucket` into the zero-filled [C] slot-order stack from its
    occupied rows.  ``per_slot`` are full-[C] trees or tensors; each bucket
    sees its rows of them (:func:`take_slots`).  ``like``: one slot's
    output."""
    bs = batch.buckets
    parts = (fn(b.data, b.step_mask, *(take_slots(a, b.slots) for a in per_slot)) for b in bs)
    held = (b.slots[:n] for b, n in zip(bs, occupied_rows(batch)))
    return unbucket(parts, held, batch.meta.valid.shape[0], like)
