"""Checkpoints in the JAX package's file format (the port of
``repro.utils.checkpoint``).

A checkpoint is an ``.npz`` with one entry a leaf of the JAX package's tree,
keyed by its '/'-joined tree path, plus a JSON sidecar of metadata.  The
port's trees go through ``weights.params_to_jax`` / ``server_state_to_jax``
on the way out and ``params_from_jax`` / ``server_state_from_jax`` on the
way in, so the entries have the JAX layout: ``params/blocks/<name>``
stacked ``[L, ...]``, a bank's leaves ``[N+1, L, ...]``, ``rnd`` a 0-d
int32.  A file saved by either package loads in the other.  bf16 leaves
are stored widened to fp32 and cast back to the template's dtype.

Writes are atomic: both files go to tmp names in the target directory and
are ``os.replace``-d over the real ones, the sidecar last as the commit
marker.  Loads refuse what would resume a different run: missing keys,
shape mismatches, a bank the template lacks (or the reverse), another
format or version, and, given a DP run's ``fl=``, a file whose
``dp_accounting`` record is missing or names another mechanism
(``fed.privacy.check_dp_resume``); ``save_server_state(fl=)`` writes that
record, in the JAX package's format.
"""
from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from ..weights import params_from_jax, params_to_jax, server_state_from_jax, server_state_to_jax
from .pytree import flatten, tree_map, unflatten, wire_layout

if TYPE_CHECKING:     # fed imports this module
    from ..fed.server import ServerState

SERVER_STATE_FORMAT = "fedshuffle/server-state"
# version 2: the sidecar may carry a "dp_accounting" record; version-1
# checkpoints still load, they simply predate DP runs
SERVER_STATE_VERSION = 2


def _paths(path: str) -> tuple[str, str]:
    stem = path[:-4] if path.endswith(".npz") else path
    return stem + ".npz", stem + ".json"


def _widened(tree):
    # bf16 is stored widened to fp32, as the JAX package stores it
    return tree_map(lambda t: t.float() if isinstance(t, torch.Tensor)
                    and t.dtype == torch.bfloat16 else t, tree)


def _write(path: str, np_tree: dict, metadata: dict | None) -> None:
    """Atomic save of a nested tree of numpy arrays: a crash mid-save
    never tears an existing checkpoint."""
    npz_path, meta_path = _paths(path)
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    tmp_npz = npz_path + ".tmp.npz"     # np.savez appends .npz otherwise
    tmp_meta = meta_path + ".tmp"
    try:
        np.savez(tmp_npz, **flatten(np_tree))
        with open(tmp_meta, "w") as f:
            json.dump(metadata or {}, f, indent=2, default=str)
        os.replace(tmp_npz, npz_path)
        os.replace(tmp_meta, meta_path)
    finally:
        for tmp in (tmp_npz, tmp_meta):
            if os.path.exists(tmp):
                os.remove(tmp)


def save_checkpoint(path: str, tree: dict, metadata: dict[str, Any] | None = None) -> None:
    """Save a port tree (a flat dict of tensors with ``blocks/{i}/...``
    keys, or nested dicts of tensors) as the JAX package's tree."""
    _write(path, params_to_jax(_widened(tree)), metadata)


def _read(npz, template: dict, axis: int = 0, prefix: str = "") -> dict:
    """The entries under ``prefix`` of an open ``.npz`` that ``template``
    (a port tree) has in the JAX layout: ``{path: array}``, each checked
    against the template's shape, a stack's layer axis at ``axis``."""
    flat = flatten(template)
    leaves = wire_layout(flat)
    missing = [prefix + p for p, _ in leaves if prefix + p not in npz]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]} (+{max(0, len(missing) - 5)} more)")
    got = {}
    for path, names in leaves:
        key = prefix + path
        want = list(flat[names[0]].shape)
        if names != [path]:                    # a stack of layers
            want.insert(axis, len(names))
        arr = npz[key]
        if tuple(arr.shape) != tuple(want):
            # e.g. a bank saved under a different num_clients: the round
            # step would silently clamp or drop the out-of-range rows
            raise ValueError(f"checkpoint leaf {key!r} has shape {tuple(arr.shape)} but the "
                             f"template expects {tuple(want)}: it was saved under a different "
                             f"population/model configuration")
        got[path] = arr
    return got


def _read_leaf(npz, template: torch.Tensor, key: str) -> np.ndarray:
    """One array entry of an open ``.npz`` (a bank field that is a single
    tensor, the buffered server's counters), checked against its template."""
    if key not in npz:
        raise KeyError(f"checkpoint missing keys: [{key!r}]")
    arr = npz[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape {tuple(arr.shape)} but the "
                         f"template expects {tuple(template.shape)}: it was saved under a "
                         f"different population/model configuration")
    return arr


def _cast_like(restored: dict, template: dict, prefix: str = "") -> dict:
    """``restored`` (flat, on the CPU) in ``template``'s nesting, each leaf
    on its template leaf's device and in its dtype."""
    return {k: _cast_like(restored, t, f"{prefix}{k}/") if isinstance(t, dict)
            else restored[prefix + k].to(device=t.device, dtype=t.dtype)
            for k, t in template.items()}


def load_checkpoint(path: str, template: dict) -> dict:
    """Restore a port tree with the keys, shapes, dtypes and devices of
    ``template`` from ``path``."""
    npz_path, _ = _paths(path)
    with np.load(npz_path) as npz:
        got = _read(npz, template)
    return _cast_like(params_from_jax(unflatten(got), None, "cpu"), template)


def load_metadata(path: str) -> dict[str, Any]:
    with open(_paths(path)[1]) as f:
        return json.load(f)


def save_server_state(path: str, state: ServerState,
                      metadata: dict[str, Any] | None = None, *, fl=None) -> None:
    """Save a whole ``ServerState`` (params, optimizer state, round counter
    and the per-client bank when there is one), resumable bitwise.  The
    sidecar records the format, its version and whether a bank was saved;
    with ``fl=`` of a DP run (``fl.dp="on"``) also the ``dp_accounting``
    record (noise multiplier, clip, delta, sampling rate and the epsilon
    spent through ``state.rnd`` completed rounds)."""
    meta = dict(metadata or {})
    meta["state_format"] = SERVER_STATE_FORMAT
    meta["state_version"] = SERVER_STATE_VERSION
    meta["has_client_state"] = state.clients is not None
    if fl is not None:
        from ..fed.privacy import dp_active, dp_checkpoint_record  # deferred: fed imports utils

        if dp_active(fl):
            meta["dp_accounting"] = dp_checkpoint_record(fl, int(state.rnd))
    np_state = server_state_to_jax(state._replace(
        params=_widened(state.params), opt=_widened(state.opt),
        clients=None if state.clients is None else _widened(state.clients)))
    tree = {"params": np_state.params, "opt": np_state.opt, "rnd": np_state.rnd}
    if np_state.clients is not None:
        tree["clients"] = np_state.clients
    _write(path, tree, meta)


def load_server_state(path: str, template: ServerState, *, fl=None) -> ServerState:
    """Restore a ``ServerState`` saved by :func:`save_server_state` (by
    either package).  ``template`` is ``bound_strategy.init(params)`` of
    the same strategy and configuration: its bank (or its absence), shapes,
    dtypes and devices are what the checkpoint must match.  With ``fl=`` of
    a DP run the file's ``dp_accounting`` record must name the mechanism
    ``fl`` binds (noise multiplier, clip, delta, sampling rate): a resume
    under other knobs would misreport the cumulative epsilon."""
    from ..fed.server import ServerState

    meta = load_metadata(path)
    if fl is not None:
        from ..fed.privacy import check_dp_resume, dp_active

        if dp_active(fl):
            check_dp_resume(meta.get("dp_accounting"), fl)
    if meta.get("state_format") != SERVER_STATE_FORMAT:
        raise ValueError(
            f"{path!r} is not a server-state checkpoint (state_format="
            f"{meta.get('state_format')!r}); use load_checkpoint for plain parameter trees.")
    version = int(meta.get("state_version", 0))
    if not 1 <= version <= SERVER_STATE_VERSION:
        raise ValueError(f"server-state checkpoint {path!r} has version {version}; this "
                         f"build reads versions 1..{SERVER_STATE_VERSION}.")
    if meta.get("has_client_state", False) and template.clients is None:
        raise ValueError(
            f"checkpoint {path!r} carries a per-client state bank but the template has "
            f"none: bind the same strategy (same codecs) before loading.")
    if not meta.get("has_client_state", False) and template.clients is not None:
        raise ValueError(f"template expects a per-client state bank but checkpoint {path!r} "
                         f"has none: it was saved without one.")
    npz_path, _ = _paths(path)
    with np.load(npz_path) as npz:
        if "rnd" not in npz:
            raise KeyError("checkpoint missing keys: ['rnd']")
        np_state = ServerState(
            params=unflatten(_read(npz, template.params, prefix="params/")),
            opt={k: unflatten(_read(npz, v, prefix=f"opt/{k}/")) for k, v in template.opt.items()},
            rnd=npz["rnd"],
            clients=None if template.clients is None else {
                name: {field: unflatten(_read(npz, tree, axis=1,
                                              prefix=f"clients/{name}/{field}/"))
                       if isinstance(tree, dict) else
                       _read_leaf(npz, tree, f"clients/{name}/{field}")
                       for field, tree in entry.items()}
                for name, entry in template.clients.items()})
    got = server_state_from_jax(np_state, None, "cpu")
    return ServerState(
        params=_cast_like(got.params, template.params),
        opt={k: _cast_like(v, template.opt[k]) for k, v in got.opt.items()},
        rnd=got.rnd,
        clients=None if got.clients is None else {
            name: {field: _cast_like(tree, template.clients[name][field]) if isinstance(tree, dict)
                   else tree.to(device=template.clients[name][field].device,
                                dtype=template.clients[name][field].dtype)
                   for field, tree in entry.items()}
            for name, entry in got.clients.items()})
