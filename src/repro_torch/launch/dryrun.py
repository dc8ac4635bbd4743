"""Count one step of every (arch x input-shape) setup on the meta device
(the port's counterpart of ``repro.launch.dryrun``).

The JAX package lowers and compiles each setup on a TPU mesh of 256 or 512
chips and reads XLA's per-device cost and memory analysis and the HLO's
collectives.  This module counts the whole step of one card instead: it
runs the setup's step once on the ``meta`` device (shapes alone, nothing
allocated), with the kernels' plain versions (``backend="ref"``: a kernel
cannot run on meta), inside ``torch.utils.flop_counter.FlopCounterMode``.
It is a count of the eager program, not a mesh lowering.  A record:

- ``cost.flops``: the counted matmul, bmm and einsum products, forward and
  backward (FlopCounterMode: 2 a multiply-add).
- ``cost.flops_kernel``: the same count less the attention products over
  the (query, key) pairs the causal and window mask drops
  (``cost.attention_flops_masked``, :func:`masked_attention_flops`, worked
  out per layer from the config and the shape): the pairs the flash kernel
  computes, where the plain version scores every pair.
- ``cost.bytes_min``: every argument read once and every output written
  once (each storage once; an output that is an input's storage, such as a
  decode cache written in place, is not counted again): the memory floor.
- ``cost.bytes_unfused``: the sum of every aten op's input and output
  bytes, view ops left out; an unfused count, not XLA's "bytes accessed".
- ``memory``: argument and output bytes; there is no temp count on meta.
- ``collectives``: none, one card.

With ``--mesh 16x16`` or ``--mesh 2x16x16`` (the JAX package's
``--multi-pod``) the setup is laid out on that mesh of H100 cards
(``launch/mesh.py:make_production_mesh``, over a fake process group in
this process; ``launch/specs.py`` with ``mesh=``) and the step runs on meta
as DTensors.  The record is one rank's share, counted by
:class:`LocalCount` from the ops on each rank's local shards (a counting
mode entered above DTensor sees the global shapes): ``flops``,
``flops_kernel`` (the masked attention products divided among the ranks
that split the attention, :func:`attention_split`), ``bytes_min``,
``bytes_unfused`` and ``memory`` from the local shards, and
``collectives``: each kind's ``count`` and result ``bytes`` (the JAX
package's ``collective_stats``: an all-gather's gathered tensor, a
reduce-scatter's shard, an all-to-all's new shard) and their
``total_bytes``, from the collectives DTensor issues.  The fake mesh is
typed ``cpu``, where DTensor moves a shard from one dim to another by an
all-gather and a chunk (gloo has no all-to-all); the count takes that
move as the one all-to-all NCCL runs.

``models/_flags.py`` of the JAX package (``UNROLL_INNER``, and the
``--unroll`` flag) exists because XLA counts a scan body once; the eager
count sees every launch, so the port has neither.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--archs a,b] [--shapes x,y]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --mesh 16x16

It writes one JSON a combo under ``build/dryrun/`` (``.gitignore`` lists
it); ``launch/roofline.py`` reads them.  A train setup runs the JAX
package's production mesh's 16 clients; :func:`run_one` takes ``dp``,
``batch`` and ``n_layers`` to cut a setup to one card's share.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..configs.base import INPUT_SHAPES, ArchConfig
from ..configs.registry import ASSIGNED, get_arch, get_shape
from ..models.attention import CHUNK_THRESHOLD, Q_CHUNK
from ..utils.logging import log
from .mesh import PRODUCTION_MESHES, dp_size, make_production_mesh
from .specs import make_setup

OUT_DIR = "build/dryrun"
CARD_MESH = "1xH100"
PRODUCTION_DP = 16     # the clients of a train setup: the JAX package's mesh's data axis


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (for counting its bytes), else ``t``."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree) -> list:
    return [_local(x) for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree, skip: set | None = None) -> tuple[int, set]:
    """Bytes of the distinct storages of the tensors in ``tree`` (a view
    counts its storage once) that are not in ``skip`` -> (bytes, keys)."""
    seen = set(skip or ())
    total = 0
    for t in _tensors(tree):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total, seen


class _Count(TorchDispatchMode):
    """Every aten op's input and output bytes, view ops left out."""

    def __init__(self):
        super().__init__()
        self.bytes_unfused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes_unfused += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        return out


COLLECTIVES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
               "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


def collective_kind(func) -> str | None:
    """The JAX package's name of a functional collective (``all_reduce``,
    ``all_gather_into_tensor``, ... of ``_c10d_functional``), or None."""
    if func.namespace != "_c10d_functional":
        return None
    name = func._overloadpacket.__name__
    for k, kind in COLLECTIVES.items():
        if name.startswith(k):
            return kind
    return None if name in ("wait_tensor", "_wrap_tensor_autograd") else name


class LocalCount(TorchDispatchMode):
    """One rank's share of a step over DTensors: the ops DTensor runs on
    this rank's local shards.  A mode sees an op before a tensor subclass
    does, so an op on DTensors is handed back (``NotImplemented``) for
    DTensor to run: its local ops and its collectives then come through
    here, and so do the ops on fake tensors of the global shapes by which
    DTensor propagates shapes, which are not counted.  Counts the products
    (``flop_registry``, FlopCounterMode's rules), the unfused bytes
    (:class:`_Count`'s rule) and each collective's count and result
    bytes.  While it is entered, DTensor's shard-to-shard move goes
    through :meth:`_all_to_all`."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_unfused = 0
        self.collectives = {kind: {"count": 0, "bytes": 0} for kind in COLLECTIVES.values()}
        self._quiet = 0

    def __enter__(self):
        from torch.distributed.tensor import placement_types

        self._moved = placement_types.shard_dim_alltoall
        placement_types.shard_dim_alltoall = self._all_to_all
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor import placement_types

        placement_types.shard_dim_alltoall = self._moved
        return super().__exit__(*exc)

    def _all_to_all(self, local, gather_dim, shard_dim, mesh, mesh_dim):
        """DTensor's shard-to-shard move of ``local``: on a ``cpu`` mesh an
        all-gather and a chunk (gloo has no all-to-all), run uncounted
        and counted as the one all-to-all NCCL runs, its result the new
        shard."""
        self._quiet += 1
        try:
            out = self._moved(local, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            self._quiet -= 1
        c = self.collectives[COLLECTIVES["all_to_all"]]
        c["count"] += 1
        c["bytes"] += _nbytes(out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out       # the ops of a move counted as one all-to-all
        if any(issubclass(t, FakeTensor) for t in types):
            return out       # DTensor's shape propagation over the global shapes
        kind = collective_kind(func)
        if kind is not None:
            c = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            c["count"] += 1
            c["bytes"] += sum(_nbytes(t) for t in _tensors(out))
            return out
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        if not func.is_view and func.namespace != "_c10d_functional":
            self.bytes_unfused += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        return out


def band_pairs(q0: int, tq: int, k0: int, tk: int, *, causal: bool = True,
               window: int = 0) -> int:
    """The (query, key) pairs of queries at positions q0..q0+tq-1 and keys
    at k0..k0+tk-1 that the mask keeps: j <= i when ``causal``, i - j <
    window when ``window``."""
    i = np.arange(q0, q0 + tq, dtype=np.int64)
    hi = np.minimum(i, k0 + tk - 1) if causal else np.full_like(i, k0 + tk - 1)
    lo = np.maximum(i - window + 1, k0) if window else np.full_like(i, k0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def scored_pairs(t: int, window: int, banded: bool) -> int:
    """The (query, key) pairs ``models/attention.py:attend`` scores in a
    causal self-attention over t positions: every one, but for the
    ``banded`` option's ``Q_CHUNK + window`` keys a query chunk."""
    band = Q_CHUNK + window
    if t <= CHUNK_THRESHOLD or not (banded and window and t > band):
        return t * t
    return sum(min(Q_CHUNK, t - q0) * band for q0 in range(0, t, Q_CHUNK))


def masked_attention_flops(setup) -> float:
    """The products of the step's causal self-attention blocks over the
    (query, key) pairs their mask drops: what the plain versions compute
    and the flash kernel skips.  For each layer, (scored - kept) pairs at
    2 H (d_qk + d_v) FLOPs a sequence, times its passes: 1 in a prefill, 3
    in a train step (a backward of two products for each forward one), 4
    in a layer that remat runs again.  A non-causal block (the audio
    encoder's, the cross-attention) keeps every pair, and a decode step
    scores its one query over the valid slots alone."""
    cfg, shape = setup.cfg, setup.shape
    if shape.kind == "decode" or cfg.family == "ssm":
        return 0.0
    if cfg.mla:
        m = cfg.mla
        per_pair = 2 * cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim + m.v_head_dim)
    else:
        per_pair = 4 * cfg.n_heads * cfg.hd()
    window = 0 if cfg.enc_layers else cfg.sliding_window    # the audio decoder's is unbounded
    banded, T = cfg.opt_banded_window, shape.seq_len

    def dropped(t, w, scored):
        return scored - band_pairs(0, t, 0, t, window=w)

    if shape.kind == "prefill":       # GQA through the plain flash version, MLA through attend
        n_seq = setup.args[1]["tokens"].shape[0]
        scored = scored_pairs(T, window, banded) if cfg.mla else T * T
        return float(per_pair * n_seq * cfg.n_layers * dropped(T, window, scored))
    n_seq = math.prod(setup.args[1].data["tokens"].shape[:3])       # C x K x B
    passes = 4 if cfg.remat == "full" else 3
    total = passes * cfg.n_layers * dropped(T, window, scored_pairs(T, window, banded))
    if cfg.mtp and T >= 2:            # the MTP block: positions 0..T-2, no window, no remat
        total += 3 * dropped(T - 1, 0, scored_pairs(T - 1, 0, banded))
    return float(per_pair * n_seq * total)


def attention_split(setup, mesh) -> int:
    """The ranks among which a step on ``mesh`` splits its attention: the
    data ranks when its sequences (a vmapped cohort's clients, a
    sequential or serving batch) divide among them, times the model ranks
    when the heads do, the KV heads too (else ``models/attention.py``
    gathers the heads, and every model rank attends over all of them)."""
    from ..dist.sharding import axis_sizes

    cfg, shape = setup.cfg, setup.shape
    if shape.kind == "decode":
        return 1                  # no masked products to share
    tp = axis_sizes(mesh)["model"]
    kv = cfg.n_heads if cfg.mla else cfg.n_kv_heads
    heads = tp if cfg.n_heads % tp == 0 and kv % tp == 0 else 1
    if shape.kind == "prefill":
        n = setup.args[1]["tokens"].shape[0]
    else:
        dims = setup.args[1].data["tokens"].shape
        vmapped = setup.in_shardings[1].data["tokens"][0] is not None
        n = dims[0] if vmapped else dims[2]
    dpn = dp_size(mesh)
    return (dpn if n % dpn == 0 else 1) * heads


def count_step(setup, mesh=None) -> dict:
    """Run ``setup.fn(*setup.args)`` once under the counts -> the record's
    ``cost`` and ``memory`` (and with ``mesh``, one rank's share of them
    and ``collectives``)."""
    if mesh is not None:
        return _count_step_mesh(setup, mesh)
    count = _Count()
    with FlopCounterMode(display=False) as fc, count:
        out = setup.fn(*setup.args)
    flops = float(fc.get_total_flops())
    masked = masked_attention_flops(setup)
    return _record(setup, out, flops, masked, count.bytes_unfused)


def _count_step_mesh(setup, mesh) -> dict:
    count = LocalCount()
    with count:
        out = setup.fn(*setup.args)
    split = attention_split(setup, mesh)
    rec = _record(setup, out, float(count.flops), masked_attention_flops(setup) / split,
                  count.bytes_unfused)
    rec["cost"]["attention_split"] = split
    coll = dict(count.collectives)
    coll["total_bytes"] = sum(v["bytes"] for v in count.collectives.values())
    rec["collectives"] = coll
    return rec


def _record(setup, out, flops: float, masked: float, bytes_unfused: int) -> dict:
    arg_bytes, keys = storage_bytes(setup.args)
    out_bytes, _ = storage_bytes(out, skip=keys)
    return {
        "cost": {"flops": flops,
                 "flops_kernel": flops - masked, "attention_flops_masked": masked,
                 "bytes_min": float(arg_bytes + out_bytes),
                 "bytes_unfused": float(bytes_unfused)},
        "memory": {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": None,
                   "note": "no temp count on meta: arguments and outputs alone"},
    }


def run_one(arch_name: str, shape_name: str, *, out_dir: str = OUT_DIR,
            setup_kwargs: dict | None = None, tag: str = "", cfg: ArchConfig | None = None,
            dp: int = PRODUCTION_DP, batch: int | None = None, n_layers: int | None = None,
            mesh: str | None = None) -> dict:
    """Count ``arch_name`` (or ``cfg``, a resolved config of it) at
    ``shape_name``, write the record to ``out_dir`` and return it.
    ``mesh`` ("16x16" or "2x16x16") counts one rank's share of the setup
    laid out on that production mesh (a train setup then takes its
    clients from the mesh, not from ``dp``)."""
    cfg = cfg if cfg is not None else get_arch(arch_name)
    shape = get_shape(shape_name)
    if mesh is not None and mesh not in PRODUCTION_MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; have {sorted(PRODUCTION_MESHES)}")
    mesh_label = mesh or CARD_MESH
    label = f"{arch_name}/{shape_name}/{mesh_label}{('/' + tag) if tag else ''}"
    rec: dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_label,
                 "chips": math.prod(PRODUCTION_MESHES[mesh][0]) if mesh else 1,
                 "multi_pod": mesh == "2x16x16", "tag": tag, "ok": False, "note": "",
                 "setup": {"dp": dp if mesh is None else None, "batch": batch,
                           "n_layers": n_layers, **(setup_kwargs or {})}}
    t0 = time.time()
    try:
        dm = make_production_mesh(multi_pod=mesh == "2x16x16") if mesh else None
        kw = dict(device="meta", backend="ref", batch=batch, n_layers=n_layers,
                  **(setup_kwargs or {}))
        if shape.kind == "train" and dm is None:
            kw["dp"] = dp
        setup = make_setup(cfg, shape, mesh=dm, **kw)
        rec["setup_s"] = round(time.time() - t0, 2)
        rec["reduced"] = setup.reduced
        rec["inert"] = setup.inert
        t1 = time.time()
        rec.update(count_step(setup, dm))
        rec["count_s"] = round(time.time() - t1, 2)
        if dm is None:
            rec["collectives"] = {"total_bytes": 0, "reason": "one card"}
        rec["ok"] = True
        log(f"dryrun OK {label}", count_s=rec["count_s"],
            gflops=round(rec["cost"]["flops"] / 1e9, 1),
            gflops_kernel=round(rec["cost"]["flops_kernel"] / 1e9, 1),
            gb_min=round(rec["cost"]["bytes_min"] / 1e9, 2),
            coll_mb=round(rec["collectives"]["total_bytes"] / 2**20, 1))
    except Exception as e:  # record failures: they are bugs to fix
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        log(f"dryrun FAIL {label}: {rec['error'][:200]}")
    rec["total_s"] = round(time.time() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch_name}_{shape_name}_{mesh_label}{('_' + tag) if tag else ''}.json"
    with open(os.path.join(out_dir, fname.replace("/", "-")), "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--archs", default=None, help="comma list (with --all)")
    ap.add_argument("--shapes", default=None, help="comma list (with --all)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default=None, choices=sorted(PRODUCTION_MESHES),
                    help="count one rank's share on this production mesh")
    args = ap.parse_args(argv)

    if args.all:
        archs = args.archs.split(",") if args.archs else ASSIGNED
        shapes = args.shapes.split(",") if args.shapes else list(INPUT_SHAPES)
        combos = [(a, s) for a in archs for s in shapes]
    else:
        if not (args.arch and args.shape):
            ap.error("need --arch and --shape (or --all)")
        combos = [(args.arch, args.shape)]
    n_ok = n_fail = 0
    for a, s in combos:
        rec = run_one(a, s, out_dir=args.out, tag=args.tag, mesh=args.mesh)
        n_ok += rec["ok"]
        n_fail += not rec["ok"]
    log(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
