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
- ``collectives``: none, one card; the JAX package's ``collective_stats``
  parses HLO text, which the port does not make.

``models/_flags.py`` of the JAX package (``UNROLL_INNER``, and the
``--unroll`` flag) exists because XLA counts a scan body once; the eager
count sees every launch, so the port has neither.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--archs a,b] [--shapes x,y]

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
from torch.utils.flop_counter import FlopCounterMode

from ..configs.base import INPUT_SHAPES, ArchConfig
from ..configs.registry import ASSIGNED, get_arch, get_shape
from ..models.attention import CHUNK_THRESHOLD, Q_CHUNK
from ..utils.logging import log
from .specs import make_setup

OUT_DIR = "build/dryrun"
CARD_MESH = "1xH100"
PRODUCTION_DP = 16     # the clients of a train setup: the JAX package's mesh's data axis


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


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


def count_step(setup) -> dict:
    """Run ``setup.fn(*setup.args)`` once under the counts -> the record's
    ``cost`` and ``memory``."""
    count = _Count()
    with FlopCounterMode(display=False) as fc, count:
        out = setup.fn(*setup.args)
    flops = float(fc.get_total_flops())
    masked = masked_attention_flops(setup)
    arg_bytes, keys = storage_bytes(setup.args)
    out_bytes, _ = storage_bytes(out, skip=keys)
    return {
        "cost": {"flops": flops,
                 "flops_kernel": flops - masked, "attention_flops_masked": masked,
                 "bytes_min": float(arg_bytes + out_bytes),
                 "bytes_unfused": float(count.bytes_unfused)},
        "memory": {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": None,
                   "note": "no temp count on meta: arguments and outputs alone"},
    }


def run_one(arch_name: str, shape_name: str, *, out_dir: str = OUT_DIR,
            setup_kwargs: dict | None = None, tag: str = "", cfg: ArchConfig | None = None,
            dp: int = PRODUCTION_DP, batch: int | None = None, n_layers: int | None = None,
            inert: list | None = None, note: str = "") -> dict:
    """Count ``arch_name`` (or ``cfg``, a resolved config of it) at
    ``shape_name``, write the record to ``out_dir`` and return it.
    ``inert`` names levers that act on a mesh alone and ``note`` says what
    that means for the count (the hillclimb's)."""
    cfg = cfg if cfg is not None else get_arch(arch_name)
    shape = get_shape(shape_name)
    label = f"{arch_name}/{shape_name}/{CARD_MESH}{('/' + tag) if tag else ''}"
    rec: dict = {"arch": arch_name, "shape": shape_name, "mesh": CARD_MESH, "chips": 1,
                 "multi_pod": False, "tag": tag, "ok": False, "note": note,
                 "setup": {"dp": dp, "batch": batch, "n_layers": n_layers,
                           **(setup_kwargs or {})}}
    t0 = time.time()
    try:
        kw = dict(device="meta", backend="ref", batch=batch, n_layers=n_layers,
                  **(setup_kwargs or {}))
        if shape.kind == "train":
            kw["dp"] = dp
        setup = make_setup(cfg, shape, **kw)
        rec["setup_s"] = round(time.time() - t0, 2)
        rec["reduced"] = setup.reduced
        rec["inert"] = setup.inert + list(inert or [])
        t1 = time.time()
        rec.update(count_step(setup))
        rec["count_s"] = round(time.time() - t1, 2)
        rec["collectives"] = {"total_bytes": 0, "reason": "one card"}
        rec["ok"] = True
        log(f"dryrun OK {label}", count_s=rec["count_s"],
            gflops=round(rec["cost"]["flops"] / 1e9, 1),
            gflops_kernel=round(rec["cost"]["flops_kernel"] / 1e9, 1),
            gb_min=round(rec["cost"]["bytes_min"] / 1e9, 2))
    except Exception as e:  # record failures: they are bugs to fix
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        log(f"dryrun FAIL {label}: {rec['error'][:200]}")
    rec["total_s"] = round(time.time() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch_name}_{shape_name}_{CARD_MESH}{('_' + tag) if tag else ''}.json"
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
        rec = run_one(a, s, out_dir=args.out, tag=args.tag)
        n_ok += rec["ok"]
        n_fail += not rec["ok"]
    log(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
