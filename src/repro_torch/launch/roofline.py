"""Roofline of the dry-run records on NVIDIA H100 cards (the port of
``repro.launch.roofline``).

A one-card record (``launch/dryrun.py`` without ``--mesh``) counts the
whole step of one card; a mesh record (``--mesh 16x16`` or ``2x16x16``)
counts one rank's share of the step laid out on that many cards, with the
collectives DTensor issues on that rank.  So, per card:

    compute term    = flops_kernel / BF16_FLOP_PER_S           [s]
    memory term     = bytes_min / HBM_BYTES_PER_S              [s]
    collective term = collectives.total_bytes / NVLINK_BYTES_PER_S  [s]

with the H100's rates of ``launch/mesh.py``; a one-card record has no
collective bytes.  ``flops_kernel`` takes attention over the pairs the
flash kernel computes and ``bytes_min`` reads each argument and writes
each output once: those two terms are floors.  The collective bytes are
each collective's result (the JAX package's proxy) as DTensor issues it
over NCCL (a shard-to-shard move as one all-to-all, ``dryrun.py``), over
one NVLink direction, the fastest link a card has.  That term is a floor on the time
of the collectives this layout issues to within n / (n - 1) (1.07 at n =
16 ranks): a rank receives at least (n - 1) / n of an all-gather's, an
all-to-all's or an all-reduce's result, and a reduce-scatter's result is
less than what it receives.  It is no floor on a better layout.  The
largest term is the step's bound.

MODEL_FLOPS uses the 6*N*D (train) / 2*N*D (inference) rule with N = active
parameters (``param_counts``: MoE shared + top_k/E of routed), D = tokens a
step processes (``tokens_for``); ``useful_ratio`` = MODEL_FLOPS / (flops x
chips) (> 1: the step does less than the rule, e.g. a 1-token decode where
attention dominates; < 1: recompute, aux compute, or work a mesh repeats
on several ranks).  A record cut from its shape or config (``reduced``)
has no ratio.

``param_counts`` builds the params of the full-size config on the meta
device (shapes alone, no allocation); its active count takes the routed
experts (every leaf under ``/experts/``) at ``top_k / num_experts``, the
JAX package's rule.

  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir build/dryrun]
"""
from __future__ import annotations

import argparse
import functools
import glob
import json
import os

from ..configs.base import INPUT_SHAPES
from ..configs.registry import get_arch
from .mesh import BF16_FLOP_PER_S, CARD, HBM_BYTES_PER_S, NVLINK_BYTES_PER_S


@functools.cache
def param_counts(arch_name: str) -> tuple[int, int]:
    """(total, active) parameter counts of ``arch_name`` at full size."""
    from ..models.model import build_model

    cfg = get_arch(arch_name)
    shapes = build_model(cfg).init(0, "meta")
    total = sum(v.numel() for v in shapes.values())
    active = total
    if cfg.moe is not None:
        expert = sum(v.numel() for k, v in shapes.items() if "/experts/" in k)
        active = total - expert + int(expert * cfg.moe.top_k / cfg.moe.num_experts)
    return total, active


def tokens_for(shape_name: str) -> int:
    """Tokens a lowered step of ``shape_name`` processes: batch x sequence
    for a train or prefill shape, one a sequence for a decode shape."""
    s = INPUT_SHAPES[shape_name]
    if s.kind in ("train", "prefill"):
        return s.global_batch * s.seq_len
    return s.global_batch


def analyze_record(rec: dict) -> dict | None:
    if not rec.get("ok"):
        return None
    cost = rec["cost"]
    t_compute = cost["flops_kernel"] / BF16_FLOP_PER_S
    t_memory = cost["bytes_min"] / HBM_BYTES_PER_S
    coll = rec.get("collectives", {}).get("total_bytes", 0)
    t_coll = coll / NVLINK_BYTES_PER_S
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    chips = rec.get("chips", 1)
    total, active = param_counts(rec["arch"])
    shape = INPUT_SHAPES[rec["shape"]]
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * active * tokens_for(rec["shape"])
    flops = cost["flops"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "tag": rec.get("tag", ""),
        "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory, "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(terms.values()),
        "flops": flops, "flops_kernel": cost["flops_kernel"],
        "bytes_min": cost["bytes_min"], "bytes_unfused": cost.get("bytes_unfused", 0.0),
        "coll_bytes": coll,
        "arg_bytes": rec.get("memory", {}).get("argument_size_in_bytes", 0),
        "params_total": total, "params_active": active,
        "model_flops": model_flops,
        "useful_ratio": None if rec.get("reduced") else
        (model_flops / (flops * chips) if flops else 0.0),
        "reduced": rec.get("reduced", []), "inert": rec.get("inert", []),
    }


def load_all(dirpath: str, prefer_tag: str = "unrolled") -> list[dict]:
    """One row per (arch, shape, mesh); a record tagged ``prefer_tag``
    replaces the untagged one (the JAX package's rule, kept for records
    merged from either); every other tag (the hillclimb's iterations) is a
    row of its own."""
    by_key: dict = {}
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        a = analyze_record(rec)
        if not a:
            continue
        tag = a.get("tag", "")
        a["exact"] = tag == prefer_tag
        if tag in ("", prefer_tag):
            a["tag"] = ""  # the baseline row
            key = (a["arch"], a["shape"], a["mesh"])
            prev = by_key.get(key)
            if prev is None or (a["exact"] and not prev["exact"]):
                by_key[key] = a
        else:  # hillclimb iterations etc. stay as separate rows
            by_key[(a["arch"], a["shape"], a["mesh"], tag)] = a
    return sorted(by_key.values(),
                  key=lambda r: (r["arch"], r["shape"], r["mesh"], r.get("tag", "")))


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def markdown_table(rows: list[dict]) -> str:
    head = (f"Roofline per card, {CARD}: compute = flops_kernel / {BF16_FLOP_PER_S:.4g} "
            f"FLOP/s (dense bf16), memory = bytes_min / {HBM_BYTES_PER_S:.4g} B/s (HBM3), "
            f"collective = collective bytes / {NVLINK_BYTES_PER_S:.4g} B/s (NVLink 4, one "
            f"way; a floor across nodes).  A mesh row is one rank's share.")
    hdr = ("| arch | shape | mesh | compute | memory | collective | dominant | "
           "useful (6ND or 2ND / flops x chips) | GFLOP | GB min | GB coll |")
    sep = "|" + "---|" * 11
    lines = [head, "", hdr, sep]
    for r in rows:
        tag = r.get("tag", "")
        ratio = "-" if r["useful_ratio"] is None else f"{r['useful_ratio']:.2f}"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']}{('/'+tag) if tag else ''} | "
            f"{fmt_s(r['t_compute_s'])} | {fmt_s(r['t_memory_s'])} | "
            f"{fmt_s(r['t_collective_s'])} | **{r['dominant']}** | {ratio} | "
            f"{r['flops'] / 1e9:.1f} | {r['bytes_min'] / 1e9:.2f} | {r['coll_bytes'] / 1e9:.2f} |"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    from .dryrun import OUT_DIR

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--json", default=None, help="also dump analyzed rows")
    args = ap.parse_args(argv)
    rows = load_all(args.dir)
    print(markdown_table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)


if __name__ == "__main__":
    main()
