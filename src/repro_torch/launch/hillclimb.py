"""Perf hillclimb runner (the port of ``repro.launch.hillclimb``): counts
the tagged optimization variants of the three chosen (arch x shape) pairs
with ``dryrun.run_one`` and records them as tagged dry-run records.  Each
variant is an ArchConfig override set (and setup keywords under
``"__setup__"``), resolved by ``_resolve`` and passed to ``run_one``.

Some levers act on a TPU mesh alone (``opt_seq_shard``, the prefill's
``seq_over_model``): on one card they change nothing, so an iteration
that pulls only such levers counts the same as its baseline; its record
lists them under ``inert`` and says so under ``note``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair hymba
"""
from __future__ import annotations

import argparse
import dataclasses

from ..configs.registry import get_arch
from ..utils.logging import log

# pair -> (arch, shape, [(tag, overrides, hypothesis)]), the JAX package's
PAIRS = {
    # worst roofline fraction: memory term 5.7s, temp 2.1 TiB/dev at baseline
    "hymba": ("hymba-1.5b", "train_4k", [
        ("it1-banded", {"opt_banded_window": True},
         "windowed scores vs full T dominate bytes; banding cuts them ~Tk/band=3.2x"),
        ("it2-remat", {"opt_banded_window": True, "remat": "full"},
         "per-layer bwd residuals dominate temp; remat trades ~1.3x flops for >10x temp"),
        ("it3-xent", {"opt_banded_window": True, "remat": "full", "opt_onehot_xent": True},
         "fp32 logit gather all-gathers [B,S,V]; one-hot contraction stays sharded"),
    ]),
    # the paper's own regime at flagship scale: sequential FSDP federated round
    "qwen2": ("qwen2-72b", "train_4k", [
        ("it1-xent", {"opt_onehot_xent": True},
         "CE picked-logit gather over tp-sharded 152k vocab all-gathers fp32 logits"),
        ("it2-seqshard", {"opt_onehot_xent": True, "opt_seq_shard": True},
         "residual-stream all-reduces -> RS+AG at half volume (sequence parallel)"),
        ("it3-bf16acc", {"opt_onehot_xent": True, "__setup__": {"accum_dtype": "bfloat16"}},
         "the fp32 cohort delta accumulator doubles param-sized HBM traffic; bf16 halves it"),
        ("it4-vmapped", {"__setup__": {"cohort_mode": "vmapped"}},
         "cross-device layout: 16 parallel clients (1 per model-slice) instead of a "
         "4-client FSDP scan — fewer param all-gathers per round at higher residency"),
    ]),
    # most collective-bound baseline: 714ms collective vs 697ms memory
    "deepseek": ("deepseek-v3-671b", "prefill_32k", [
        ("it1-seqshard", {"opt_seq_shard": True},
         "per-layer activation all-reduce of [B,32k,7168] dominates; RS+AG halves it"),
        ("it2-groups", {"opt_seq_shard": True, "moe": "g512"},
         "smaller dispatch groups shrink the [g,E,C] one-hot and its all-to-all"),
        ("it3-groups-only", {"moe": "g512"},
         "it1 was refuted (XLA resharding); retry smaller groups WITHOUT seq-shard"),
        ("it4-capacity", {"moe": "g512cap1"},
         "capacity_factor 1.25->1.0 trims [E,C,D] dispatch tensors and their a2a by 20%"),
        ("it5-seqinput", {"__setup__": {"seq_over_model": True}},
         "shard the 32k token dim over the model axis at the INPUT (not per-layer "
         "constraints): XLA propagates seq-sharding; attention gathers only locally"),
    ]),
}
MESH_ONLY = {"opt_seq_shard", "seq_over_model"}   # levers with nothing to act on one card


def _resolve(arch_name: str, overrides: dict):
    cfg = get_arch(arch_name)
    ov = {k: v for k, v in overrides.items() if k != "__setup__"}
    if ov.get("moe") == "g512":
        ov["moe"] = dataclasses.replace(cfg.moe, group_size=512)
    elif ov.get("moe") == "g512cap1":
        ov["moe"] = dataclasses.replace(cfg.moe, group_size=512, capacity_factor=1.0)
    return dataclasses.replace(cfg, **ov)


def levers(overrides: dict) -> dict:
    """Every lever an iteration pulls, config and setup alike."""
    return {**{k: v for k, v in overrides.items() if k != "__setup__"},
            **overrides.get("__setup__", {})}


def inert_levers(overrides: dict) -> list[str]:
    """The levers of ``overrides`` that act on a mesh alone."""
    return sorted(k for k, v in levers(overrides).items() if k in MESH_ONLY and v)


def note(overrides: dict) -> str:
    """What a record says of its levers that act on a mesh alone."""
    inert = inert_levers(overrides)
    if not inert:
        return ""
    if len(inert) == len(levers(overrides)):
        return f"{', '.join(inert)}: acts on a mesh alone; this count is the baseline's"
    return f"{', '.join(inert)}: acts on a mesh alone and changes nothing in this count"


def main(argv: list[str] | None = None) -> None:
    from . import dryrun

    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", required=True, choices=sorted(PAIRS))
    ap.add_argument("--iter", default=None, help="run only this tag")
    ap.add_argument("--out", default=dryrun.OUT_DIR)
    args = ap.parse_args(argv)

    arch, shape, iters = PAIRS[args.pair]
    for tag, overrides, hypothesis in iters:
        if args.iter and tag != args.iter:
            continue
        log(f"hillclimb {args.pair}/{tag}: {hypothesis}")
        dryrun.run_one(arch, shape, out_dir=args.out, tag=tag, cfg=_resolve(arch, overrides),
                       setup_kwargs=overrides.get("__setup__"),
                       inert=inert_levers(overrides), note=note(overrides))


if __name__ == "__main__":
    main()
