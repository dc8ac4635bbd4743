"""Perf hillclimb runner (the port of ``repro.launch.hillclimb``): counts
the tagged optimization variants of the three chosen (arch x shape) pairs
with ``dryrun.run_one`` and records them as tagged dry-run records.  Each
variant is an ArchConfig override set (and setup keywords under
``"__setup__"``), resolved by ``_resolve`` and passed to ``run_one``.

The pairs are counted on the 16 x 16 production mesh, as in the JAX
package (``multi_pod=False``): one rank's share, with its collectives,
where the levers that act on a mesh alone (``opt_seq_shard``, the
prefill's ``seq_over_model``) act.  ``dryrun.py`` without ``--mesh``
counts one card's whole step.

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


def _resolve(arch_name: str, overrides: dict):
    cfg = get_arch(arch_name)
    ov = {k: v for k, v in overrides.items() if k != "__setup__"}
    if ov.get("moe") == "g512":
        ov["moe"] = dataclasses.replace(cfg.moe, group_size=512)
    elif ov.get("moe") == "g512cap1":
        ov["moe"] = dataclasses.replace(cfg.moe, group_size=512, capacity_factor=1.0)
    return dataclasses.replace(cfg, **ov)


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
                       setup_kwargs=overrides.get("__setup__"), mesh="16x16")


if __name__ == "__main__":
    main()
