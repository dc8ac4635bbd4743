"""Federated training launcher: the e2e ~100M-param char-LM, and the smoke
run of an architecture.

Runs ``--config charlm_e2e`` (the default): CharLM-100M (12 x 768, d_ff
3072, vocab 512) over 32 log-normally imbalanced clients, 8 per round,
``local_batch=4``, ``seq_len=128``, the sequential cohort mode, random
weights from a seed.
Any ``FLConfig`` field can be overridden, e.g. the cohort engine with the
CUDA index kernel and a qsgd-compressed uplink (the CUDA quantize kernels)::

  PYTHONPATH=src python -m repro_torch.launch.train --config charlm_e2e \\
      --rounds 4 --engine cohort --rr-backend device --prefetch 0 --uplink qsgd

FedShuffleMVR is ``--server-opt mvr`` (the App. F server step, the CUDA
``server_update`` kernel); SCAFFOLD is ``--server-opt scaffold`` (its
per-client control variates in the client bank), FedAdam ``--server-opt
adam``, and ``run_charlm_e2e(..., local_update="fedprox")`` /
``"local_clip"`` picks the FedProx or the per-step clipping chain (with
``prox_mu`` / ``clip_norm``); the exact eq. 14 step, the downlink codec and the
quantize backend go through ``run_charlm_e2e(..., mvr_exact=True)``,
``downlink="qsgd"``, ``uplink_backend="ref"``.  The bucketed execution
layout (each step bucket's occupied rows for its K_b steps, instead of every
slot for K_max masked steps) is ``--exec-mode bucketed [--buckets 4]`` or
``run_charlm_e2e(..., exec_mode="bucketed", buckets=4)``.
``run_charlm_e2e(..., remat="full")`` recomputes each layer's activations
in the backward pass: less memory, the same bits.
``--checkpoint PATH`` saves the params in the JAX package's format every
100 rounds and at the end (``serve --checkpoint`` and JAX's
``load_checkpoint`` read it).

``--smoke [--arch ID]`` runs the reduced config of an architecture (default
``qwen1.5-0.5b``) over synthetic client-biased token data, 6 clients, 3 a
round, as the JAX package's smoke run does; a vlm arch (``vision-tiny``,
``llava-next-mistral-7b``) adds Gaussian patch embeddings to each sample::

  PYTHONPATH=src python -m repro_torch.launch.train --arch vision-tiny --smoke \\
      --rounds 4 --device cpu

Every family takes it: ``--arch mamba2-1.3b`` (ssm), ``hymba-1.5b``
(hybrid) and ``seamless-m4t-medium`` (audio, Gaussian frame embeddings a
sample) train through the plain attention and SSD scan, and
``deepseek-v2-lite-16b`` and ``deepseek-v3-671b`` (moe: MLA through the
plain attention, the MoE's aux in the loss, V3's MTP term too).
Runs on ``cuda`` unless ``--device cpu`` is given.  The port's counterpart
of ``repro.launch.train``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs.base import ArchConfig, FLConfig
from ..configs.paper_tasks import CHARLM_100M
from ..configs.registry import get_arch
from ..data.federated import FederatedPipeline, Population
from ..data.tasks import CharLMTask, TokenTask
from ..fed.losses import make_loss
from ..fed.train_loop import TrainResult, train
from ..models.model import build_model
from ..utils.device import resolve_device
from ..utils.logging import log
from ..utils.pytree import tree_count_params


def smoke_task_for(cfg: ArchConfig, fl: FLConfig) -> TokenTask:
    """The smoke run's task: client-biased tokens over ``cfg.vocab``, with
    the vlm family's patch or the audio family's frame embeddings."""
    extras = {}
    if cfg.family == "vlm":
        extras["patches"] = (cfg.num_patches, cfg.d_model)
    if cfg.family == "audio":
        extras["frames"] = (cfg.src_frames, cfg.d_model)
    return TokenTask(vocab=cfg.vocab, seq_len=32, num_clients=fl.num_clients,
                     seed=fl.seed, extras=extras)


def run_smoke(arch: str, rounds: int, algorithm: str = "fedshuffle", server_opt: str = "sgd",
              uplink: str = "identity", *, device=None, **fl_overrides) -> TrainResult:
    """The smoke run of ``arch``'s reduced config: 6 clients, 3 a round,
    ``local_batch=2``, random weights from seed 0; ``fl_overrides`` replace
    fields of the run's ``FLConfig``.  The rounds' ``local_loss`` is the
    whole loss (a moe arch's aux and MTP terms included)."""
    cfg = get_arch(arch).reduced()
    device = resolve_device(device)
    fl = FLConfig(num_clients=6, cohort_size=3, sampling="uniform", epochs=1,
                  local_batch=2, algorithm=algorithm, local_lr=0.05,
                  server_opt=server_opt, mean_samples=4, seed=0, uplink=uplink)
    fl = dataclasses.replace(fl, **fl_overrides)
    pipe = FederatedPipeline(smoke_task_for(cfg, fl), Population.build(fl), fl)
    model = build_model(cfg)
    res = train(make_loss(model), model.init(0, device), pipe, fl, rounds,
                name=f"smoke-{arch}", log_every=max(1, rounds // 5), device=device)
    first, last = res.metrics.rows[0]["local_loss"], res.metrics.rows[-1]["local_loss"]
    log(f"smoke {arch}: loss {first:.4f} -> {last:.4f}")
    return res


def charlm_e2e_config(algorithm: str = "fedshuffle", server_opt: str = "sgd", *,
                      remat: str = "none", **fl_overrides) -> tuple[ArchConfig, FLConfig]:
    """The e2e run's model (CharLM-100M at vocab 512, ``remat`` its layers'
    recompute: "none" or "full") and FL configuration; ``fl_overrides``
    replace fields of the ``FLConfig``."""
    cfg = dataclasses.replace(CHARLM_100M, vocab=min(CHARLM_100M.vocab, 512), remat=remat)
    fl = FLConfig(num_clients=32, cohort_size=8, sampling="uniform", epochs=1,
                  local_batch=4, algorithm=algorithm, local_lr=0.05,
                  server_opt=server_opt, imbalance="lognormal", mean_samples=8,
                  cohort_mode="sequential", seed=1)
    return cfg, dataclasses.replace(fl, **fl_overrides)


def run_charlm_e2e(rounds: int, algorithm: str = "fedshuffle", server_opt: str = "sgd", *,
                   device=None, checkpoint: str | None = None, remat: str = "none",
                   **fl_overrides) -> TrainResult:
    """The e2e driver: ~100M-param char-LM, heterogeneous clients, random
    weights from seed 0.  ``fl_overrides`` replace fields of the run's
    ``FLConfig``; ``checkpoint`` saves the params every 100 rounds and at
    the end; ``remat="full"`` recomputes each layer's activations in the
    backward pass (less memory, the same bits)."""
    device = resolve_device(device)
    cfg, fl = charlm_e2e_config(algorithm, server_opt, remat=remat, **fl_overrides)
    task = CharLMTask(vocab=cfg.vocab, seq_len=128, num_clients=fl.num_clients)
    pipe = FederatedPipeline(task, Population.build(fl), fl)
    model = build_model(cfg)
    params = model.init(0, device)
    log(f"charlm e2e: {tree_count_params(params) / 1e6:.1f}M params, {rounds} rounds")

    ev = task.batch(0, np.arange(4).reshape(1, 4))
    eval_batch = {k: torch.as_tensor(v[0], device=device) for k, v in ev.items()}
    loss_fn = make_loss(model)

    @torch.no_grad()
    def eval_fn(p):
        return {"loss": loss_fn(p, eval_batch)[0]}

    return train(loss_fn, params, pipe, fl, rounds, eval_fn=eval_fn, eval_every=20,
                 schedule="staircase", checkpoint_path=checkpoint,
                 checkpoint_every=100 if checkpoint else 0, name="charlm-e2e", log_every=10,
                 device=device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="charlm_e2e", choices=["charlm_e2e"])
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke run of --arch's reduced config instead of --config")
    ap.add_argument("--arch", default=None,
                    help="the smoke run's architecture (default qwen1.5-0.5b)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--algorithm", default="fedshuffle")
    ap.add_argument("--server-opt", default="sgd",
                    help="sgd | momentum | mvr | adam | scaffold")
    ap.add_argument("--engine", default=None, choices=["legacy", "cohort"])
    ap.add_argument("--rr-backend", default=None,
                    choices=["host", "host_feistel", "device_ref", "device"])
    ap.add_argument("--prefetch", type=int, default=None)
    ap.add_argument("--exec-mode", default=None, choices=["padded", "bucketed"])
    ap.add_argument("--buckets", type=int, default=None,
                    help="max step buckets with --exec-mode bucketed (FLConfig default 4)")
    ap.add_argument("--uplink", default="identity",
                    help="uplink codec (repro_torch.fed.comm.CODECS): identity | qsgd | "
                         "topk | randk | ef_qsgd | ef_randk | diana_qsgd | diana_randk | "
                         "diana_topk")
    ap.add_argument("--checkpoint", default=None,
                    help="save the params here (JAX's .npz format) every 100 rounds and at the end")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.arch is not None and not args.smoke:
        ap.error("--arch names the architecture of a --smoke run")
    if args.smoke and args.checkpoint:
        ap.error("--checkpoint saves the charlm_e2e run, not a --smoke run")
    overrides = {k: v for k, v in (("engine", args.engine), ("rr_backend", args.rr_backend),
                                   ("prefetch", args.prefetch), ("uplink", args.uplink),
                                   ("exec_mode", args.exec_mode), ("buckets", args.buckets))
                 if v is not None}
    if args.smoke:
        run_smoke(args.arch or "qwen1.5-0.5b", args.rounds, args.algorithm, args.server_opt,
                  device=args.device, **overrides)
        return
    res = run_charlm_e2e(args.rounds, args.algorithm, args.server_opt,
                         device=args.device, checkpoint=args.checkpoint, **overrides)
    print(res.metrics.csv())


if __name__ == "__main__":
    main()
