"""Federated training launcher: the e2e ~100M-param char-LM.

Runs ``--config charlm_e2e``: CharLM-100M (12 x 768, d_ff 3072, vocab 512)
over 32 log-normally imbalanced clients, 8 per round, ``local_batch=4``,
``seq_len=128``, the sequential cohort mode, random weights from a seed.
Any ``FLConfig`` field can be overridden, e.g. the cohort engine with the
CUDA index kernel and a qsgd-compressed uplink (the CUDA quantize kernels)::

  PYTHONPATH=src python -m repro_torch.launch.train --config charlm_e2e \\
      --rounds 4 --engine cohort --rr-backend device --prefetch 0 --uplink qsgd

FedShuffleMVR is ``--server-opt mvr`` (the App. F server step, the CUDA
``server_update`` kernel); the exact eq. 14 step, the downlink codec and the
quantize backend go through ``run_charlm_e2e(..., mvr_exact=True)``,
``downlink="qsgd"``, ``uplink_backend="ref"``.  The bucketed execution
layout (each step bucket's occupied rows for its K_b steps, instead of every
slot for K_max masked steps) is ``--exec-mode bucketed [--buckets 4]`` or
``run_charlm_e2e(..., exec_mode="bucketed", buckets=4)``.
``--checkpoint PATH`` saves the params in the JAX package's format every
100 rounds and at the end (``serve --checkpoint`` and JAX's
``load_checkpoint`` read it).  Runs on ``cuda`` unless ``--device cpu`` is
given.  The port's counterpart of ``repro.launch.train``; ``--arch`` /
``--smoke`` (the model zoo) are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs.base import ArchConfig, FLConfig
from ..configs.paper_tasks import CHARLM_100M
from ..data.federated import FederatedPipeline, Population
from ..data.tasks import CharLMTask
from ..fed.losses import make_loss
from ..fed.train_loop import TrainResult, train
from ..models.model import build_model
from ..utils.device import resolve_device
from ..utils.logging import log
from ..utils.pytree import tree_count_params


def charlm_e2e_config(algorithm: str = "fedshuffle", server_opt: str = "sgd",
                      **fl_overrides) -> tuple[ArchConfig, FLConfig]:
    """The e2e run's model (CharLM-100M at vocab 512) and FL configuration;
    ``fl_overrides`` replace fields of the ``FLConfig``."""
    cfg = dataclasses.replace(CHARLM_100M, vocab=min(CHARLM_100M.vocab, 512))
    fl = FLConfig(num_clients=32, cohort_size=8, sampling="uniform", epochs=1,
                  local_batch=4, algorithm=algorithm, local_lr=0.05,
                  server_opt=server_opt, imbalance="lognormal", mean_samples=8,
                  cohort_mode="sequential", seed=1)
    return cfg, dataclasses.replace(fl, **fl_overrides)


def run_charlm_e2e(rounds: int, algorithm: str = "fedshuffle", server_opt: str = "sgd", *,
                   device=None, checkpoint: str | None = None,
                   **fl_overrides) -> TrainResult:
    """The e2e driver: ~100M-param char-LM, heterogeneous clients, random
    weights from seed 0.  ``fl_overrides`` replace fields of the run's
    ``FLConfig``; ``checkpoint`` saves the params every 100 rounds and at
    the end."""
    device = resolve_device(device)
    cfg, fl = charlm_e2e_config(algorithm, server_opt, **fl_overrides)
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
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--algorithm", default="fedshuffle")
    ap.add_argument("--server-opt", default="sgd")
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
    overrides = {k: v for k, v in (("engine", args.engine), ("rr_backend", args.rr_backend),
                                   ("prefetch", args.prefetch), ("uplink", args.uplink),
                                   ("exec_mode", args.exec_mode), ("buckets", args.buckets))
                 if v is not None}
    res = run_charlm_e2e(args.rounds, args.algorithm, args.server_opt,
                         device=args.device, checkpoint=args.checkpoint, **overrides)
    print(res.metrics.csv())


if __name__ == "__main__":
    main()
