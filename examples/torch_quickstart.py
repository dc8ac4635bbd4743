"""Quickstart on the PyTorch port: federated-train a tiny char-LM with
FedShuffle, then serve it — and register a custom client transform
(per-step update clipping) plus a traced, instrumented run
(``fl.telemetry``) to show the observability plane.  The counterpart of
``examples/quickstart.py``; it imports only ``repro_torch``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.configs.paper_tasks import CHARLM_TINY
from repro_torch.data.federated import FederatedPipeline, Population
from repro_torch.data.tasks import CharLMTask
from repro_torch.fed import (ClientChain, ClientTransform, register_client_transform,
                             register_local_update)
from repro_torch.fed.losses import make_loss
from repro_torch.fed.train_loop import train
from repro_torch.launch.serve import generate
from repro_torch.models.model import build_model
from repro_torch.utils.device import resolve_device


def make_demo_clip(loss_fn, fl_cfg):
    """Clip each local step's fp32 descent direction to a global-norm bound
    (each cohort slot by its own norm in the vmapped mode)."""
    limit = 0.5

    def update(step, d, carry, cstate):
        cohort = step.mask.dim() > 0
        sq = [torch.sum(x * x, dim=tuple(range(1, x.dim())) if cohort else None)
              for x in d.values()]
        nrm = torch.sqrt(sum(sq))
        scale = torch.clamp_max(limit / torch.clamp_min(nrm, 1e-12), 1.0)
        return {n: x * (scale.view(-1, *([1] * (x.dim() - 1))) if cohort else scale)
                for n, x in d.items()}, carry

    return ClientTransform(name="demo_clip", init=lambda p: {}, update=update)


def federation(device) -> tuple:
    """The example's FL config, task, pipeline, model and initial weights
    on ``device`` -> (fl, task, pipeline, model, params)."""
    # 1. an imbalanced federated population (log-normal |D_i|) with
    #    client-skewed char distributions — the paper's regime
    fl = FLConfig(
        num_clients=8, cohort_size=4, sampling="uniform",   # partial participation
        epochs=2, local_batch=2,                            # local RR epochs
        algorithm="fedshuffle",                             # the paper's recipe
        local_lr=1.0, server_lr=1.0, server_opt="mvr",      # + practical MVR momentum
        imbalance="lognormal", mean_samples=6, seed=0,
    )
    task = CharLMTask(vocab=CHARLM_TINY.vocab, seq_len=32, num_clients=fl.num_clients)
    pipeline = FederatedPipeline(task, Population.build(fl), fl)
    model = build_model(CHARLM_TINY)
    # drawn on the CPU so that every device starts from the same weights (a
    # CUDA generator draws others)
    params = {k: v.to(device) for k, v in model.init(0, "cpu").items()}
    return fl, task, pipeline, model, params


def heldout_loss(model, task, fl, params, device) -> float:
    """The mean loss over 8 held-out sequences of every client."""
    with torch.no_grad():
        return float(np.mean([float(model.loss(params, {"tokens": torch.as_tensor(
            task.batch(c, task.heldout_ids(c, 8))["tokens"], device=device)})[0])
            for c in range(fl.num_clients)]))


def main(device=None, rounds: int = 30, clip_rounds: int = 5, traced_rounds: int = 5,
         trace_path: str = "quickstart_trace.json") -> dict:
    device = resolve_device(device)
    fl, task, pipeline, model, params = federation(device)
    sizes = pipeline.population.sizes.tolist()
    print(f"client dataset sizes: {sizes}")

    # 2. federated training
    result = train(make_loss(model), params, pipeline, fl, rounds=rounds,
                   name="quickstart", log_every=10, device=device)
    losses = [float(r["local_loss"]) for r in result.metrics.rows]

    heldout = tuple(heldout_loss(model, task, fl, p, device)
                    for p in (params, result.state.params))
    print(f"held-out loss: {heldout[0]:.4f} before training, {heldout[1]:.4f} after")

    # 3. serve the trained global model (prefill + autoregressive decode)
    prompts = torch.zeros((2, 8), dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    out = generate(model, result.state.params, prompts, steps=12, cache_len=24,
                   temperature=0.8, generator=gen)
    print("generated:", out.tolist())

    # 4. custom client transform: clip each local step's fp32 descent
    #    direction to a global-norm bound, then register the chain as a new
    #    local-update rule selectable via FLConfig.local_update.  (The
    #    built-in "local_clip" rule does the same via fl.clip_norm; this
    #    shows the extension API the built-ins are made of.)
    register_client_transform("demo_clip", make_demo_clip, overwrite=True)
    register_local_update("sgd_demo_clip", ClientChain("sgd_demo_clip", ("demo_clip",)),
                          overwrite=True)
    fl_clip = dataclasses.replace(fl, server_opt="sgd", local_update="sgd_demo_clip")
    clipped = train(make_loss(model), params,
                    FederatedPipeline(task, Population.build(fl_clip), fl_clip),
                    fl_clip, rounds=clip_rounds, name="quickstart-clip", log_every=1,
                    device=device)
    clip_loss = float(clipped.metrics.rows[-1]["local_loss"])
    print("clipped-chain final local loss:", clip_loss)

    # 5. observability: telemetry="full" adds in-round histograms over the
    #    cohort (steps, update norms) and host round-phase spans; the capture
    #    writes a Perfetto-loadable trace (open it at https://ui.perfetto.dev).
    #    The port has no compiled step, so there is no compile counter.
    fl_obs = dataclasses.replace(fl, telemetry="full")
    with obs.trace.capture(chrome=trace_path):
        traced = train(make_loss(model), params,
                       FederatedPipeline(task, Population.build(fl_obs), fl_obs),
                       fl_obs, rounds=traced_rounds, name="quickstart-traced", log_every=0,
                       device=device)
    snap = traced.registry.snapshot()
    hist = [int(c) for c in snap["histograms"]["hist_steps"]["counts"]]
    print("local-steps histogram (counts per pow2 bin):", hist)
    return {"sizes": sizes, "losses": losses, "heldout": heldout, "generated": out.tolist(),
            "clip_loss": clip_loss, "hist_steps": hist, "trace": trace_path}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
