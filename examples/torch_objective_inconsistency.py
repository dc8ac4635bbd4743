"""The paper's §4.1 example on the PyTorch port, end to end: watch FedAvg
converge to the WRONG point while FedShuffle finds the optimum (same data,
same rounds).  The counterpart of ``examples/objective_inconsistency.py``;
it imports only ``repro_torch``.

    PYTHONPATH=src python examples/torch_objective_inconsistency.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.data.federated import FederatedPipeline, Population
from repro_torch.data.tasks import DuplicatedQuadraticTask
from repro_torch.fed.losses import make_quadratic_loss
from repro_torch.fed.rounds import build_round_step
from repro_torch.fed.strategy import bind_strategy, strategy_for
from repro_torch.utils.device import resolve_device


def run(task, loss_fn, fl: FLConfig, rounds: int, device) -> np.ndarray:
    pipe = FederatedPipeline(task, Population.build(fl, sizes=task.sizes()), fl)
    strategy = bind_strategy(strategy_for(fl), fl, loss_fn, num_clients=3)
    state = strategy.init({"x": torch.zeros(3, device=device)})
    step = build_round_step(loss_fn, strategy, fl, num_clients=3, device=device)
    for r in range(rounds):
        state, _ = step(state, pipe.round_batch(r))
    return state.params["x"].cpu().numpy()


def report(name: str, x: np.ndarray, task, width: int) -> None:
    err_star = float(np.linalg.norm(x - task.optimum()))
    err_tilde = float(np.linalg.norm(x - task.fedavg_biased_point()))
    print(f"{name:{width}s} -> x = {np.round(x, 4)}   |x-x*|={err_star:.4f}  "
          f"|x-x~|={err_tilde:.4f}")


def main(device=None, rounds: int = 600) -> dict:
    """-> {arm: final x}: the full-participation arms (fedavg, fednova,
    fedshuffle) and the partial-participation ones (fedavg, fedavg+scaffold)."""
    device = resolve_device(device)
    task = DuplicatedQuadraticTask(copies=(1, 2, 3))
    loss_fn = make_quadratic_loss(3)
    print(f"optimum        x* = {np.round(task.optimum(), 4)}")
    print(f"FedAvg's point x~ = {np.round(task.fedavg_biased_point(), 4)}  (Thm E.1)")
    out = {}
    for alg in ("fedavg", "fednova", "fedshuffle"):
        fl = FLConfig(num_clients=3, cohort_size=3, sampling="full", epochs=1,
                      local_batch=1, algorithm=alg, local_lr=0.05, server_opt="sgd")
        out[alg] = run(task, loss_fn, fl, rounds, device)
        report(alg, out[alg], task, 11)

    # Under *client sampling* with multiple local epochs, stateful SCAFFOLD
    # control variates (server_opt="scaffold", a persistent per-client state
    # bank) remove the drift FedAvg converges to.
    print("\npartial participation (2 of 3 clients, 2 local epochs):")
    for name, opt in (("fedavg", "sgd"), ("fedavg+scaffold", "scaffold")):
        fl = FLConfig(num_clients=3, cohort_size=2, sampling="uniform", epochs=2,
                      local_batch=1, algorithm="fedavg", local_lr=0.05,
                      server_opt=opt, seed=3)
        out[f"partial/{name}"] = run(task, loss_fn, fl, rounds, device)
        report(name, out[f"partial/{name}"], task, 15)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
