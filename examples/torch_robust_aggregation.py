"""Byzantine-robust aggregation end to end on the PyTorch port: 20% of the
fleet sign-flips its updates at 10x scale — plain weighted averaging is
pulled far off the optimum (or straight into divergence), while the same
run with ``aggregator="trimmed_mean"`` lands inside the attack-free loss
envelope.  The counterpart of ``examples/robust_aggregation.py``; it
imports only ``repro_torch``.

    PYTHONPATH=src python examples/torch_robust_aggregation.py [--device cpu]
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
from repro_torch.fed.robust import adversary_mask
from repro_torch.fed.rounds import build_round_step
from repro_torch.fed.strategy import bind_strategy, strategy_for
from repro_torch.utils.device import resolve_device

N, ROUNDS, SEED = 10, 400, 2   # seed 2 draws exactly 2/10 adversaries


def run(task, loss_fn, rounds: int, device, **robust_kw):
    fl = FLConfig(num_clients=N, cohort_size=N, sampling="full", epochs=1,
                  local_batch=1, algorithm="fedshuffle", local_lr=0.05,
                  server_opt="sgd", seed=SEED, **robust_kw)
    pipe = FederatedPipeline(task, Population.build(fl, sizes=task.sizes()), fl)
    strategy = bind_strategy(strategy_for(fl), fl, loss_fn, num_clients=N)
    state = strategy.init({"x": torch.zeros(N, device=device)})
    step = build_round_step(loss_fn, strategy, fl, num_clients=N, device=device)
    for r in range(rounds):
        state, mets = step(state, pipe.round_batch(r))
    x = state.params["x"].cpu().numpy()
    diverged = not np.all(np.isfinite(x)) or np.abs(x).max() > 1e6
    return x, float("inf") if diverged else task.loss_np(x), mets


def main(device=None, rounds: int = ROUNDS) -> dict:
    """-> {run: final loss}; raises unless the attack hurts the plain mean
    and trimming recovers the attack-free envelope."""
    device = resolve_device(device)
    task = DuplicatedQuadraticTask(copies=(1,) * N)
    loss_fn = make_quadratic_loss(N)
    adv = torch.nonzero(adversary_mask(SEED, torch.arange(N), 0.2)).flatten()
    print(f"{N} clients, adversaries (sign_flip x10): clients {adv.tolist()}\n")

    attack = dict(attack="sign_flip", attack_frac=0.2, attack_scale=10.0)
    runs = {
        "attack-free     / mean": {},
        "under attack    / mean": attack,
        "under attack    / trimmed_mean": {**attack, "aggregator": "trimmed_mean",
                                           "trim_frac": 0.25},
        "under attack    / coordinate_median": {**attack,
                                                "aggregator": "coordinate_median"},
        "under attack    / mean + quarantine": {**attack, "guard": "full"},
    }
    losses = {}
    for name, kw in runs.items():
        x, losses[name], _ = run(task, loss_fn, rounds, device, **kw)
        dist = float(np.linalg.norm(x - task.optimum()))
        print(f"{name:38s} loss={losses[name]:10.4f}  |x - x*|={dist:8.4f}")

    clean = losses["attack-free     / mean"]
    broken = losses["under attack    / mean"]
    healed = losses["under attack    / trimmed_mean"]
    # the robustness contract this example demonstrates: the attack must
    # actually hurt the plain mean, and trimming must recover the clean envelope
    assert broken > 10.0 * clean, (broken, clean)
    assert healed < 1.5 * clean, (healed, clean)
    print("\ntrimmed_mean recovered the attack-free loss envelope; "
          "plain mean did not.")
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
