"""Where the quickstart's training on a card parts from the CPU's.

``examples/torch_quickstart.py`` trains CHARLM_TINY with FedShuffle and the
MVR server step (local and server step 1.0) from the same weights and data
on every device.  This script runs its training part, round by round with
the held-out loss and the weights read after each round, in these arms:

* ``cpu``: the CPU (the server step's plain version);
* ``cpu_ulp``: the CPU from weights nudged by one ulp each (``nextafter``),
  to show how far one rounding error carries over the rounds;
* ``cuda_kernel``: the card, as the example runs (the fused ``server_update``
  kernel), each of the kernel's calls also held against the plain version
  on the same inputs;
* ``cuda_plain``: the card with the plain server step in place of the
  kernel.

TF32 is off on the card.  For each arm it prints each round's local and
held-out loss and the weights' distance from the ``cpu`` arm's (the largest
of each leaf's max |difference| over its max |value|), the first round at
which that distance passes 1e-6, 1e-3 and 1e-1, and the two card arms'
largest distance from each other.

    PYTHONPATH=src python examples/torch_quickstart_split.py [--rounds 30] [--cpu-only]
"""
import argparse
import importlib.util
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.fed import strategy as fed_strategy
from repro_torch.fed.losses import make_loss
from repro_torch.fed.train_loop import train
from repro_torch.kernels.server_update import ops as su_ops
from repro_torch.kernels.server_update.ref import server_update_torch

THRESHOLDS = (1e-6, 1e-3, 1e-1)


def _quickstart():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_quickstart.py")
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain_update(params, delta, momentum, *, eta_g, a, inv_eta_l):
    """The server step's plain version, tensor by tensor, on any device."""
    out = {k: server_update_torch(x, delta[k].to(x.dtype).contiguous(), momentum[k], eta_g, a,
                                  inv_eta_l) for k, x in params.items()}
    return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}


def _checked_update(errs: list):
    """The kernel, each call also held against the plain version on the
    same inputs: appends the call's max |x' difference| and max |m'
    difference| to ``errs``."""
    def update(params, delta, momentum, *, eta_g, a, inv_eta_l):
        x, m = su_ops.apply_fused_update(params, delta, momentum, eta_g=eta_g, a=a,
                                         inv_eta_l=inv_eta_l)
        xr, mr = _plain_update(params, delta, momentum, eta_g=eta_g, a=a, inv_eta_l=inv_eta_l)
        errs.append((max(float((x[k] - xr[k]).abs().max()) for k in x),
                     max(float((m[k] - mr[k]).abs().max()) for k in m)))
        return x, m
    return update


def run_arm(qs, device: str, rounds: int, *, nudge: bool = False, update=None) -> dict:
    """The quickstart's training on ``device`` -> per round: local loss,
    held-out loss and the weights (on the CPU)."""
    fl, task, pipeline, model, params = qs.federation(device)
    if nudge:
        params = {k: torch.nextafter(v, torch.full_like(v, float("inf")))
                  for k, v in params.items()}
    snaps = []

    def eval_fn(p):
        snaps.append({k: v.detach().float().cpu() for k, v in p.items()})
        return {"heldout": qs.heldout_loss(model, task, fl, p, device)}

    saved = fed_strategy.apply_fused_update
    fed_strategy.apply_fused_update = update or saved
    try:
        res = train(make_loss(model), params, pipeline, fl, rounds=rounds, name="split",
                    log_every=0, eval_fn=eval_fn, eval_every=1, device=device)
    finally:
        fed_strategy.apply_fused_update = saved
    rows = res.metrics.rows
    heldout = [r.get("eval_heldout", r.get("heldout")) for r in rows]
    return {"local": [float(r["local_loss"]) for r in rows], "heldout": heldout,
            "snaps": snaps[-rounds:],
            "heldout_final": qs.heldout_loss(model, task, fl, res.state.params, device)}


def distance(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30)) for k in b)


def main(rounds: int = 30, cpu_only: bool = False, out: str | None = None) -> dict:
    qs = _quickstart()
    arms = {"cpu": run_arm(qs, "cpu", rounds), "cpu_ulp": run_arm(qs, "cpu", rounds, nudge=True)}
    errs: list = []
    if not cpu_only:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        arms["cuda_kernel"] = run_arm(qs, "cuda", rounds, update=_checked_update(errs))
        arms["cuda_plain"] = run_arm(qs, "cuda", rounds, update=_plain_update)
    ref = arms["cpu"]["snaps"]
    report = {"rounds": rounds}
    for name, arm in arms.items():
        dist = [distance(s, r) for s, r in zip(arm["snaps"], ref)]
        first = {str(t): next((i + 1 for i, d in enumerate(dist) if d > t), None)
                 for t in THRESHOLDS}
        report[name] = {"local": arm["local"], "heldout": arm["heldout"], "distance": dist,
                        "first_round_over": first, "heldout_final": arm["heldout_final"]}
        print(f"{name}: held-out loss after {rounds} rounds {arm['heldout_final']:.4f}; weights "
              f"first over {', '.join(f'{t} at round {r}' for t, r in first.items())}",
              flush=True)
        for i, (lo, he, d) in enumerate(zip(arm["local"], arm["heldout"], dist)):
            print(f"  round {i + 1}: local {lo:.6f} held-out {he:.6f} distance {d:.3e}",
                  flush=True)
    if errs:
        arm_dist = max(distance(a, b) for a, b in zip(arms["cuda_kernel"]["snaps"],
                                                      arms["cuda_plain"]["snaps"]))
        report["kernel_vs_plain"] = {"calls": len(errs), "max_x_err": max(e[0] for e in errs),
                                     "max_m_err": max(e[1] for e in errs),
                                     "arms_max_distance": arm_dist}
        print(f"server_update kernel vs plain over {len(errs)} calls: max |x' diff| "
              f"{report['kernel_vs_plain']['max_x_err']:.3e}, max |m' diff| "
              f"{report['kernel_vs_plain']['max_m_err']:.3e}; cuda_kernel vs cuda_plain arm, "
              f"weights' largest distance over the rounds {arm_dist:.3e}", flush=True)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--cpu-only", action="store_true")
    ap.add_argument("--out", default=None, help="write the report as JSON here")
    args = ap.parse_args()
    main(args.rounds, args.cpu_only, args.out)
