#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

1. prints the card's name and power limit, builds the CUDA kernel from
   ``src/repro_torch/csrc/rr_perm.cu``;
2. holds each kernel against its plain PyTorch version on the card and the
   numpy mirror, bitwise, at the main path's shapes and a stress shape, and
   times both;
3. drives the main path through its user entry point: FedShuffle training of
   full-width CharLM-100M (12 x 768, d_ff 3072) for 4 rounds through the
   cohort engine with the CUDA index kernel (``rr_backend="device"``), with
   every launch count set to 0 just before and read just after;
4. checks the result: finite losses, one kernel launch per round, the same
   run with the plain version of the kernel (``rr_backend="device_ref"``)
   giving bitwise-identical parameters, and a CharLM-tiny run on the card
   agreeing with the port on the CPU;
5. prints one ``{"kernels": [...]}`` JSON line and, last, the result line.

Any failed check raises, so the script exits non-zero and prints no result.
With ``--profile DIR`` it also traces one more main-path round with
``torch.profiler`` and writes the kernel-time table to ``DIR``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ROUNDS = 4
# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 3.35 TB/s;
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz = 16.7e12 integer ops/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def rr_ops_per_element(mode: str, rounds: int) -> int:
    """Source-level integer operations one thread of rr_perm.cu performs
    (fmix32 = 8, key_combine = 14, a division or modulo counted as one):
    29 for indexing and the epoch key, then wr: 23; rr: 1 + 45 per round."""
    return 29 + (23 if mode == "wr" else 1 + 45 * rounds)


def time_ms(fn, iters: int, behind_sleep: bool = True) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn``.  The call time is host wall
    clock over ``iters`` calls ending in a synchronize (launch overhead
    included).  With ``behind_sleep`` the device time queues ``iters`` calls
    behind a GPU sleep, so the CUDA events bracket back-to-back device work:
    if the sleep had ended before the host finished queueing (the start
    event had already run) the events could hold enqueue gaps, and the
    measurement is repeated behind a longer sleep.  The launches queued
    must fit CUDA's launch queue (about a thousand), or the host blocks
    until the sleep ends.  Without ``behind_sleep`` the events bracket
    ``iters`` calls as they run, the host's gaps between launches included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    call_s = (time.perf_counter() - t0) / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = int(1.5 * call_s * iters * 2e9)   # ~2e9 cycles/s; checked below
    for _ in range(4):
        if behind_sleep:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        back_to_back = not start.query()   # the sleep outlasted the host's queueing
        torch.cuda.synchronize()
        if back_to_back or not behind_sleep:
            return start.elapsed_time(end) / iters, call_s * 1e3
        cycles *= 4
    raise RuntimeError("time_ms: the host never finished queueing within the GPU sleep")


def main_path_inputs(rounds: int):
    """The (client, size, spe) triples the e2e run's cohort engine hands the
    kernel in rounds 0..rounds-1 (its host pipeline; no task data needed)."""
    from repro_torch.data.federated import FederatedPipeline, Population
    from repro_torch.launch.train import charlm_e2e_config

    _, fl = charlm_e2e_config()
    pipe = FederatedPipeline(None, Population.build(fl), fl)
    plans = [pipe.index_plan(r, with_idx=False) for r in range(rounds)]
    return fl, pipe.k_max, plans


def check_rr_perm(dev) -> dict:
    """rr_perm on the card vs its plain torch version (on the card) and the
    numpy mirror, bitwise; timings at the main path's shape."""
    import torch

    from repro_torch.kernels.rr_perm import ref
    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel

    fl, k_max, plans = main_path_inputs(ROUNDS)
    B, R = fl.local_batch, fl.rr_rounds
    cases = []
    for p in plans:
        cases.append((p.meta.client_id, p.sizes, p.spe, p.rnd, k_max, B))
    # one padding slot appended to a main-path cohort (client -1, size 1, spe 1)
    p = plans[0]
    cases.append((np.append(p.meta.client_id, -1), np.append(p.sizes, 1).astype(np.int32),
                  np.append(p.spe, 1).astype(np.int32), p.rnd, k_max, B))
    # stress: C=256, K=64, B=32, n up to 10^6 (one slot exactly 10^6, one padding)
    rng = np.random.default_rng(0)
    sizes = np.where(rng.random(256) < 0.5, rng.integers(1, 10**6, 256),
                     rng.integers(1, 200, 256)).astype(np.int32)
    sizes[0], sizes[-1] = 10**6, 1
    clients = rng.integers(0, 2**31, 256)
    clients[-1] = -1
    spe = np.maximum(1, -(-sizes // 32)).astype(np.int32)
    spe[-1] = 1
    cases.append((clients, sizes, spe, 12345, 64, 32))

    mismatches, max_err, checked = 0, 0, 0
    for clients, sizes, spe, rnd, K, Bc in cases:
        prekey = ref.stream_key_torch(fl.seed, torch.as_tensor(clients, device=dev), rnd)
        s = torch.as_tensor(sizes, device=dev)
        e = torch.as_tensor(spe, device=dev)
        host_key = ref.stream_key(fl.seed, np.asarray(clients).astype(np.uint32), np.uint32(rnd))
        for mode in ("rr", "wr"):
            got = rr_indices_kernel(prekey, s, e, B=Bc, K=K, rounds=R, mode=mode)
            plain = ref.rr_indices_torch(prekey, s, e, Bc, K, rounds=R, mode=mode)
            host = ref.rr_indices(host_key, sizes, spe, Bc, K, rounds=R, mode=mode)
            half = rr_indices_kernel(prekey, s, e, B=Bc, K=K // 2, rounds=R, mode=mode)
            torch.cuda.synchronize()
            g = got.cpu().numpy()
            mismatches += int((g != plain.cpu().numpy()).sum() + (g != host).sum()
                              + (half.cpu().numpy() != g[:, :K // 2]).sum())
            max_err = max(max_err, int(np.abs(g.astype(np.int64) - host).max()))
            checked += g.size
    if mismatches:
        raise AssertionError(f"rr_perm: {mismatches} mismatching indices")
    print(f"rr_perm check: {checked} indices bitwise equal (kernel, plain torch on "
          f"the card, numpy mirror; rr and wr; K-prefix)", flush=True)

    # time at the main path's shape: round 0's cohort, rr mode
    p = plans[0]
    prekey = ref.stream_key_torch(fl.seed, torch.as_tensor(p.meta.client_id, device=dev), p.rnd)
    s, e = torch.as_tensor(p.sizes, device=dev), torch.as_tensor(p.spe, device=dev)
    C = len(p.sizes)
    # 200 launches fit the launch queue; the plain version's ~1700 a call do not
    ms, call_ms = time_ms(lambda: rr_indices_kernel(prekey, s, e, B=B, K=k_max, rounds=R), 200)
    plain_ms, plain_call_ms = time_ms(
        lambda: ref.rr_indices_torch(prekey, s, e, B, k_max, rounds=R), 20, behind_sleep=False)
    n = C * k_max * B
    bytes_moved = 4 * n + C * (8 + 4 + 4)
    ops = n * rr_ops_per_element("rr", R)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return {"name": "rr_perm", "route": "cuda", "source": "src/repro_torch/csrc/rr_perm.cu",
            "replaces": "src/repro/kernels/rr_perm/kernel.py:44",
            "launches": None, "max_abs_err": max_err, "mismatches": mismatches,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms, "shape": [C, k_max, B]}


def run_main_path(dev, rr_backend: str):
    from repro_torch.launch.train import run_charlm_e2e

    return run_charlm_e2e(ROUNDS, "fedshuffle", "sgd", device=dev, engine="cohort",
                          rr_backend=rr_backend, prefetch=0)


def check_small_reference(dev) -> float:
    """CharLM-tiny, two cohort-engine rounds on the card vs the port on the
    CPU: the largest relative parameter difference (fp32, TF32 off)."""
    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.paper_tasks import CHARLM_TINY
    from repro_torch.data.federated import Population
    from repro_torch.data.tasks import CharLMTask
    from repro_torch.fed.cohort.engine import CohortEngine
    from repro_torch.fed.losses import make_loss
    from repro_torch.fed.train_loop import train
    from repro_torch.models.model import build_model

    fl = FLConfig(num_clients=4, cohort_size=2, local_batch=2, algorithm="fedshuffle",
                  local_lr=0.05, mean_samples=3, cohort_mode="sequential", seed=1,
                  engine="cohort", rr_backend="device", prefetch=0)
    model = build_model(CHARLM_TINY)
    params = model.init(0, "cpu")
    out = {}
    for d in ("cpu", dev):
        task = CharLMTask(vocab=CHARLM_TINY.vocab, seq_len=16, num_clients=4)
        eng = CohortEngine.build(task, Population.build(fl), fl, device=d)
        p = {k: v.to(d) for k, v in params.items()}
        out[str(d)] = train(make_loss(model), p, eng, fl, 2, log_every=0, device=d).state.params
    worst = 0.0
    for k, v in out["cpu"].items():
        g = out[str(dev)][k].cpu()
        worst = max(worst, float((g - v).abs().max() / v.abs().max().clamp_min(1e-12)))
        if not torch.isfinite(g).all():
            raise AssertionError(f"tiny run on the card: non-finite {k}")
    if worst > 1e-4:
        raise AssertionError(f"tiny run: card vs CPU relative difference {worst:.3e} > 1e-4")
    return worst


def profile_round(dev, out_dir: Path) -> None:
    """One main-path round step (after a warm-up round) under
    torch.profiler: the kernel-time table and the device's busy share of
    the round's wall time, written to ``out_dir``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.federated import Population
    from repro_torch.data.tasks import CharLMTask
    from repro_torch.fed.cohort.engine import CohortEngine
    from repro_torch.fed.losses import make_loss
    from repro_torch.fed.rounds import build_round_step
    from repro_torch.fed.strategy import bind_strategy
    from repro_torch.launch.train import charlm_e2e_config
    from repro_torch.models.model import build_model

    cfg, fl = charlm_e2e_config(engine="cohort", rr_backend="device", prefetch=0)
    task = CharLMTask(vocab=cfg.vocab, seq_len=128, num_clients=fl.num_clients)
    eng = CohortEngine.build(task, Population.build(fl), fl, device=dev)
    model = build_model(cfg)
    loss_fn = make_loss(model)
    strat = bind_strategy(None, fl, loss_fn, num_clients=fl.num_clients)
    step = build_round_step(loss_fn, strat, fl, plane=eng.plane, device=dev)
    state = strat.init(model.init(0, dev))
    state, _ = step(state, eng.device_plan(0))     # warm-up round
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, mets = step(state, eng.device_plan(1))  # an unprofiled round: its wall time
    float(mets["local_loss"])
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, mets = step(state, eng.device_plan(2))
        float(mets["local_loss"])
        torch.cuda.synchronize()
    ka = prof.key_averages()
    field = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") \
        else "self_cuda_time_total"
    # device-side events only (kernels, copies); CPU ops repeat their kernels' time
    dev_events = [e for e in ka if e.device_type != DeviceType.CPU]
    busy_s = sum(getattr(e, field) for e in dev_events) / 1e6
    launches = sum(e.count for e in dev_events)
    mm_s = sum(getattr(e, field) for e in ka if e.key == "aten::mm") / 1e6
    # dense-layer FLOPs of the round: 6 * (weights of the x @ w products) per
    # token per step (forward + two backward products), masked steps included
    plan = eng.index_plan(2)
    steps = plan.step_mask.size
    tokens = fl.local_batch * task.seq_len
    lin = sum(v.numel() for k, v in state.params.items() if v.dim() == 2 and k != "embed")
    mm_flop = 6 * lin * tokens * steps
    real = int(plan.step_mask.sum())
    summary = (f"one round step: unprofiled wall {wall * 1e3:.1f} ms; the next (profiled) "
               f"round: device time {busy_s * 1e3:.1f} ms = {100 * busy_s / wall:.1f} % of "
               f"that wall, {launches} device kernels/copies ({wall / launches * 1e6:.1f} us "
               f"of wall each), aten::mm {mm_s * 1e3:.1f} ms for {mm_flop / 1e12:.2f} "
               f"TFLOP = {mm_flop / mm_s / 1e12:.1f} TFLOP/s; {steps} client steps, "
               f"{real} of them unmasked")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_round.txt").write_text(
        summary + "\n" + ka.table(sort_by=field, row_limit=40) + "\n")
    print(f"profile: {summary} -> {out_dir / 'profile_round.txt'}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel
    from repro_torch.utils.pytree import tree_count_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    if not smi:
        raise RuntimeError("nvidia-smi reported no card")
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build.load("rr_perm")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in build.LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    rr = check_rr_perm(dev)

    # the main path: counts to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    rr_indices_kernel.launches = 0
    t0 = time.perf_counter()
    res = run_main_path(dev, "device")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rr["launches"] = rr_indices_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    rows = res.metrics.rows
    print(f"main path: {tree_count_params(res.state.params)} params, {ROUNDS} rounds in "
          f"{wall:.2f} s (incl. set-up), peak device memory {peak / 2**30:.3f} GiB", flush=True)
    prev = 0.0
    for r in rows:
        print(f"  round {r['round']}: local_loss {r['local_loss']:.6f} "
              f"eval_loss {r.get('eval_loss', float('nan')):.6f} "
              f"round_ms {(r['elapsed_s'] - prev) * 1e3:.1f}", flush=True)
        prev = r["elapsed_s"]
    if len(rows) != ROUNDS or not all(np.isfinite(r["local_loss"]) for r in rows):
        raise AssertionError(f"main path: bad loss rows {rows}")
    if not all(torch.isfinite(v).all() for v in res.state.params.values()):
        raise AssertionError("main path: non-finite parameters")
    if rr["launches"] != ROUNDS:
        raise AssertionError(f"rr_perm launched {rr['launches']} times in {ROUNDS} rounds")

    ref = run_main_path(dev, "device_ref").state.params
    differ = [k for k in ref if not torch.equal(res.state.params[k], ref[k])]
    if differ:
        raise AssertionError(f"device vs device_ref params differ in {differ}")
    print("main path with the plain rr version (device_ref): parameters bitwise equal",
          flush=True)
    worst = check_small_reference(dev)
    print(f"CharLM-tiny on the card vs the port on the CPU: max relative diff {worst:.3e}",
          flush=True)
    if args.profile is not None:
        profile_round(dev, args.profile)

    print(json.dumps({"kernels": [rr]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
