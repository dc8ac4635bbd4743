#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

1. prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/csrc/{rr_perm,quantize,server_update,flash_attention,
   ssd}.cu`` (one ``nvcc`` each, all started together);
2. holds each kernel against its plain PyTorch version on the card (and the
   numpy mirror where there is one) at the main paths' shapes and stress
   shapes, and times both: bitwise for the training paths' three kernels,
   at the JAX tests' tolerances for flash attention (fp32 2e-5, bf16 2e-2)
   and the SSD intra-chunk step (atol 3e-5, rtol 3e-4), whose sums run in
   another order than their plain versions'; the quantize, flash
   attention and SSD cases each assert the route their wrappers choose
   (quantize: ``warp``, a warp per chunk, at the e2e wire leaves and at
   every chunk it takes (128 .. 1024), ``block`` for n % 4 != 0, other
   chunks and misaligned rows; flash: ``flash_fwd_wgmma``, the non-causal
   mode in bf16 at hd 64 on wgmma, ``flash_fwd_mma``, the rest of bf16 on
   the tensor cores, or ``flash_fwd``; SSD: ``ssd_intra_chunk_mma``, bf16 on
   the tensor cores at Hymba's and mamba2-1.3b's tiles, or
   ``ssd_intra_chunk``); both quantize routes and both SSD routes are
   timed in turns at a main-path shape, and at the serving shape the
   flash tensor-core kernel is timed beside ``flash_fwd`` on the same
   inputs and ``F.scaled_dot_product_attention`` with the same band mask,
   a yardstick the port never calls; flash attention's non-causal mode
   is held the same way (its three routes, SeamlessM4T-medium's encoder
   and cross-attention shapes, ragged Tq and Tk, a window, strided views),
   20 repeated launches at each path shape bitwise equal, and timed at
   those two shapes (``flash_fwd_wgmma``, ``flash_fwd_mma``, ``flash_fwd``)
   beside unmasked SDPA; ``rr_perm``'s latency bound (the launch floor plus
   the cipher's serial chain, counted from its SASS) beside its operations
   bound;
3. drives eighteen main paths through the user entry point, each with every
   launch count set to 0 just before and read just after: FedShuffle
   training of full-width CharLM-100M (12 x 768, d_ff 3072) for 2 rounds
   through the cohort engine with the CUDA index kernel
   (``rr_backend="device"``), first with a dense wire, then for 1 round
   with the qsgd codec both ways (``uplink="qsgd", downlink="qsgd"``: the
   CUDA quantize kernels, 12 launches of each a direction a round, all on
   the ``warp`` route); then FedShuffleMVR (``server_opt="mvr"``) for 2
   rounds with the App. F server step (the CUDA server_update kernel, one
   launch a round over all 111 parameter tensors) and for 2 rounds with
   the exact eq. 14 step (torch, no kernel); then the same four training
   paths in the vmapped cohort mode (``cohort_mode="vmapped"``, the JAX
   package's default: every client's local steps batched over the cohort;
   4 rounds, 2 for the exact step), with the same launch counts a round, each path's round wall and peak memory printed
   beside the sequential path's, and the device kernels in a dense round
   in both modes (``--profile`` traces the other paths' rounds); then the
   bucketed execution layout (``exec_mode="bucketed"``, 4 buckets: each
   step bucket's occupied rows for its K_b steps), dense sequential and
   dense, qsgd both ways and MVR exact vmapped, with
   ``rr_perm`` launched once a non-empty bucket (counted from the host
   plans), each path's round wall, peak memory and client steps a round
   printed beside its padded twin's, and a dense round traced in each
   mode; then FedShuffle + SCAFFOLD (main path 12: its [33, ...] bank,
   vmapped, bucketed and sequential) and fedprox, local_clip and adam;
   then the fleet and robust planes (main path 13, ``fleet_robust_paths``:
   a tiered fleet with dropout, stragglers and a deadline, and the
   buffered FedBuff server, each 4 rounds padded and bucketed; a sign flip
   under each robust aggregator, 2 rounds each; a rejected round; the
   buffered server with the attack, quarantine, the trimmed mean and qsgd
   both ways, 2 ticks padded, on the kernels' plain versions and bucketed,
   each held bitwise; a round of it in which quarantine removes a spike,
   held to fp64; the trimmed mean sequential), then the privacy and obs
   planes (main path 14, ``privacy_obs_paths``: every plane off, 4 rounds;
   DP at a clip between round 0's update norms, 4 rounds padded and
   bucketed and 2 + 2 through a DP server-state file; DP with secure
   aggregation, qsgd both ways and dropout, 2 rounds padded and bucketed;
   DP under ``telemetry="full"`` through ``train(telemetry_dir=)``),
   ``rr_perm`` once a padded round or a bucket, the quantize kernels 24
   launches each a tick; then serving full-width Hymba-1.5B (32 x 1600, bf16, random weights from
   seed 0) through ``launch/serve.py:generate``: batch 4, 2,048-token
   prompts, 32 greedy tokens (one flash attention launch a layer in the
   prefill, all on ``flash_fwd_mma``, and one SSD launch, all on
   ``ssd_intra_chunk_mma``; none in decode); then serving full-width
   SeamlessM4T-medium (the audio encoder-decoder: 12 + 12 layers of 1024,
   bf16) the same way: batch 4, 256-token prompts over 1,024 encoder
   frames, 32 greedy tokens (12 non-causal encoder and 12 non-causal
   cross-attention flash launches a prefill on ``flash_fwd_wgmma``, 12
   causal self-attention ones on ``flash_fwd_mma``; none in decode); then
   the host side of ``train()``: (a) vmapped dense, padded and bucketed, at
   ``prefetch`` 2 and 0 in turns (at 2 the producer thread makes the
   plans and copies them to the card), each run's round wall and the host plan's ms a
   round; (b) vmapped MVR App. F at ``prefetch=2`` for 2 rounds,
   ``save_server_state`` / ``load_server_state`` through a file, and 2 more
   rounds from it (``rr_perm`` and ``server_update`` 4 launches each across
   the halves; the file's size and save and load seconds); (c) the params
   file that run wrote, loaded into CharLM-100M and served (batch 4, 16
   greedy tokens: 12 causal fp32 flash launches in the prefill, on
   ``flash_fwd``); (d) CharLM-tiny with the EF and downlink banks on the
   card, 2 + 2 rounds through a file against 4; then the paper's vision
   task as ``benchmarks/bench_vision.py`` runs it (vision-tiny, 2 x 128
   over 64 patches; 8 clients, 4 a round, 6 samples each, E_i ~ U{2..5}):
   ``fedavg_min``, ``fedavg_mean``, ``fedavg``, ``fednova`` and
   ``fedshuffle`` 30 rounds each through ``train()`` in the vmapped cohort
   mode, the eval accuracy from the vlm prefill (2 fp32 flash launches an
   eval, on ``flash_fwd``), then FedShuffle on the cohort engine, 10
   rounds (one ``rr_perm`` launch a round); then serving full-width
   LLaVA-NeXT-Mistral-7B (32 x 4096, 32 / 8 heads of 128, bf16) through
   ``generate``: batch 4, 256-token prompts after 1,176 zero patch
   embeddings, 32 greedy tokens (one causal flash launch a layer in the
   prefill on ``flash_fwd_mma`` at hd 128; none in decode); then the rest
   of the zoo (main path 15, ``zoo_paths``): mamba2-1.3b (48 x 2048, the
   ssm family, bf16), MiniCPM-2B (40 x 2304, 36 heads of 64), ChatGLM3-6B
   (28 x 4096, 32 / 2 heads of 128, the "half" RoPE) and Qwen2-72B at full
   width with its depth cut from 80 to 20 layers (8192, 64 / 8 heads of
   128) served through ``generate`` at batch 4, 2,048-token prompts, 32
   greedy tokens (48 ``ssd_intra_chunk_mma`` launches a mamba2 prefill, 40
   / 28 / 20 causal ``flash_fwd_mma`` launches a dense prefill; none in
   decode), each model freed before the next, then the smoke runs of the
   ssm, hybrid and audio families' train losses on the card in both
   cohort modes; then MLA and the moe family (main path 16, ``moe_paths``):
   DeepSeek-V2-Lite-16B (27 x 2048, MLA of 16 heads, 64 experts top-6 + 2
   shared, bf16) and DeepSeek-V3-671B at full width with its depth cut from
   61 to 2 layers and its MTP block left out (7168, MLA of 128 heads with
   q_lora 1536, 256 experts top-8 + 1 shared) served through ``generate``
   at batch 4, 2,048-token prompts, 32 greedy tokens, with no launch of any
   kernel of the port (the JAX package's MLA and MoE reach no Pallas
   kernel either; the choices the capacity drops counted from the
   dispatch), then both archs' smoke runs (V3 with MTP) in both cohort
   modes; then ``remat`` (main path 17, ``remat_paths``): the vmapped dense
   CharLM-100M round with ``remat="full"`` and without, 3 rounds each, and
   one traced round of each (its device time); one
   sequential client step with and without; Qwen2-72B at full width, 4 of
   80 layers, bf16, one ``value_and_grad`` of the loss over 4,096 tokens
   (``train_4k``'s sequence) with and without, and at 2 layers, each
   step's peak memory (its own layers alone allocated) and wall, the
   peak's growth a layer and the deepest depth that fits the card
   reckoned from it; banded attention at Hymba's
   shape against unbanded; the one-hot cross entropy at Qwen2's vocab
   against the gather; then the launch tools (main path 18,
   ``launch_paths``): Hymba-1.5B at full width, bf16, through
   ``launch/specs.py``'s setups at one card's share of each assigned shape
   (prefill_32k at batch 1: 32 flash and 32 SSD launches at T = 32,768;
   decode_32k at batch 128 against a random full cache; long_500k at pos
   524,287, natively, and Qwen1.5-0.5B's through the ring of
   ``serve_window_long``; train_4k, one client x 1 x 4,096, in the
   hillclimb hymba pair's four configs), each step's count from
   ``launch/dryrun.py`` (made on the meta device by a child process while
   the earlier paths run: ``--launch-counts``), its bound, wall, device
   time and peak (the flash launch at T = 32,768 timed beside SDPA on the
   memory-efficient backend with a bool band mask); then
   ``examples/torch_objective_inconsistency.py`` (200 rounds) and
   ``examples/torch_serve_moe.py`` on the card; then the mesh layer (main
   path 19, ``mesh_paths``): a single-rank NCCL group over a ``HashStore``
   and ``launch/mesh.py:make_host_mesh(1, 1)``, path 18's prefill_32k (32
   flash and 32 SSD launches through ``local_map`` on the local shards)
   and train_4k baseline laid out as DTensors by ``launch/specs.py``, each
   step's wall and device time beside path 18's;
4. checks the results: finite losses and parameters, the predicted launch
   counts, the same runs with the plain versions of the kernels
   (``rr_backend="device_ref"``, ``uplink_backend="ref"``) giving
   bitwise-identical parameters, the comm metrics equal to the wire's
   arithmetic, the vmapped dense parameters within ``VMAPPED_SEQ_RTOL`` of
   the sequential run's, the bucketed sequential dense parameters bitwise
   equal to the padded run's and each bucketed vmapped path's to its padded
   twin's (or within the bound ``BUCKETED_FLIP_SHARE``'s comment states),
   CharLM-tiny runs on the card (dense, ``ef_qsgd`` /
   ``qsgd``, mvr App. F and exact, each sequential and vmapped, and dense
   vmapped) agreeing with the port on the CPU;
   for main path 13, each round's fleet metrics equal to its host plan's,
   the buffered fleet bank equal to the schedule's counts, the coordinate
   median bitwise against the plain aggregator on the CPU, krum's and
   multi-krum's selections equal to an fp64 recomputation of the same
   stack, trimmed mean and the clips within ``ROBUST_FP64_RTOL`` of fp64,
   ``scaled_noise`` bitwise card vs CPU, the rejected round's params, c and
   bank bitwise its input's, and the sequential trimmed mean within
   ``VMAPPED_SEQ_RTOL`` of the vmapped run; for main path 14, bitwise: the
   planes-off run to the dense vmapped run, each bucketed, resumed or
   telemetry run to its padded twin (``dp_epsilon`` too), round 0's masked
   sum to ``secagg_reference``; each round's ``dp_clipped_frac`` and
   ``dp_sigma`` equal to a host recount and formula; a resume under another
   ``dp_noise_mult`` refused; one leaf's noise against the plain function
   on the CPU (uniforms bitwise, normals within ``NOISE_NORMAL_ATOL``);
   every dispatched client's payload unlike its encoding; the aggregate
   within the fixed-point grid of ``weighted_sum``; each round's
   ``hist_steps`` summing to its valid count, ``hist_dp_scale`` in the
   summary, every ``round/*`` span and the producer's
   ``prefetch/plan_build`` in ``trace.json``;
   for serving, finite logits, each layer's flash and SSD launch against
   its plain version on the path's own inputs (flash within one bf16 step),
   the bf16 run no further from the plain versions in fp32 than 1.5x the
   plain bf16 run, a planted one-tile window fault failing both checks, the
   fp32 prefill elementwise at full width, a full-width fp32 prefill ->
   decode consistency check, and Hymba-tiny served on the card agreeing
   with the port on the CPU; for the audio path the same checks of the
   prefill over random frames (the planted fault: the encoder's and the
   cross-attention's flash launched causal), and SeamlessM4T-tiny served
   on the card agreeing with the port on the CPU; for the host side of
   ``train()``, bitwise: each prefetched path equal to its ``prefetch=0``
   twin, the resumed MVR run (params, ``m``, ``rnd``) to the unbroken
   one, the served checkpoint's tokens and every step's logits to the same
   call on the in-memory params (each flash launch within ``FLASH_TOL`` of
   the plain version on its inputs), the tiny resume (params, both banks)
   to the unbroken run with equal quantize launches; for the vision task,
   ``bench_vision.py``'s claim (FedShuffle within 0.08 of the best final
   eval accuracy, the best above 0.2), each method's last eval again with
   every flash launch within ``FLASH_TOL`` of the plain version, and the
   engine run bitwise equal to its ``rr_backend="device_ref"`` twin; for
   LLaVA, each prefill launch within one bf16 step of the plain version on
   the path's inputs, the prefill over random patches held to the plain
   versions in fp32 as for the other serving paths (the planted fault:
   flash launched non-causal), and LLaVA-tiny served on the card agreeing
   with the port on the CPU; for path 15, each SSD and flash launch
   against its plain version on the path's inputs, the last layer's whole
   ``ssd_scan`` (y in fp32, the state) within atol 3e-5 / rtol 3e-4 of the
   step in fp64, each bf16 run held to the plain versions in fp32 as for
   the other serving paths (the planted faults: mamba2's last chunk's
   decay dropped, the dense archs' flash launched non-causal; Qwen2's fp32
   anchor at 2 layers), mamba2's fp32 prefill -> decode consistency at full
   width, each tiny config served on the card agreeing with the CPU, and
   the three smokes within 1e-4 of a leaf's largest magnitude of the CPU
   run, Hymba's bucketed run bitwise its padded twin; for path 16, V2-Lite's
   first MoE block in fp32 on the card and the CPU over 4 x 300 tokens
   (two dispatch groups, the second padded) and one decode step of it at
   batch 4 (capacity 1): each group's dispatch mask bitwise equal, the
   router probabilities within ``MOE_PROB_ATOL`` and any token whose top-k
   differs at a near tie, the block within ``CARD_CPU_RTOL``, the planted
   fault (ties broken toward the higher index) changing the padded group's
   mask; V3's first-layer router and dispatch the same way; both tiny
   configs served on the card agreeing with the CPU; V2-Lite's bf16 prefill
   against fp32 at 2 layers reported; the smokes within 1e-4 of a leaf's
   largest magnitude of the CPU run; for path 18, each flash launch at T =
   32,768 on its last 128 query rows over all keys and each SSD launch
   whole against the plain versions at the serving path's tolerances, each
   decode step's attention against an fp64 softmax over the cache's keys
   and its key written at slot pos % S alone, every step's device time at
   or above its counted bound, the examples' claims (FedAvg at its biased
   point, FedShuffle, FedNova and SCAFFOLD at the optimum; serve_moe's
   greedy tokens equal to the CPU's); for path 19, the mesh prefill's
   logits and cache and the mesh round's new params bitwise equal to path
   18's, 32 flash and 32 SSD launches in the prefill and none in the round;
5. prints one ``{"kernels": [...]}`` JSON line and, last, the result line.

Any failed check raises, so the script exits non-zero and prints no result.
With ``--profile DIR`` it also traces one more round of the vmapped dense
main path and of the qsgd and the two mvr main paths in both modes, and one
prefill and one decode step of the serving path, with ``torch.profiler``
and writes the kernel-time tables to ``DIR``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ROUNDS = 4
MVR_EXACT_ROUNDS = 2
# the sequential dense path and its plain-kernel twin (and the bucketed
# sequential dense path) and the sequential MVR App. F path run 2 rounds,
# their vmapped and bucketed twins ROUNDS: the vmapped dense path is held to
# the sequential one by a vmapped run of 2 rounds; the MVR paths' second
# round runs the recursion with a nonzero gradient estimate
SEQ_CUT_ROUNDS = 2
# the sequential qsgd path and its plain-kernel twin run 1 round (their
# vmapped and bucketed twins ROUNDS): their checks (the launches, the twin
# bitwise) read one round, and no other path is held to them
SEQ_ONE_ROUND = 1
KERNELS = ("rr_perm", "quantize", "server_update", "flash_attention", "ssd")
# the H100 SXM's peaks, with their sources: one table for every bound
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch.dryrun import band_pairs  # noqa: E402
from repro_torch.launch.mesh import (BF16_FLOP_PER_S, FP32_FLOP_PER_S,  # noqa: E402
                                     HBM_BYTES_PER_S, INT32_OPS_PER_S, INSTR_OPS_PER_S)
# quantize.cu, source-level operations a value (a conversion, division or
# modulo counted as one).  quantize_pack: integer 21 = key_combine 14,
# position and mask 3, two conversions, shift and or; float 11 = abs and
# max of the scale pass, abs, two multiplies, add, floor, clamp (2),
# sign test, level add.  unpack_dequantize: integer 5 = byte index and
# shift (3), mask, conversion; float 3 = subtract, two multiplies.
QUANT_OPS = {"quantize_pack": (21, 11), "unpack_dequantize": (5, 3)}
COMM = dict(uplink="qsgd", downlink="qsgd")
MVR = dict(server_opt="mvr")
VMAPPED = dict(cohort_mode="vmapped")
# the vmapped dense main path against the sequential one: each leaf within
# this share of its largest magnitude.  The modes sum in other orders
# (batched against single products, the einsum aggregate against the slot
# loop); their CPU twin (CharLM at 3 x 256, the main path's FL config, 4
# rounds) differs by 1.2e-7 of a leaf's largest magnitude, and the bound
# leaves ~80x of that for cuBLAS picking other algorithms on the card.
VMAPPED_SEQ_RTOL = 1e-5
# the bucketed execution layout (FLConfig.exec_mode, buckets at the default
# 4): each step bucket's occupied rows for its K_b steps
BUCKETED = dict(exec_mode="bucketed", buckets=4)
# the bucketed paths against their padded twins.  Sequential: bitwise (each
# slot runs the same kernels on the same inputs; its last steps, masked in
# the padded layout, are exact no-ops).  Vmapped: bitwise predicted, but a
# [C_b] batch may take another cuBLAS GEMM or another split of a reduction
# than the [C] batch, which sums in another order; then each leaf within
# VMAPPED_SEQ_RTOL of its largest magnitude (dense, MVR), and with qsgd an
# element further off than that may only be a stochastic level flip: within
# one uplink level a round (server_lr * coefficient * scale / L), under
# 0.1 % of the elements, as check_small_reference holds the card to the CPU.
BUCKETED_FLIP_SHARE = 1e-3
# server_update.cu: fp32 operations a value (negate, 4 multiplies, 2 adds;
# 1 - a once a thread)
SERVER_UPDATE_OPS = 7


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


def bucketed_layout(rounds: int) -> list[tuple[int, int, int, int, int]]:
    """The bucketed main path's host plans, rounds 0..rounds-1: (non-empty
    buckets, client steps of their occupied rows, of the rows that run (a
    lone occupied row beside its masked copy, ``bucketing.MIN_ROWS``), of
    the static layout sum_b C_b * K_b, of the padded layout C * K_max) a
    round.  A round that overflows its buckets runs padded: one launch,
    padded steps."""
    from repro_torch.data.federated import BucketedPlan, FederatedPipeline, Population
    from repro_torch.fed.bucketing import occupied, occupied_rows
    from repro_torch.launch.train import charlm_e2e_config

    _, fl = charlm_e2e_config(**BUCKETED)
    pipe = FederatedPipeline(None, Population.build(fl), fl)
    padded = pipe.cohort_slots * pipe.k_max
    out = []
    for r in range(rounds):
        plan = pipe.bucketed_plan(r, with_idx=False)
        if not isinstance(plan, BucketedPlan):
            out.append((1, padded, padded, padded, padded))
            continue
        kept, pos = occupied(plan.buckets, plan.pos)
        occ = occupied_rows(plan._replace(buckets=kept, pos=pos))
        out.append((len(kept), sum(n * b.step_mask.shape[1] for b, n in zip(kept, occ)),
                    sum(b.step_mask.size for b in kept),
                    sum(b.step_mask.size for b in plan.buckets), padded))
    return out


def check_rr_perm(dev) -> dict:
    """rr_perm on the card vs its plain torch version (on the card) and the
    numpy mirror, bitwise; timings at the main path's shape."""
    import torch

    from repro_torch.kernels import build
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
    # the card's launch floor: a kernel that does nothing, from the same library
    lib = build.load("rr_perm")
    lib.empty_launch.argtypes, lib.empty_launch.restype = [ctypes.c_void_p], ctypes.c_int

    def empty():
        if lib.empty_launch(torch.cuda.current_stream(dev).cuda_stream) != 0:
            raise RuntimeError("empty_kernel launch failed")

    empty_ms, empty_call_ms = time_ms(empty, 200)
    n = C * k_max * B
    bytes_moved = 4 * n + C * (8 + 4 + 4)
    ops = n * rr_ops_per_element("rr", R)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return {"name": "rr_perm", "route": "cuda", "source": "src/repro_torch/csrc/rr_perm.cu",
            "replaces": "src/repro/kernels/rr_perm/kernel.py:44",
            "launches": None, "max_abs_err": max_err, "mismatches": mismatches,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms, "shape": [C, k_max, B],
            "empty_kernel_ms": empty_ms, "empty_kernel_call_ms": empty_call_ms}


# the least number of cycles between two dependent integer instructions on
# Hopper (IMAD, IADD3, LOP3, SHF, ISETP, SEL: fixed-latency pipes)
DEP_CYCLES = 4
SASS_REG = r"\b(U?R\d+|U?P\d)\b"


def sass_loops(sass: str, func: str) -> list[list[tuple[int, str]]]:
    """The loops of ``func`` in ``cuobjdump -sass`` output: for each branch
    back to an earlier address, the instructions (address, text) from its
    target to it."""
    import re

    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = func in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if inside and m:
            body.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for addr, text in body:
        m = re.search(r"\bBRA\s+0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            loops.append([x for x in body if int(m.group(1), 16) <= x[0] <= addr])
    return loops


def sass_chain(instrs: list[tuple[int, str]]) -> int:
    """The longest chain of dependent instructions through one pass of a
    loop body, through registers and predicates (a guarded instruction also
    reads the register it may leave unchanged)."""
    import re

    depth: dict[str, int] = {}
    for _, text in instrs:
        toks = text.split(None, 1)
        guard = []
        if toks[0].startswith("@"):
            guard = re.findall(SASS_REG, toks[0])
            toks = toks[1].split(None, 1)
        op = toks[0]
        ops = [o.strip() for o in toks[1].split(",")] if len(toks) > 1 else []
        if op.startswith(("BRA", "EXIT", "ST", "BAR", "RET")):
            continue
        # ISETP and a carry-out write a predicate as their second operand
        ndest = 2 if len(ops) > 1 and re.fullmatch(r"!?U?P\d", ops[1]) else 1
        dests = [r for o in ops[:ndest] for r in re.findall(SASS_REG, o)]
        srcs = [r for o in ops[ndest:] for r in re.findall(SASS_REG, o)] + guard
        d = 1 + max((depth.get(r, 0) for r in srcs + (dests if guard else [])), default=0)
        depth.update(dict.fromkeys(dests, d))
    return max(depth.values(), default=0)


def rr_latency_bound(rr: dict, rounds: int) -> None:
    """The rr kernel's latency bound, into ``rr``: the card's launch floor
    (``empty_kernel_ms``) plus the cipher's serial chain, counted from the
    kernel's SASS (``cuobjdump -sass``): the loop that runs the rounds
    (unrolled by the count of ``VIMNMX``, the max each round takes) repeats
    its longest dependent chain ``rounds / unroll`` times (the remainder
    loop the rest), at ``DEP_CYCLES`` cycles an instruction and the card's
    largest SM clock.  A warp starts its instructions in program order, so
    each pass waits for the last one's chain and no overlap shortens it."""
    import os

    from repro_torch.kernels import build

    lib = build.load("rr_perm")._name
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    passes = []
    for loop in sass_loops(sass, "rr_indices_kernel"):
        unroll = sum("VIMNMX" in t for _, t in loop)
        passes.append((unroll, sass_chain(loop), len(loop)))
    passes.sort(reverse=True)
    if len(passes) != 2 or passes[1][0] != 1:
        raise AssertionError(f"rr_perm SASS: loops (unroll, chain, instructions) {passes}, "
                             f"want an unrolled round loop and a one-round remainder")
    (unroll, main_chain, main_n), (_, rest_chain, rest_n) = passes
    chain = rounds // unroll * main_chain + rounds % unroll * rest_chain
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, timeout=60).stdout.split()[0])
    chain_ms = chain * DEP_CYCLES / (mhz * 1e6) * 1e3
    rr.update({"latency_bound_ms": rr["empty_kernel_ms"] + chain_ms,
               "latency_bound_by": "launch floor + serial chain", "chain_ms": chain_ms,
               "chain_instructions": chain, "sass_loops": {"unroll": unroll,
               "main": [main_n, main_chain], "remainder": [rest_n, rest_chain]},
               "sm_clock_max_mhz": mhz})
    print(f"rr_perm latency bound: launch floor {rr['empty_kernel_ms']:.5f} ms + serial chain "
          f"{chain} dependent instructions ({rounds} rounds: a {main_n}-instruction loop of "
          f"{unroll} rounds, chain {main_chain}; a {rest_n}-instruction remainder, chain "
          f"{rest_chain}) x {DEP_CYCLES} cycles at {mhz:.0f} MHz = {chain_ms:.5f} ms; bound "
          f"{rr['latency_bound_ms']:.5f} ms, the kernel {rr['ms']:.5f} ms "
          f"({rr['latency_bound_ms'] / rr['ms']:.1%} of it; the operations bound "
          f"{rr['bound_ms']:.2e} ms)", flush=True)


def e2e_wire_leaves() -> list[int]:
    """The value count of each wire leaf (the JAX package's 12 leaves) of
    the e2e model, from its shapes alone."""
    from repro_torch.launch.train import charlm_e2e_config
    from repro_torch.models.model import build_model
    from repro_torch.utils.pytree import wire_shapes

    cfg, _ = charlm_e2e_config()
    return [like.numel() for _, like in wire_shapes(build_model(cfg).init(0, "meta"))]


def _bitwise(a, b) -> bool:
    """Equal bytes (f32 and bf16 compared as ints, so -0.0 != 0.0)."""
    import torch

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in ints:
        a, b = a.contiguous().view(ints[a.dtype]), b.contiguous().view(ints[b.dtype])
    return torch.equal(a, b)


def _check_quantize_case(v, keys, chunk: int, bits: int, mirror_chunks: int,
                         mirror_rows: int, want_route: str,
                         misalign_packed: bool = False) -> tuple[int, float, float]:
    """Kernel vs plain torch on the card over all rows, and vs the numpy
    mirror on the first ``mirror_chunks`` chunks of the first
    ``mirror_rows`` rows: packed bytes, scales and decoded values, with both
    kernels launched on ``want_route`` by their wrappers' own choice (with
    ``misalign_packed`` the packed bytes are decoded from a copy one byte
    off 16-byte alignment).  Returns the number of values checked and the
    largest absolute difference from the plain version of the packed bytes
    and of the decoded values."""
    import torch

    from repro_torch.kernels.quantize import ref
    from repro_torch.kernels.quantize.kernel import (quantize_pack_kernel, route,
                                                     unpack_dequantize_kernel)

    n = v.shape[1]
    where = f"quantize chunk={chunk} bits={bits} shape={list(v.shape)}"
    if route(n, chunk, bits, v.data_ptr()) != want_route:
        raise AssertionError(f"{where}: route {route(n, chunk, bits, v.data_ptr())!r}, "
                             f"want {want_route!r}")
    before = (quantize_pack_kernel.route_launches[want_route],
              unpack_dequantize_kernel.route_launches[want_route])
    gp, gs = quantize_pack_kernel(v, keys, chunk=chunk, bits=bits)
    wp, ws = ref.quantize_pack_torch(v, keys, chunk=chunk, bits=bits)
    if misalign_packed:
        off = torch.empty(gp.numel() + 1, dtype=torch.uint8, device=gp.device)[1:]
        gp = off.view(gp.shape).copy_(gp)
    gd = unpack_dequantize_kernel(gp, gs, n=n, chunk=chunk, bits=bits)
    wd = ref.unpack_dequantize_torch(wp, ws, n=n, chunk=chunk, bits=bits)
    torch.cuda.synchronize()
    after = (quantize_pack_kernel.route_launches[want_route],
             unpack_dequantize_kernel.route_launches[want_route])
    if after != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"{where}: the {want_route} kernels did not launch")
    err_q = float((gp.int() - wp.int()).abs().max())
    err_d = float((gd - wd).abs().max())
    if not (_bitwise(gp, wp) and _bitwise(gs, ws) and _bitwise(gd, wd)):
        raise AssertionError(f"{where}: kernel != plain torch version")
    m = min(mirror_chunks, gs.shape[1])
    for r in range(min(mirror_rows, v.shape[0])):
        row = np.zeros(m * chunk, np.float32)          # the mirror pads with zeros
        src = v[r, :m * chunk].cpu().numpy()
        row[:src.size] = src
        k = keys[r, :m].cpu().numpy().astype(np.uint32)
        mp, ms = ref.quantize_pack(row.reshape(m, chunk), k, bits)
        md = ref.unpack_dequantize(mp, ms, chunk, bits).reshape(-1)[:min(n, m * chunk)]
        if not ((gp[r, :m].cpu().numpy() == mp).all() and (gs[r, :m].cpu().numpy() == ms).all()
                and (gd[r, :md.size].cpu().numpy().view(np.uint32) == md.view(np.uint32)).all()):
            raise AssertionError(f"{where}: kernel != numpy mirror (row {r})")
    return v.numel(), err_q, err_d


def check_quantize(dev) -> list[dict]:
    """The two quantize kernels on the card vs their plain torch versions on
    the card and the numpy mirror, bitwise, for bits 2 / 4 / 8 at the e2e
    wire leaves (cohort of 8, chunk 256, keys as the codec derives them in
    round 0; route ``warp``) and at stress shapes (ragged tails, chunks of
    8, 256 and 1000 with n % 4 != 0, keys near 2^32 - 1, all-zero and -0.0
    chunks; route ``block``), and at the warp route's edges (chunk 1024
    with a ragged tail: ``warp``; rows one element off 16-byte alignment:
    ``block``) and every other chunk it takes (128 .. 896 with a ragged
    tail: ``warp``); then, over one direction of one main-path round (all 12
    wire leaves, 4 bits), the ``block`` kernels' bytes against the
    ``warp`` kernels', and both routes timed in turns (warp, block, block,
    warp) beside the plain version."""
    import torch

    from repro_torch.fed.comm import round_keys
    from repro_torch.kernels.quantize import ref
    from repro_torch.kernels.quantize.kernel import quantize_pack_kernel, unpack_dequantize_kernel
    from repro_torch.kernels.rr_perm.ref import key_combine_torch

    fl, _, plans = main_path_inputs(1)
    C, chunk = len(plans[0].meta.client_id), fl.uplink_chunk
    slot_keys = round_keys(fl.seed, torch.as_tensor(plans[0].meta.client_id, device=dev), 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    leaves, keys = [], []
    for i, n in enumerate(e2e_wire_leaves()):
        # update-like values: rows of magnitudes 1e-4 .. 1
        v = torch.randn((C, n), generator=gen, device=dev)
        v *= torch.logspace(-4, 0, C, device=dev)[:, None]
        nc = -(-n // chunk)
        ki = key_combine_torch(slot_keys, i)
        keys.append(key_combine_torch(ki[:, None], torch.arange(nc, device=dev)[None, :]))
        leaves.append(v)
    leaves[0][0, :chunk] = 0.0
    leaves[0][1, :chunk] = -0.0
    checked, stress, err = 0, 0, {"quantize_pack": 0.0, "unpack_dequantize": 0.0}

    def tally(res):
        err["quantize_pack"] = max(err["quantize_pack"], res[1])
        err["unpack_dequantize"] = max(err["unpack_dequantize"], res[2])
        return res[0]

    for bits in ref.BITS_CHOICES:
        for v, k in zip(leaves, keys):
            checked += tally(_check_quantize_case(v, k, chunk, bits, mirror_chunks=1024,
                                                  mirror_rows=2, want_route="warp"))

    def stress_rows(c, n, misalign=0):
        nc = -(-n // c)
        flat = torch.randn((5 * n + misalign,), generator=gen, device=dev) * 10.0
        v = flat[misalign:].view(5, n)
        v[1, :2 * c] = 0.0
        v[2] = -0.0
        return v, (2**32 - 1 - torch.arange(5 * nc, device=dev)).reshape(5, nc)

    # n = 37c + 5: a ragged last chunk and n % 4 != 0; then the warp route's
    # edges: its largest chunk with a ragged tail of 516 values, and rows
    # (and packed bytes) off 16-byte alignment; then every other chunk the
    # warp route takes (128 .. 896, 1 .. 7 float4s a lane), each with a
    # ragged tail, so that each of its kernel instances is held here
    cases = [(c, 37 * c + 5, 0, "block") for c in (8, 256, 1000)]
    cases += [(1024, 37 * 1024 + 516, 0, "warp"), (256, 37 * 256 + 4, 1, "block")]
    cases += [(c, 9 * c + 132, 0, "warp") for c in range(128, 1024, 128)]
    for c, n, misalign, want_route in cases:
        v, k = stress_rows(c, n, misalign)
        for bits in ref.BITS_CHOICES:
            stress += tally(_check_quantize_case(v, k, c, bits, mirror_chunks=k.shape[1],
                                                 mirror_rows=5, want_route=want_route,
                                                 misalign_packed=bool(misalign)))
    print(f"quantize check: {checked} values at the e2e wire leaves (route warp) and {stress} "
          f"at stress shapes ({sum(c[-1] == 'warp' for c in cases)} warp, "
          f"{sum(c[-1] == 'block' for c in cases)} block) bitwise equal (kernels, plain torch "
          f"on the card, numpy mirror; bits 2, 4, 8)", flush=True)

    bits = fl.uplink_bits
    values = sum(v.numel() for v in leaves)
    nchunks = sum(k.numel() for k in keys)
    pb = ref.packed_width(chunk, bits)
    ns = [v.shape[1] for v in leaves]

    def q_kernel(kernel):
        return [quantize_pack_kernel(v, k, chunk=chunk, bits=bits, kernel=kernel)
                for v, k in zip(leaves, keys)]

    def q_plain():
        return [ref.quantize_pack_torch(v, k, chunk=chunk, bits=bits) for v, k in zip(leaves, keys)]

    def d_kernel(kernel):
        return [unpack_dequantize_kernel(p, s, n=n, chunk=chunk, bits=bits, kernel=kernel)
                for (p, s), n in zip(packs, ns)]

    def d_plain():
        return [ref.unpack_dequantize_torch(p, s, n=n, chunk=chunk, bits=bits)
                for (p, s), n in zip(packs, ns)]

    packs = q_kernel("warp")
    same = all(_bitwise(a, b) for x, y in zip(packs, q_kernel("block")) for a, b in zip(x, y))
    same = same and all(_bitwise(a, b) for a, b in zip(d_kernel("warp"), d_kernel("block")))
    if not same:
        raise AssertionError("quantize at the e2e leaves, 4 bits: block route != warp route")
    # bytes each call must move: every input read once, every output written once
    q_bytes = 4 * values + 8 * nchunks + pb * nchunks + 4 * nchunks
    d_bytes = pb * nchunks + 4 * nchunks + 4 * values
    rows = []
    for name, kern, plain, nbytes in (("quantize_pack", q_kernel, q_plain, q_bytes),
                                      ("unpack_dequantize", d_kernel, d_plain, d_bytes)):
        # 20 calls of 12 launches fit the launch queue behind the sleep; the
        # routes in turns, warp, block, block, warp
        turns = [time_ms(lambda r=r: kern(r), 20) for r in ("warp", "block", "block", "warp")]
        ms, block_ms = (turns[0][0] + turns[3][0]) / 2, (turns[1][0] + turns[2][0]) / 2
        call_ms = (turns[0][1] + turns[3][1]) / 2
        plain_ms, plain_call_ms = time_ms(plain, 3, behind_sleep=False)
        int_ops, fp_ops = QUANT_OPS[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(int_ops * values / INT32_OPS_PER_S,
                    (int_ops + fp_ops) * values / INSTR_OPS_PER_S) * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f"{name} at the e2e leaves, one direction: warp {ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f} % of bound), block {block_ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms; turns (warp, block, block, warp) "
              f"{[round(t[0], 4) for t in turns]}", flush=True)
        rows.append({"name": name, "route": "cuda", "source": "src/repro_torch/csrc/quantize.cu",
                     "replaces": ("src/repro/kernels/quantize/kernel.py:53" if name == "quantize_pack"
                                  else "src/repro/kernels/quantize/kernel.py:79"),
                     "kernel_route": "warp", "design": "one warp per chunk, 8 chunks a block, "
                     "float4 loads into registers, shuffle max, hoisted hash offset, one "
                     "vector store of a lane's packed word",
                     "launches": None, "route_launches": None, "max_abs_err": err[name],
                     "ms": ms, "block_ms": block_ms, "ms_turns": [t[0] for t in turns],
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "operations" if t_ops > t_bytes else "bytes",
                     "library_ms": None, "call_ms": call_ms, "plain_call_ms": plain_call_ms,
                     "shape": [C, values // C], "leaves": len(leaves), "chunk": chunk,
                     "bits": bits, "gbytes": nbytes / 1e9})
    return rows


def e2e_param_shapes() -> dict:
    """The e2e model's parameter tensors (the port's 111), as meta tensors."""
    from repro_torch.launch.train import charlm_e2e_config
    from repro_torch.models.model import build_model

    cfg, _ = charlm_e2e_config()
    return build_model(cfg).init(0, "meta")


def check_server_update(dev) -> dict:
    """server_update on the card vs its plain torch version on the card,
    bitwise: the e2e leaf set (111 tensors, 114,051,840 values) with f32 and
    bf16 x, at inv_eta_l = 1/(0.05 * 1.0) (FedShuffle) and 1/(0.05 * 3.7)
    (a c = "one" preset's k_bar), and a ragged table (1, 255, 65,537 and 0
    values, a tensor misaligned for 16-byte loads) and the small leaves of
    CHARLM_TINY (the quickstart's model); then the kernel's one
    launch over the f32 leaf set timed behind a GPU sleep and the plain
    version as it runs."""
    import torch

    from repro_torch.configs.paper_tasks import CHARLM_TINY
    from repro_torch.kernels.server_update.kernel import server_update_kernel
    from repro_torch.kernels.server_update.ref import server_update_torch
    from repro_torch.models.model import build_model

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [v.shape for v in e2e_param_shapes().values()]
    xs = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    ds = [torch.randn(s, generator=gen, device=dev) * 1e-3 for s in shapes]
    ms = [torch.randn(s, generator=gen, device=dev) * 0.1 for s in shapes]
    n_values = sum(x.numel() for x in xs)
    buf = torch.randn(3 * 70000, generator=gen, device=dev)
    ragged = [buf[:1], buf[1:256], buf[300:300 + 65537], buf[70000:70000], buf[70001:70001 + 4099]]
    r_ds = [buf[100000:100000 + t.numel()] * 1e-3 for t in ragged]
    r_ms = [buf[140000:140000 + t.numel()] for t in ragged]
    tiny = [v.shape for v in build_model(CHARLM_TINY).init(0, "meta").values()]
    t_xs, t_ds, t_ms = ([torch.randn(s, generator=gen, device=dev) * f for s in tiny]
                        for f in (1.0, 1e-3, 0.1))
    eta_l = torch.tensor(0.05, device=dev)
    invs = {"1/(0.05*1.0)": torch.reciprocal(eta_l * torch.tensor(1.0, device=dev)),
            "1/(0.05*3.7)": torch.reciprocal(eta_l * torch.tensor(3.7, device=dev))}
    checked, max_err = 0, 0.0
    for label, inv in invs.items():
        for dtype in (torch.float32, torch.bfloat16):
            for x_set, d_set, m_set in ((xs, ds, ms), (ragged, r_ds, r_ms),
                                        (t_xs, t_ds, t_ms)):
                x_in = [x.to(dtype) for x in x_set]
                d_in = [d.to(dtype) for d in d_set]
                gx, gm = server_update_kernel(x_in, d_in, m_set, eta_g=1.0, a=0.1, inv_eta_l=inv)
                for x, d, m, kx, km in zip(x_in, d_in, m_set, gx, gm):
                    px, pm = server_update_torch(x, d, m, 1.0, 0.1, inv)
                    if x.numel():
                        max_err = max(max_err, float((kx.float() - px.float()).abs().max()),
                                      float((km - pm).abs().max()))
                    if not (_bitwise(kx, px) and _bitwise(km, pm)):
                        raise AssertionError(f"server_update {label} {dtype} n={x.numel()}: "
                                             f"kernel != plain torch version")
                    checked += x.numel()
                del gx, gm, x_in, d_in
    torch.cuda.synchronize()
    print(f"server_update check: {checked} values bitwise equal to the plain torch version "
          f"on the card (the {len(xs)}-tensor e2e leaf set, a ragged table and CHARLM_TINY's "
          f"{len(tiny)} leaves; f32 and bf16 "
          f"x; inv_eta_l {', '.join(invs)})", flush=True)

    inv = invs["1/(0.05*1.0)"]
    # 20 calls of one launch each fit the launch queue behind the sleep
    ms_, call_ms = time_ms(lambda: server_update_kernel(xs, ds, ms, eta_g=1.0, a=0.1,
                                                        inv_eta_l=inv), 20)
    plain_ms, plain_call_ms = time_ms(
        lambda: [server_update_torch(x, d, m, 1.0, 0.1, inv) for x, d, m in zip(xs, ds, ms)], 3,
        behind_sleep=False)
    nbytes = 20 * n_values            # x, d, m read and x', m' written, 4 bytes each
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = SERVER_UPDATE_OPS * n_values / INSTR_OPS_PER_S * 1e3
    return {"name": "server_update", "route": "cuda",
            "source": "src/repro_torch/csrc/server_update.cu",
            "replaces": "src/repro/kernels/server_update/kernel.py:38",
            "launches": None, "max_abs_err": max_err, "ms": ms_, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": None, "library_note": "no single PyTorch call computes it",
            "call_ms": call_ms, "plain_call_ms": plain_call_ms, "tensors": len(xs),
            "values": n_values, "gbytes": nbytes / 1e9}


def run_main_path(dev, rr_backend: str, rounds: int = ROUNDS, server_opt: str = "sgd", *,
                  prefetch: int = 0, **kw):
    from repro_torch.launch.train import run_charlm_e2e

    return run_charlm_e2e(rounds, "fedshuffle", server_opt, device=dev, engine="cohort",
                          rr_backend=rr_backend, prefetch=prefetch, **kw)


def report_rounds(label: str, res, wall: float, peak: int, rounds: int = ROUNDS) -> float:
    """Print a main-path run's rounds and fail on non-finite losses or
    parameters; returns the mean wall time (ms) of the rounds after the
    first (of a one-round run, its round with the set-up)."""
    import torch

    from repro_torch.utils.pytree import tree_count_params

    rows = res.metrics.rows
    print(f"{label}: {tree_count_params(res.state.params)} params, {rounds} rounds in "
          f"{wall:.2f} s (incl. set-up), peak device memory {peak / 2**30:.3f} GiB", flush=True)
    prev = 0.0
    for r in rows:
        print(f"  round {r['round']}: local_loss {r['local_loss']:.6f} "
              f"eval_loss {r.get('eval_loss', float('nan')):.6f} "
              f"round_ms {(r['elapsed_s'] - prev) * 1e3:.1f}", flush=True)
        prev = r["elapsed_s"]
    if len(rows) != rounds or not all(np.isfinite(r["local_loss"]) for r in rows):
        raise AssertionError(f"{label}: bad loss rows {rows}")
    if not all(torch.isfinite(v).all() for v in res.state.params.values()):
        raise AssertionError(f"{label}: non-finite parameters")
    if rounds == 1:     # the one round, its set-up included
        return rows[0]["elapsed_s"] * 1e3
    return (rows[-1]["elapsed_s"] - rows[0]["elapsed_s"]) / (rounds - 1) * 1e3


def check_comm_metrics(rows, fl) -> None:
    """Each round's comm metrics equal the wire's arithmetic: per client,
    every wire leaf of n values ships ceil(n / chunk) chunks of chunk * bits
    / 8 bytes and one fp32 scale; the dense model is 32 bits a value."""
    leaves = e2e_wire_leaves()
    nc = [-(-n // fl.uplink_chunk) for n in leaves]
    bits = sum(c * (fl.uplink_chunk * fl.uplink_bits + 32) for c in nc)
    dense = 32 * sum(leaves)
    f32 = np.float32
    for r in rows:
        cohort = f32(r["cohort"])
        want = {"uplink_mbytes": cohort * f32(bits / 8e6),
                "downlink_mbytes": cohort * f32(bits / 8e6),
                "total_comm_mbytes": cohort * f32(2 * bits / 8e6),
                "uplink_compression": f32(dense / bits),
                "downlink_compression": f32(dense / bits)}
        bad = {k: (r.get(k), float(w)) for k, w in want.items() if r.get(k) != float(w)}
        if bad:
            raise AssertionError(f"round {r['round']}: comm metrics {bad} (got, want)")
    print(f"comm metrics: {bits} bits a client a direction (dense {dense}, "
          f"{dense / bits:.3f}x), equal to the wire arithmetic every round", flush=True)


def check_small_reference(dev, **comm) -> tuple[float, int]:
    """CharLM-tiny, two cohort-engine rounds on the card vs the port on the
    CPU (fp32, TF32 off): the largest relative parameter difference and the
    number of level flips.  With a dense wire every element is within 1e-4
    of its leaf's max (``comm`` may also pick the server opt, e.g. mvr, or
    the cohort mode).
    With a codec an element may instead sit on the other side of a
    stochastic level boundary, because the inputs differ by an ulp: it may
    differ by at most one uplink level a round (server_lr * coefficient *
    scale / L), and such flips must stay under 0.1 % of the elements.  With
    adam an element whose aggregate is near zero may flip the sign of its
    step, whose size is at most 1.0011 * server_lr in each of the first two
    rounds (Cauchy-Schwarz over m_hat / sqrt(v_hat) at b1 0.9, b2 0.99): it
    may differ by twice that a round, under the same share."""
    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.paper_tasks import CHARLM_TINY
    from repro_torch.data.federated import Population
    from repro_torch.data.tasks import CharLMTask
    from repro_torch.fed.cohort.engine import CohortEngine
    from repro_torch.fed.losses import make_loss
    from repro_torch.fed.strategy import bind_strategy
    from repro_torch.fed.train_loop import train
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.models.model import build_model

    rounds = 2
    fl = FLConfig(**dict(num_clients=4, cohort_size=2, local_batch=2, algorithm="fedshuffle",
                         local_lr=0.05, mean_samples=3, cohort_mode="sequential", seed=1,
                         engine="cohort", rr_backend="device", prefetch=0) | comm)
    model = build_model(CHARLM_TINY)
    loss_fn = make_loss(model)
    params = model.init(0, "cpu")
    scales = [0.0]
    pack = qops.quantize_pack

    def recording(*a, **k):
        out = pack(*a, **k)
        scales.append(float(out[1].max()))
        return out

    coded = any(comm.get(k, "identity") != "identity" for k in ("uplink", "downlink"))
    adam = comm.get("server_opt") == "adam"
    out, coeff = {}, 0.0
    qops.quantize_pack = recording
    try:
        for d in ("cpu", dev):
            task = CharLMTask(vocab=CHARLM_TINY.vocab, seq_len=16, num_clients=4)
            eng = CohortEngine.build(task, Population.build(fl), fl, device=d)
            strat = bind_strategy(None, fl, loss_fn, num_clients=4)
            coeff = max([coeff] + [float(strat.agg_coeffs(eng.device_plan(r).meta).abs().max())
                                   for r in range(rounds)])
            p = {k: v.to(d) for k, v in params.items()}
            out[str(d)] = train(loss_fn, p, eng, fl, rounds, strategy=strat, log_every=0,
                                device=d).state.params
    finally:
        qops.quantize_pack = pack
    level = rounds * fl.server_lr * coeff * max(scales) / (2 ** (fl.uplink_bits - 1) - 1)
    if adam:
        coded, level = True, rounds * 2 * 1.0011 * fl.server_lr
    worst, flips, total = 0.0, 0, 0
    for k, v in out["cpu"].items():
        g = out[str(dev)][k].cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"tiny run on the card: non-finite {k}")
        d = (g - v).abs()
        rel = d / v.abs().max().clamp_min(1e-12)
        off = rel > 1e-4
        if coded and bool((d[off] > level * (1 + 1e-3)).any()):
            raise AssertionError(f"tiny run {comm}: {k} differs by more than one level {level:.3e}")
        flips += int(off.sum())
        total += d.numel()
        worst = max(worst, float(rel[~off].max()) if (~off).any() else 0.0)
    if flips > (1e-3 * total if coded else 0):
        raise AssertionError(f"tiny run {comm}: {flips} of {total} elements off by more than 1e-4")
    return worst, flips


# flash attention: the JAX tests' tolerances (fp32 2e-5, bf16 2e-2; the
# sums run in another order; bf16 keeps 8 bits of mantissa), as
# assert_allclose applies them: |got - want| <= tol + tol * |want|
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# flash attention in bf16 at the main path's shape: both sides sum in fp32
# and round once to bf16 at the end, so they differ by at most one bf16 step
# (2^-7 |want|), plus 1e-3 for the fp32 sums' order
FLASH_MAIN_BF16_ATOL, FLASH_MAIN_BF16_RTOL = 1e-3, 2.0 ** -7
# launches of the non-causal kernel at each path shape that must equal the
# first bitwise: blocks share nothing, so any difference is a race in the
# mbarrier ring
REPEATS = 20
NONCAUSAL_DESIGN = (
    "flash_fwd_wgmma: sm_90a, a block of one consumer warpgroup (64 query rows) and one "
    "producer warp; Q once and 128-key K/V tiles by TMA (4-D maps over the [B, T, heads, 64] "
    "views, 128-byte swizzle, zeros past Tk) into a ring with full/empty mbarriers; S = Q K^T "
    "by wgmma m64n128k16 from shared memory; online softmax in registers; O += P_hi V + P_lo "
    "V by wgmma m64n64k16, P from registers, V MN-major; O staged in shared memory and "
    "stored by TMA; 3 blocks a SM with 2 stages, or 2 with 3 when the grid fits in two a SM")
# SSD intra-chunk: the JAX test's atol 3e-5 / rtol 3e-4 (fp32 throughout)
SSD_ATOL, SSD_RTOL = 3e-5, 3e-4
# the serving main path: Hymba-1.5B at full width, batch 4, 2,048-token
# prompts (past the 1,024 window, 16 SSD chunks), 32 greedy tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 32
# the audio serving path: SeamlessM4T-medium at full width, batch 4,
# 256-token decoder prompts over 1,024 encoder frames, 32 greedy tokens
AUDIO_PROMPT, AUDIO_FRAMES = 256, 1024
# mamba2-1.3b's SSD tile at the serving shape: 4 x 2,048 tokens in 256-step
# chunks, 64 heads of P 64 (d_inner 4,096), N 128
MAMBA2_SSD = (SERVE_BATCH, SERVE_PROMPT // 256, 256, 64, 64, 128)
# The bf16 serve run: bf16 keeps 8 bits, so the kernel and the plain version
# round the same fp32 value to different bf16 neighbours in a few elements a
# layer, and 32 layers of random weights amplify those steps: no elementwise
# bound holds between the two at the logits.  So both bf16 runs (kernels,
# plain versions) are held against a third, the plain versions in fp32 on
# the same weights, each by the relative error of the norm, and the kernel
# run may stray at most this many times as far as the plain run does.  A
# run with the window one key tile short is held to the same bound and must
# fail it; the elementwise bound is held in fp32 at full width
# (check_serve_fp32).
SERVE_ANCHOR_RATIO = 1.5
# fp32 at full width: the JAX model test's prefill -> decode tolerance
FP32_ATOL, FP32_RTOL = 2e-4, 2e-3


def _allclose(got, want, atol: float, rtol: float, where: str) -> float:
    """Fail unless ``got`` is finite and |got - want| <= atol + rtol |want|
    everywhere; the largest absolute difference."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{where}: non-finite values")
    bad = d > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(f"{where}: {int(bad.sum())} of {d.numel()} elements off, max "
                             f"diff {float(d.max()):.3e}")
    return float(d.max())


def _rel_norm(got, want) -> float:
    """||got - want|| / ||want||, in fp32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def check_flash(dev) -> dict:
    """flash attention on the card vs its plain torch version on the card at
    Hymba-1.5B's prefill shape (q [4, 2048, 25, 64], k/v [4, 2048, 5, 64],
    window 1024 and 0, bf16 and f32) and stress shapes (ragged T 77 and 1000,
    a window of 100 and of 30, MQA, head dims 16 and 128), q, k and v read as
    strided slices of one packed tensor, each case on the kernel ``route``
    picks (bf16: ``mma``; f32: ``simt``), and two bf16 cases that route to
    ``simt`` (hd 48; a time stride of 14 x 65 elements, not 16-byte
    aligned); then ``flash_fwd_mma`` (the path's kernel), ``flash_fwd`` on
    the same bf16 inputs, the plain version and
    ``F.scaled_dot_product_attention`` (the band mask, ``enable_gqa``) timed
    at the main path's bf16 shape.  Then the non-causal mode
    (:func:`check_flash_noncausal`)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attend

    B, T, H, KV, hd, W = SERVE_BATCH, SERVE_PROMPT, 25, 5, 64, 1024
    # b, t, h, kv, hd, window, dtype, the packed tensor's last dim, the route
    cases = [(B, T, H, KV, hd, w, dt, hd, "mma" if dt == "bfloat16" else "simt")
             for w in (W, 0) for dt in ("bfloat16", "float32")]
    cases += [(1, 77, 4, 4, 32, 0, "float32", 32, "simt"),
              (2, 1000, 10, 2, 64, 100, "float32", 64, "simt"),
              (2, 1000, 10, 2, 64, 100, "bfloat16", 64, "mma"),
              (1, 300, 8, 1, 128, 0, "bfloat16", 128, "mma"),
              (2, 130, 6, 3, 16, 64, "float32", 16, "simt"),
              (1, 77, 5, 1, 64, 30, "float32", 64, "simt"),
              (1, 200, 4, 2, 48, 50, "bfloat16", 48, "simt"),
              (2, 1000, 10, 2, 64, 100, "bfloat16", 65, "simt")]
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"float32": 0.0, "bfloat16": 0.0}
    for b, t, h, kv, d, w, dt, width, want_route in cases:
        packed = torch.randn((b, t, h + 2 * kv, width), generator=gen,
                             device=dev).to(getattr(torch, dt))[..., :d]
        q, k, v = packed.split([h, kv, kv], dim=2)
        where = f"flash {[b, t, h, kv, d]} w={w} {dt} width {width}"
        before = flash_attention_kernel.route_launches[want_route]
        got = flash_attend(q, k, v, window=w)
        if flash_attention_kernel.route_launches[want_route] != before + 1:
            raise AssertionError(f"{where}: the {want_route} kernel did not launch")
        want = flash_attend(q, k, v, window=w, backend="ref")
        atol = rtol = FLASH_TOL[dt]
        if (b, t, h, kv, d, dt) == (B, T, H, KV, hd, "bfloat16"):
            atol, rtol = FLASH_MAIN_BF16_ATOL, FLASH_MAIN_BF16_RTOL
        err[dt] = max(err[dt], _allclose(got, want, atol, rtol, where))
    torch.cuda.synchronize()
    print(f"flash_attention check: {len(cases)} cases within the stated tolerance of the plain "
          f"torch version on the card, each on its route ("
          f"{sum(c[-1] == 'mma' for c in cases)} mma, {sum(c[-1] == 'simt' for c in cases)} "
          f"simt; bf16 at the main path's shape within {FLASH_MAIN_BF16_ATOL} + 2^-7 |ref|; "
          f"max abs diff f32 {err['float32']:.3e}, bf16 {err['bfloat16']:.3e})", flush=True)

    # the main path's call: bf16 q [4, 2048, 25, 64] and k, v [4, 2048, 5, 64]
    # as the prefill hands them over (contiguous, the model's layout), window 1024
    q, k, v = (torch.randn((B, T, n, hd), generator=gen, device=dev).to(torch.bfloat16)
               for n in (H, KV, KV))
    band = (lambda d: (d >= 0) & (d < W))(torch.arange(T, device=dev)[:, None]
                                          - torch.arange(T, device=dev)[None, :])
    t = time_flash(q, k, v, lambda qt, kt, vt: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band, enable_gqa=True),
        4 * hd * band_pairs(0, T, 0, T, window=W) * B * H, "mma", window=W)
    print(f"flash_attention at bf16 {[B, T, H, KV, hd]}, window {W}: flash_fwd_mma {t['ms']:.4f} "
          f"ms, flash_fwd {t['simt_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
            "kernel_route": "mma", "design": "flash_fwd_mma: FA2-style mma.sync m16n8k16 bf16, "
            "4 warps x 16 query rows, 64-key K/V tiles double-buffered by cp.async, online "
            "softmax in registers, P = P_hi + P_lo in two P.V products",
            "launches": None, "max_abs_err": max(err.values()), "max_abs_err_f32": err["float32"],
            "max_abs_err_bf16": err["bfloat16"], **t,
            "library": "F.scaled_dot_product_attention(attn_mask=band, enable_gqa=True)",
            "shape": [B, T, H, KV, hd], "window": W, "dtype": "bfloat16",
            "noncausal": check_flash_noncausal(dev)}


def time_flash(q, k, v, sdpa, flops: int, want_route: str, **kw) -> dict:
    """The kernel ``route`` picks (a failure unless it is ``want_route``,
    the path's), each later route's kernel on the same inputs (``kernel=``),
    the plain version and ``sdpa(qt, kt, vt)``, the library yardstick on
    the [B, heads, T, hd] views, timed on the same bf16 q [B, Tq, H, hd] and
    k/v [B, Tk, KV, hd] (the model's layout), with ``flash_attend``'s ``kw``
    (causal, window); the bound from ``flops`` and the bytes of q, k and v
    read and the output written once.  -> ``ms`` for the route's kernel and
    ``<route>_ms`` for each later one."""
    from repro_torch.kernels.flash_attention.kernel import ROUTES, flash_attention_kernel, route
    from repro_torch.kernels.flash_attention.ops import flash_attend

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    _allclose(sdpa(qt, kt, vt).transpose(1, 2), flash_attend(q, k, v, backend="ref", **kw),
              FLASH_TOL["bfloat16"], FLASH_TOL["bfloat16"], f"SDPA yardstick {kw}")
    if route(qt, kt, vt, **kw) != want_route:
        raise AssertionError(f"flash {kw}: the path's bf16 shape did not route to {want_route}")
    ms, call_ms = time_ms(lambda: flash_attention_kernel(qt, kt, vt, **kw), 20)
    later = {f"{r}_ms": time_ms(lambda r=r: flash_attention_kernel(qt, kt, vt, kernel=r, **kw),
                                20)[0]
             for r in ROUTES[ROUTES.index(want_route) + 1:]}
    plain_ms, plain_call_ms = time_ms(lambda: flash_attend(q, k, v, backend="ref", **kw), 3,
                                      behind_sleep=False)
    lib_ms, _ = time_ms(lambda: sdpa(qt, kt, vt), 20)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"ms": ms, "call_ms": call_ms, **later, "plain_ms": plain_ms,
            "plain_call_ms": plain_call_ms, "library_ms": lib_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes", "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6}


def check_flash_noncausal(dev) -> dict:
    """flash attention's non-causal mode (``causal=False``: the audio
    encoder's self-attention and the decoder's cross-attention) on the card
    vs its plain torch version on the card: SeamlessM4T-medium's encoder
    shape (q, k, v [4, 1024, 16, 64]) and cross-attention shape (q [4, 256,
    16, 64], k/v [4, 1024, 16, 64]) in bf16 on ``wgmma`` and f32 on
    ``simt``; ragged Tq and Tk off the 128-key tile (Tq 200 over Tk 1000,
    Tq 1 over Tk 129, Tq 130, whose last block holds 2 rows), Tq > Tk, GQA,
    q, k and v as strided slices of packed tensors, all
    on ``wgmma``; a window and hd 32 on ``mma``; every bf16 case within one
    bf16 step, every f32 case at 2e-5.  Then 20 launches at each path shape
    bitwise equal (the race check on the mbarrier ring), and
    ``flash_fwd_wgmma``, ``flash_fwd_mma``, ``flash_fwd``, the plain
    version and ``F.scaled_dot_product_attention`` (no mask) timed at both
    path shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attend

    B, H, hd = SERVE_BATCH, 16, 64
    # b, tq, tk, h, kv, hd, window, dtype, the route; q a slice of a packed
    # [b, tq, 2 h, hd] tensor, k and v of one [b, tk, 2 kv, hd], or (tk
    # None) q, k and v all three of one [b, tq, h + 2 kv, hd]
    cases = [(B, tq, AUDIO_FRAMES, H, H, hd, 0, dt, "wgmma" if dt == "bfloat16" else "simt")
             for tq in (AUDIO_FRAMES, AUDIO_PROMPT) for dt in ("bfloat16", "float32")]
    cases += [(1, 200, 77, 4, 2, 64, 0, dt, r) for dt, r in (("bfloat16", "wgmma"),
                                                            ("float32", "simt"))]
    cases += [(2, 300, 1000, 10, 2, 64, 100, dt, r) for dt, r in (("bfloat16", "mma"),
                                                                 ("float32", "simt"))]
    cases += [(1, 130, 333, 6, 3, 32, 0, "bfloat16", "mma"),
              (1, 200, 1000, 4, 2, 64, 0, "bfloat16", "wgmma"),
              (1, 1, 129, 4, 4, 64, 0, "bfloat16", "wgmma"),
              (2, 333, 130, 8, 2, 64, 0, "bfloat16", "wgmma"),
              (1, 130, 256, 8, 8, 64, 0, "bfloat16", "wgmma"),
              (2, 777, None, 10, 2, 64, 0, "bfloat16", "wgmma")]
    gen = torch.Generator(device=dev).manual_seed(1)
    err = {"float32": 0.0, "bfloat16": 0.0}
    for b, tq, tk, h, kv, d, w, dt, want_route in cases:
        tdt = getattr(torch, dt)
        if tk is None:
            q, k, v = torch.randn((b, tq, h + 2 * kv, d), generator=gen, device=dev).to(
                tdt).split([h, kv, kv], dim=2)
        else:
            q = torch.randn((b, tq, 2 * h, d), generator=gen, device=dev).to(tdt)[:, :, :h]
            k, v = torch.randn((b, tk, 2 * kv, d), generator=gen, device=dev).to(tdt).split(kv, 2)
        before = (flash_attention_kernel.launches, flash_attention_kernel.route_launches[want_route],
                  flash_attention_kernel.mode_launches["noncausal"])
        got = flash_attend(q, k, v, causal=False, window=w)
        after = (flash_attention_kernel.launches, flash_attention_kernel.route_launches[want_route],
                 flash_attention_kernel.mode_launches["noncausal"])
        where = f"flash non-causal q {[b, tq, h, d]} k/v {[b, k.shape[1], kv, d]} w={w} {dt}"
        if [a - z for a, z in zip(after, before)] != [1, 1, 1]:
            raise AssertionError(f"{where}: not one non-causal {want_route} launch")
        want = flash_attend(q, k, v, causal=False, window=w, backend="ref")
        atol, rtol = ((FLASH_MAIN_BF16_ATOL, FLASH_MAIN_BF16_RTOL) if dt == "bfloat16"
                      else (FLASH_TOL[dt], FLASH_TOL[dt]))
        diff = _allclose(got, want, atol, rtol, where)
        err[dt] = max(err[dt], diff)
        print(f"  {where}: route {want_route}, 1 launch, max abs diff {diff:.3e}", flush=True)
    torch.cuda.synchronize()
    print(f"flash_attention non-causal check: {len(cases)} cases (bf16 within "
          f"{FLASH_MAIN_BF16_ATOL} + 2^-7 |ref|, f32 within {FLASH_TOL['float32']}) of the plain "
          f"torch version on the card; max abs diff f32 {err['float32']:.3e}, bf16 "
          f"{err['bfloat16']:.3e}", flush=True)

    res = {"max_abs_err_f32": err["float32"], "max_abs_err_bf16": err["bfloat16"],
           "cases": len(cases), "library": "F.scaled_dot_product_attention (no mask)",
           "kernel_route": "wgmma", "design": NONCAUSAL_DESIGN}
    for label, tq in (("encoder", AUDIO_FRAMES), ("cross", AUDIO_PROMPT)):
        # the path's call: contiguous [B, T, 16, 64] tensors, the model's layout
        q = torch.randn((B, tq, H, hd), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, AUDIO_FRAMES, H, hd), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        first = flash_attend(q, k, v, causal=False)
        same = sum(torch.equal(first, flash_attend(q, k, v, causal=False))
                   for _ in range(REPEATS))
        if same != REPEATS:
            raise AssertionError(f"flash non-causal ({label}): {REPEATS - same} of {REPEATS} "
                                 "repeated launches differ from the first")
        t = time_flash(q, k, v, F.scaled_dot_product_attention,
                       4 * hd * B * H * tq * AUDIO_FRAMES, "wgmma", causal=False)
        res[label] = {"shape_q": [B, tq, H, hd], "shape_kv": [B, AUDIO_FRAMES, H, hd],
                      "dtype": "bfloat16", "repeats_bitwise_equal": same, **t}
        print(f"flash_attention non-causal ({label}) at bf16 q {[B, tq, H, hd]}, k/v "
              f"{[B, AUDIO_FRAMES, H, hd]}: {REPEATS} repeated launches bitwise equal; "
              f"flash_fwd_wgmma {t['ms']:.4f} ms, flash_fwd_mma {t['mma_ms']:.4f} ms, flash_fwd "
              f"{t['simt_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
    return res


def _off(got, want, atol: float, rtol: float) -> tuple[int, float]:
    """How many elements of ``got`` are off atol + rtol |want|, and the
    largest |got - want| / (atol + rtol |want|): 1 is the edge of the bound."""
    w = want.double()
    share = (got.double() - w).abs() / (atol + rtol * w.abs())
    return int((share > 1).sum()), float(share.max())


def ssd_dense(xdt, a, bm, cm, dtype, cum=None):
    """The SSD intra-chunk step (y, S) written out with every cast,
    exponential and sum in ``dtype``, cum = cumsum(a) in ``dtype`` unless
    given: in float64 the witness that the kernel and its plain version are
    held to, independent of both; in float32 with an fp32 ``cum`` the plain
    version's arithmetic with that cum."""
    import torch

    Q = xdt.shape[2]
    x, b, c = xdt.to(dtype), bm.to(dtype), cm.to(dtype)
    cum = (torch.cumsum(a.to(dtype), dim=2) if cum is None else cum).to(dtype)
    idx = torch.arange(Q, device=xdt.device)
    tri = (idx[:, None] >= idx[None, :])[:, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = torch.exp(torch.where(tri, diff, -torch.inf)) * torch.einsum(
        "bcin,bcjn->bcij", c, b)[..., None]
    y = torch.einsum("bcijh,bcjhp->bcihp", L, x)
    decay = torch.exp(cum[:, :, -1:] - cum)
    return y, torch.einsum("bcqn,bcqhp->bchpn", b, decay[..., None] * x)


def check_ssd(dev) -> dict:
    """The SSD intra-chunk kernel on the card vs its plain torch version on
    the card at Hymba-1.5B's prefill tile (xdt [4, 16, 128, 25, 64], N 16;
    bf16 as the main path gives it, and f32), mamba2-1.3b's bf16 tile (Q 256,
    N 128; at 4 heads and at its full 64), bf16 strong decay and the JAX
    test's sweep, each case on the kernel ``route`` picks (``mma`` for bf16
    at P 64, N 16 or 128, ``simt`` for f32 and the rest); on every ``mma``
    case the kernel and the plain version also against ``ssd_dense`` in
    fp64, with the plain version's arithmetic on an fp32 cum (torch's
    cumsum on the card, and one rounded once from fp64) read beside them;
    a strong-decay scan (a = -2 over 64-step chunks) finite and equal to
    the sequential ``ssd_ref``; mamba2-1.3b's tile in f32 refused; then the
    two routes in turns and the plain version timed at the main path's
    shape, and ``mma`` at mamba2-1.3b's full tile."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd.kernel import route, ssd_intra_chunk_kernel
    from repro_torch.kernels.ssd.ops import ssd_intra_chunk, ssd_scan
    from repro_torch.kernels.ssd.ref import ssd_ref

    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(Bz, nc, Q, H, P, N, dtype, decay=None):
        dt = getattr(torch, dtype)
        xdt = (torch.randn((Bz, nc, Q, H, P), generator=gen, device=dev) * 0.5).to(dt)
        a = -F.softplus(torch.randn((Bz, nc, Q, H), generator=gen, device=dev))
        if decay is not None:
            a = torch.full_like(a, decay)
        bm = (torch.randn((Bz, nc, Q, N), generator=gen, device=dev) * 0.5).to(dt)
        cm = (torch.randn((Bz, nc, Q, N), generator=gen, device=dev) * 0.5).to(dt)
        return xdt, a, bm, cm

    main = (SERVE_BATCH, SERVE_PROMPT // 128, 128, 25, 64, 16)
    # shape, dtype, the decay (None: -softplus(randn)), the route
    cases = [(main, "bfloat16", None, "mma"), (main, "float32", None, "simt"),
             ((1, 2, 32, 4, 8, 16), "float32", None, "simt"),
             ((2, 4, 32, 8, 16, 32), "float32", None, "simt"),
             ((1, 4, 64, 4, 32, 16), "float32", None, "simt"),
             ((2, 3, 32, 6, 8, 8), "float32", None, "simt"),
             ((2, 2, 256, 4, 64, 128), "bfloat16", None, "mma"),   # mamba2-1.3b's tile
             (MAMBA2_SSD, "bfloat16", None, "mma"),                # ... at full width
             ((2, 2, 128, 4, 64, 16), "bfloat16", -2.0, "mma"),    # strong decay
             ((1, 2, 32, 4, 8, 16), "bfloat16", None, "simt")]
    max_err = {"mma": 0.0, "simt": 0.0}
    witness = []
    for shape, dtype, decay, want_route in cases:
        args = inputs(*shape, dtype, decay)
        where = f"ssd {list(shape)} {dtype} decay {decay}"
        before = ssd_intra_chunk_kernel.route_launches[want_route]
        y, s = ssd_intra_chunk(*args)
        if ssd_intra_chunk_kernel.route_launches[want_route] != before + 1:
            raise AssertionError(f"{where}: the {want_route} kernel did not launch")
        wy, ws = ssd_intra_chunk(*args, backend="ref")
        for got, want, what in ((y, wy, "y"), (s, ws, "S")):
            max_err[want_route] = max(max_err[want_route], _allclose(
                got, want, SSD_ATOL, SSD_RTOL, f"{where} {what}"))
        if want_route != "mma":
            continue
        # the same step in fp64 throughout: elements off the bound, and the
        # worst share of it, of y and S
        exact = ssd_dense(*args, torch.float64)
        a32 = args[1]
        row = {"shape": list(shape), "decay": decay}
        for name, out in (("kernel", (y, s)), ("plain", (wy, ws)),
                          ("plain, fp32 cumsum", ssd_dense(*args, torch.float32,
                                                           cum=torch.cumsum(a32, dim=2))),
                          ("plain, fp32 cum rounded once", ssd_dense(
                              *args, torch.float32, cum=torch.cumsum(a32.double(), dim=2).float()))):
            row[name] = [_off(g, w, SSD_ATOL, SSD_RTOL) for g, w in zip(out, exact)]
        del exact
        witness.append(row)
        print(f"ssd fp64 witness {where}: (elements off atol {SSD_ATOL} / rtol {SSD_RTOL}, worst "
              f"share of the bound) of y, S: " + "; ".join(
                  f"{k} {v}" for k, v in row.items() if k not in ("shape", "decay")), flush=True)
        for name in ("kernel", "plain"):
            if any(n for n, _ in row[name]):
                raise AssertionError(f"{where}: the {name} is off the fp64 witness: {row[name]}")
    # strong decay through the whole scan, against the sequential recurrence
    xdt, a, bm, cm = inputs(2, 2, 64, 4, 16, 16, "float32", decay=-2.0)
    flat = (xdt.reshape(2, 128, 4, 16), a.reshape(2, 128, 4), bm.reshape(2, 128, 16),
            cm.reshape(2, 128, 16))
    y, s = ssd_scan(*flat, 64)
    ry, rs = ssd_ref(*flat)
    decay_err = max(_allclose(y, ry, SSD_ATOL, SSD_RTOL, "ssd strong decay y"),
                    _allclose(s, rs, SSD_ATOL, SSD_RTOL, "ssd strong decay S"))
    try:
        ssd_intra_chunk_kernel(*inputs(1, 1, 256, 1, 64, 128, "float32"))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("ssd: mamba2-1.3b's tile (Q 256, N 128) in f32 was not refused")
    torch.cuda.synchronize()
    print(f"ssd check: {len(cases)} tiles within atol {SSD_ATOL} / rtol {SSD_RTOL} of the plain "
          f"torch version on the card, each on its route "
          f"({sum(c[-1] == 'mma' for c in cases)} mma, {sum(c[-1] == 'simt' for c in cases)} "
          f"simt; max abs diff mma {max_err['mma']:.3e}, simt {max_err['simt']:.3e}); strong "
          f"decay finite, {decay_err:.3e} from ssd_ref; refused: {refused}", flush=True)

    xdt, a, bm, cm = inputs(*main, "bfloat16")
    if route(xdt, a, bm, cm) != "mma":
        raise AssertionError("ssd: the main path's bf16 tile did not route to mma")
    turns = {"mma": [], "simt": []}
    for k in ("mma", "simt", "simt", "mma"):
        turns[k].append(time_ms(lambda k=k: ssd_intra_chunk_kernel(xdt, a, bm, cm, kernel=k), 20))
    ms, call_ms = (float(np.mean([t[i] for t in turns["mma"]])) for i in (0, 1))
    simt_ms = float(np.mean([t[0] for t in turns["simt"]]))
    plain_ms, plain_call_ms = time_ms(lambda: ssd_intra_chunk(xdt, a, bm, cm, backend="ref"), 3,
                                      behind_sleep=False)
    m2 = inputs(*MAMBA2_SSD, "bfloat16")
    m2_ms, _ = time_ms(lambda: ssd_intra_chunk_kernel(*m2, kernel="mma"), 20)
    Bz, nc, Q, H, P, N = MAMBA2_SSD   # xdt bf16 in, y fp32 out; a; B, C bf16; S fp32
    m2_bytes = (2 + 4) * m2[0].numel() + 4 * m2[1].numel() + 2 * 2 * m2[2].numel() \
        + 4 * Bz * nc * H * P * N
    del m2
    Bz, nc, Q, H, P, N = main
    tri = Q * (Q + 1) // 2
    # C.B^T once a chunk (lower triangle), y over the triangle, S: multiply-adds x 2
    flops = 2 * (Bz * nc * tri * N + Bz * nc * H * (tri * P + Q * P * N))
    nbytes = (2 * xdt.numel() + 4 * a.numel() + 2 * (bm.numel() + cm.numel())
              + 4 * xdt.numel() + 4 * Bz * nc * H * P * N)
    t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    print(f"ssd_intra_chunk at bf16 {list(main)}: ssd_intra_chunk_mma "
          f"{[round(t[0], 5) for t in turns['mma']]} ms, ssd_intra_chunk (simt) "
          f"{[round(t[0], 5) for t in turns['simt']]} ms in turns (mma, simt, simt, mma), plain "
          f"{plain_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms; at mamba2-1.3b's tile "
          f"{list(MAMBA2_SSD)}: ssd_intra_chunk_mma {m2_ms:.4f} ms, byte bound "
          f"{m2_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    return {"name": "ssd_intra_chunk", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:49", "kernel_route": "mma",
            "design": "ssd_intra_chunk_mma: mma.sync m16n8k16 bf16, 4 warps x 16 rows of a "
            "64-row tile, 64-step B/xdt tiles double-buffered by cp.async, C.B^T and the decay "
            "mask in registers, L in two bf16 parts at N 16 and three at N 128, dec.B in two, "
            "cum in fp64 kept as fp32 hi + lo",
            "simt_ms": simt_ms, "turns_ms": {k: [t[0] for t in v] for k, v in turns.items()},
            "launches": None, "route_launches": None, "max_abs_err": max(max_err.values()),
            "max_abs_err_mma": max_err["mma"], "max_abs_err_simt": max_err["simt"],
            "strong_decay_err": decay_err, "fp64_witness": witness, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes", "library_ms": None,
            "library_note": "no single PyTorch call computes it", "call_ms": call_ms,
            "plain_call_ms": plain_call_ms, "shape": list(main), "dtype": "bfloat16",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "mamba2_shape": list(MAMBA2_SSD),
            "mamba2_ms": m2_ms, "mamba2_bound_ms": m2_bytes / HBM_BYTES_PER_S * 1e3}


def zero_counts(*kernels) -> None:
    """Set each kernel wrapper's launch counts to 0: in all, by route and,
    where it has modes, by mode."""
    for kern in kernels:
        kern.launches = 0
        for attr in ("route_launches", "mode_launches"):
            if hasattr(kern, attr):
                setattr(kern, attr, dict.fromkeys(getattr(kern, attr), 0))


def read_counts(*kernels) -> tuple:
    """Each wrapper's (launches, by route, by mode; {} without modes)."""
    return tuple((kern.launches, dict(kern.route_launches),
                  dict(getattr(kern, "mode_launches", {}))) for kern in kernels)


def timed_generate(model, params, prompts, cache_len: int, kernels) -> dict:
    """``generate`` of ``SERVE_STEPS`` greedy tokens after a 2-token
    warm-up, the launch counts of ``kernels`` zeroed just before and read
    after the prefill (at the first logits) and at the end: the tokens,
    every step's logits (finite, or a failure), the counts of the prefill
    and of decode (each :func:`read_counts`), and the times and peak
    memory."""
    import torch

    from repro_torch.launch.serve import generate

    generate(model, params, prompts, steps=2, cache_len=cache_len)      # warm-up
    seen, marks = [], {}

    def on_logits(i, lg):
        seen.append(lg.float().clone())
        if i == 0:
            torch.cuda.synchronize()
            marks["t"] = time.perf_counter()
            marks["counts"] = read_counts(*kernels)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*kernels)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, steps=SERVE_STEPS, cache_len=cache_len,
                   on_logits=on_logits)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    total, prefill = read_counts(*kernels), marks["counts"]
    decode = tuple((t[0] - p[0], {r: t[1][r] - p[1][r] for r in t[1]},
                    {m: t[2][m] - p[2][m] for m in t[2]}) for t, p in zip(total, prefill))
    name = model.cfg.name
    if len(seen) != SERVE_STEPS or not all(torch.isfinite(x).all() for x in seen):
        raise AssertionError(f"serve {name}: non-finite logits")
    if out.shape != (len(prompts), SERVE_STEPS) or int(out.max()) >= model.cfg.vocab:
        raise AssertionError(f"serve {name}: bad tokens {tuple(out.shape)}")
    decode_ms = (t1 - marks["t"]) * 1e3 / (SERVE_STEPS - 1)
    return {"tokens": out, "logits": seen, "total": total, "prefill": prefill, "decode": decode,
            "stats": {"prefill_ms": (marks["t"] - t0) * 1e3, "decode_ms_per_step": decode_ms,
                      "decode_tok_per_s": len(prompts) * 1e3 / decode_ms,
                      "e2e_tok_per_s": len(prompts) * SERVE_STEPS / (t1 - t0),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}}


@contextlib.contextmanager
def swapped(swaps: dict):
    """Set ``module.name = fn`` for each ``(module, name): fn`` of ``swaps``
    and restore the old values on exit."""
    old = {key: getattr(*key) for key in swaps}
    for (module, name), fn in swaps.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for (module, name), fn in old.items():
            setattr(module, name, fn)


def flash_checked(err: dict, last: dict, kind):
    """A stand-in for ``flash_attention.ops.flash_attention_kernel`` that
    launches the kernel and holds each launch within one bf16 step of the
    plain version on the same inputs: ``err[kind(q, k, causal)]`` keeps the
    largest difference and ``last[kind(q, k, causal)]`` the last launch's
    (q, k, v, window, the plain version's output)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch

    def checked(q, k, v, *, causal=True, window=0):
        got = flash_attention_kernel(q, k, v, causal=causal, window=window)
        want = flash_attention_torch(q, k, v, causal=causal, window=window)
        name = kind(q, k, causal)
        err[name] = max(err.get(name, 0.0), _allclose(
            got, want, FLASH_MAIN_BF16_ATOL, FLASH_MAIN_BF16_RTOL, f"{name} flash on the path's "
            "inputs"))
        last[name] = (q, k, v, window, want)
        return got
    return checked


def flash_held(err: list, tol: float, where: str):
    """A stand-in for ``flash_attention.ops.flash_attention_kernel`` that
    launches the kernel and holds each launch within ``tol`` + ``tol`` |ref|
    of the plain version on the same inputs; ``err[0]`` keeps the largest
    difference."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch

    def checked(q, k, v, *, causal=True, window=0):
        got = flash_attention_kernel(q, k, v, causal=causal, window=window)
        want = flash_attention_torch(q, k, v, causal=causal, window=window)
        err[0] = max(err[0], _allclose(got, want, tol, tol, where))
        return got

    return checked


def anchor_check(label: str, model, params: dict, twin, checked: dict, fault_model,
                 fault_swaps: dict, fault_name: str, served: dict | None = None) -> dict:
    """The bf16 serving run held against the plain versions in fp32 on the
    same (bf16-valued) weights, by the relative error of the norm of every
    entry of ``twin(m, p, decode)`` (a dict of fp32 tensors): the kernel
    run (``model`` with the layer checks ``checked`` swapped in, no decode;
    ``served`` replaces its entries by what ``generate`` gave) may stray at
    most ``SERVE_ANCHOR_RATIO`` times as far as the plain versions' own
    bf16 run, and the planted fault (``fault_model`` with ``fault_swaps``)
    must stray further at the logits.  -> the relative errors."""
    import dataclasses

    import torch

    from repro_torch.models.model import build_model

    cfg = model.cfg
    with torch.inference_mode():
        with swapped(checked):
            kernel = twin(model, params, decode=False)
        kernel.update(served or {})
        ref = twin(build_model(cfg, backend="ref"), params)
        anchor = twin(build_model(dataclasses.replace(cfg, dtype="float32"), backend="ref"),
                      {k: v.float() for k, v in params.items()})
        with swapped(fault_swaps):
            fault = twin(fault_model, params, decode=False)["logits"]
    errs = {n: (_rel_norm(kernel[n], anchor[n]), _rel_norm(ref[n], anchor[n])) for n in anchor}
    errs["fault_logits"] = (_rel_norm(fault, anchor["logits"]), errs["logits"][1])
    print(f"{label} bf16 vs the plain versions in fp32, relative error of the norm, kernel run / "
          f"plain run (bound {SERVE_ANCHOR_RATIO}x): " + ", ".join(
              f"{n} {k:.3e} / {r:.3e} = {k / r:.3f}x" for n, (k, r) in errs.items()), flush=True)
    off = [n for n, (k, r) in errs.items() if n != "fault_logits" and k > SERVE_ANCHOR_RATIO * r]
    if off:
        raise AssertionError(f"{label} bf16: the kernel run strays more than "
                             f"{SERVE_ANCHOR_RATIO}x as far from fp32 as the plain run in {off}")
    k, r = errs["fault_logits"]
    if k <= SERVE_ANCHOR_RATIO * r:
        raise AssertionError(f"{label} bf16: the check passed {fault_name} ({k / r:.3f}x)")
    return {n: {"kernel": k, "ref": r, "ratio": k / r} for n, (k, r) in errs.items()}


def serve_main_path(dev, flash_row: dict, ssd_row: dict) -> dict:
    """Full-width Hymba-1.5B (bf16, random weights from seed 0) serves batch
    4 x 2,048-token prompts (numpy seed 1) for 32 greedy tokens through
    ``generate`` (:func:`timed_generate`); then the checks of the serving
    path: the run's prefill logits, caches and decode logits no further
    from the plain versions in fp32 than ``SERVE_ANCHOR_RATIO`` times the
    plain versions' own bf16 run (:func:`anchor_check`; the window one key
    tile short must fail it), and each launch of the kernel run's prefill
    against its plain version on the same inputs (the window one key tile
    short must fail that too)."""
    import dataclasses

    import torch

    import repro_torch.kernels.flash_attention.ops as fops
    import repro_torch.kernels.ssd.ops as sops
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_kernel
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_torch
    from repro_torch.models.model import build_model

    cfg = get_arch("hymba-1.5b")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, dev)
    n_params = sum(v.numel() for v in params.values())
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    cache_len = SERVE_PROMPT + SERVE_STEPS + 1
    run = timed_generate(model, params, prompts, cache_len,
                         (flash_attention_kernel, ssd_intra_chunk_kernel))
    (flash_total, ssd_total), (flash_pre, ssd_pre) = run["total"], run["prefill"]
    prefill, routes, ssd_routes = (flash_pre[0], ssd_pre[0]), flash_pre[1], ssd_pre[1]
    decode = (run["decode"][0][0], run["decode"][1][0])
    flash_row["launches"], ssd_row["launches"] = flash_total[0], ssd_total[0]
    ssd_row["route_launches"] = ssd_total[1]
    st = run["stats"]
    res = {"arch": cfg.name, "params": n_params, "dtype": cfg.dtype, "batch": SERVE_BATCH,
           "prompt": SERVE_PROMPT, "steps": SERVE_STEPS, **st,
           "prefill_launches": {"flash_attention": prefill[0], "ssd_intra_chunk": prefill[1],
                                "flash_attention_by_route": routes,
                                "ssd_intra_chunk_by_route": ssd_routes},
           "decode_launches": {"flash_attention": decode[0], "ssd_intra_chunk": decode[1]}}
    print(f"serve path: {cfg.name} {n_params} params ({cfg.dtype}), batch {SERVE_BATCH} x "
          f"{SERVE_PROMPT}-token prompts, {SERVE_STEPS} greedy tokens: prefill "
          f"{st['prefill_ms']:.2f} ms, decode {st['decode_ms_per_step']:.2f} ms a step "
          f"({st['decode_tok_per_s']:.1f} tokens/s), {st['e2e_tok_per_s']:.1f} tokens/s end to "
          f"end, peak device memory {st['peak_gib']:.3f} GiB; launches in the prefill: "
          f"flash_attention {prefill[0]} ({routes}), ssd_intra_chunk {prefill[1]} "
          f"({ssd_routes}); in decode: {decode[0]}, {decode[1]}", flush=True)
    if prefill != (cfg.n_layers, cfg.n_layers) or decode != (0, 0):
        raise AssertionError(f"serve launches: prefill {prefill}, decode {decode}, want "
                             f"({cfg.n_layers}, {cfg.n_layers}) and (0, 0)")
    all_mma = {"mma": cfg.n_layers, "simt": 0}
    if routes != {"wgmma": 0, **all_mma} or ssd_routes != all_mma:
        raise AssertionError(f"serve: the prefill's flash launches took {routes} and its SSD "
                             f"launches {ssd_routes}, want all {cfg.n_layers} of each on mma")

    # the twin runs, each teacher-forced with the kernel run's tokens
    out, seen = run["tokens"], run["logits"]

    def twin(m, p, decode: bool = True) -> dict:
        lg, c = m.prefill(p, {"tokens": prompts}, cache_len)
        r = {"logits": lg[:, -1].float()}
        r.update({k: v.to(torch.float32, copy=True) for k, v in c["layers"].items()})
        if decode:
            r["decode_logits"] = torch.stack([
                m.decode_step(p, out[:, i - 1:i], c)[0][:, -1].float()
                for i in range(1, SERVE_STEPS)])
        return r

    # the kernel twin's prefill holds each launch against the plain version
    # on the same inputs, the activations of the path's own 32 layers
    layer_err, last = {}, {}

    def ssd_checked(*args):
        out = ssd_intra_chunk_kernel(*args)
        for got, want in zip(out, ssd_intra_chunk_torch(*args)):
            layer_err["ssd_intra_chunk"] = max(layer_err.get("ssd_intra_chunk", 0.0), _allclose(
                got, want, SSD_ATOL, SSD_RTOL, "ssd on the path's inputs"))
        return out

    checked = {(fops, "flash_attention_kernel"):
               flash_checked(layer_err, last, lambda q, k, causal: "flash_attention"),
               (sops, "ssd_intra_chunk_kernel"): ssd_checked}
    # the planted fault: the window one key tile (64) short
    fault_model = build_model(dataclasses.replace(cfg, sliding_window=cfg.sliding_window - 64))
    res["vs_fp32_rel_err"] = anchor_check(
        "serve", model, params, twin, checked, fault_model, {}, "a window one tile short",
        {"logits": seen[0], "decode_logits": torch.stack(seen[1:])})
    # and layer by layer: the last layer's attention with the window one
    # key tile short must leave the bound
    q, k, v, window, want = last.pop("flash_attention")
    with torch.inference_mode():
        d = (flash_attention_kernel(q, k, v, window=window - 64).float() - want.float()).abs()
    fault_off = int((d > FLASH_MAIN_BF16_ATOL + FLASH_MAIN_BF16_RTOL * want.float().abs()).sum())
    res["layer_max_abs_err"] = layer_err
    res["layer_fault"] = {"elements_off": fault_off, "max_abs_diff": float(d.max())}
    print(f"serve path's kernel inputs, {cfg.n_layers} layers: flash_attention within "
          f"{FLASH_MAIN_BF16_ATOL} + 2^-7 |ref| of its plain version (max abs diff "
          f"{layer_err['flash_attention']:.3e}), ssd_intra_chunk within atol {SSD_ATOL} / rtol "
          f"{SSD_RTOL} (max abs diff {layer_err['ssd_intra_chunk']:.3e}); the window one tile "
          f"short: {fault_off} of {q.numel()} elements off, max abs diff {float(d.max()):.3e}",
          flush=True)
    if fault_off == 0:
        raise AssertionError("serve: the layer check passed a window one tile short")
    del params, seen, run, q, k, v, want, d
    torch.cuda.empty_cache()
    return res


def check_serve_fp32(dev) -> dict:
    """Full-width Hymba-1.5B in fp32 (batch 2, numpy seed 2), elementwise at
    the JAX model test's tolerance (atol 2e-4, rtol 2e-3): the prefill of
    2,048 tokens with the kernels against the plain versions (logits and
    every cache entry); then 3 decoded tokens against the prefill of all
    2,051 (a ragged last SSD chunk), as the JAX model test does at the
    reduced size (the prefill's chunked SSD and flash attention sum in
    another order than the decode's recurrence and plain attention)."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_arch("hymba-1.5b"), dtype="float32")
    model, ref_model = build_model(cfg), build_model(cfg, backend="ref")
    params = model.init(0, dev)
    T = SERVE_PROMPT
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, T + 3)), device=dev)
    errs = {}
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": toks[:, :T]}, T + 5)
        lr, cr = ref_model.prefill(params, {"tokens": toks[:, :T]}, T + 5)
        errs["ref_logits"] = _allclose(lg, lr, FP32_ATOL, FP32_RTOL, "fp32 prefill vs ref")
        for name, x in cache["layers"].items():
            errs[f"ref_{name}"] = _allclose(x, cr["layers"][name], FP32_ATOL, FP32_RTOL,
                                            f"fp32 prefill cache {name} vs ref")
        del cr, lr
        for i in range(3):
            lg, cache = model.decode_step(params, toks[:, T + i:T + i + 1], cache)
        full, _ = model.prefill(params, {"tokens": toks}, T + 5)
    errs["decode_vs_prefill"] = _allclose(lg, full, FP32_ATOL, FP32_RTOL,
                                          "fp32 prefill -> decode consistency")
    print(f"serve fp32 (full width, 2 x {T} prompts), within {FP32_ATOL} + {FP32_RTOL}|ref|: "
          f"max abs diff " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    del params, cache
    torch.cuda.empty_cache()
    return errs


def check_serve_tiny(dev, arch: str = "hymba-1.5b") -> float:
    """The reduced config of ``arch`` (Hymba-tiny: 2 layers, window 64, SSD
    chunk 32; SeamlessM4T-tiny: 2 + 2 layers over 32 frames; LLaVA-tiny: 2
    layers after 16 zero patches; fp32) serves the same prompts on the card
    (the kernels) and on the CPU (the plain versions): equal greedy tokens,
    logits within 2e-4 + 2e-3 |cpu|."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model

    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, "cpu")
    prompts = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (2, 100)))
    out, logits = {}, {}
    for d in ("cpu", dev):
        seen = []
        out[str(d)] = generate(model, {k: v.to(d) for k, v in params.items()}, prompts.to(d),
                               steps=8, cache_len=cfg.num_patches + 110,
                               on_logits=lambda i, lg, seen=seen: seen.append(lg.cpu()))
        logits[str(d)] = torch.stack(seen)
    if not torch.equal(out["cpu"], out[str(dev)].cpu()):
        raise AssertionError(f"{arch} tiny: card and CPU tokens differ")
    return _allclose(logits[str(dev)], logits["cpu"], 2e-4, 2e-3, f"{arch} tiny card vs CPU")


def serve_audio_path(dev, flash_row: dict) -> dict:
    """Full-width SeamlessM4T-medium (12 + 12 layers of 1024, vocab 256,206,
    bf16, random weights from seed 0) serves batch 4 x 256-token decoder
    prompts (numpy seed 1) over 1,024 encoder frames (``generate``'s zero
    frame embeddings) for 32 greedy tokens through ``generate``
    (:func:`timed_generate`): 12 non-causal encoder launches and 12
    non-causal cross-attention launches a prefill on ``wgmma``, 12 causal
    self-attention launches on ``mma``, none in decode.  One prefill and one decode step are
    traced for their device time.  Then the precision check on
    ``Model.prefill`` with frames from numpy seed 2
    (:func:`check_audio_prefill`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.models.model import build_model

    cfg = get_arch("seamless-m4t-medium")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, dev)
    n_params = sum(v.numel() for v in params.values())
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (SERVE_BATCH, AUDIO_PROMPT)), device=dev)
    cache_len = AUDIO_PROMPT + SERVE_STEPS + 1
    run = timed_generate(model, params, prompts, cache_len, (flash_attention_kernel,))
    (total,), (prefill,), (decode,) = run["total"], run["prefill"], run["decode"]
    st, L = run["stats"], cfg.n_layers
    res = {"arch": cfg.name, "params": n_params, "dtype": cfg.dtype, "batch": SERVE_BATCH,
           "prompt": AUDIO_PROMPT, "frames": AUDIO_FRAMES, "steps": SERVE_STEPS, **st,
           "prefill_launches": {"flash_attention": prefill[0], "by_route": prefill[1],
                                "by_mode": prefill[2]},
           "decode_launches": {"flash_attention": decode[0], "by_route": decode[1],
                               "by_mode": decode[2]}}
    print(f"serve audio path: {cfg.name} {n_params} params ({cfg.dtype}), batch {SERVE_BATCH} "
          f"x {AUDIO_PROMPT}-token prompts over {AUDIO_FRAMES} frames, {SERVE_STEPS} greedy "
          f"tokens: prefill {st['prefill_ms']:.2f} ms, decode {st['decode_ms_per_step']:.2f} ms "
          f"a step ({st['decode_tok_per_s']:.1f} tokens/s), {st['e2e_tok_per_s']:.1f} tokens/s "
          f"end to end, peak device memory {st['peak_gib']:.3f} GiB; flash_attention launches "
          f"in the prefill: {prefill[0]} (by route {prefill[1]}, by mode {prefill[2]}); in "
          f"decode: {decode[0]} (by route {decode[1]}, by mode {decode[2]})", flush=True)
    want = (3 * L, {"wgmma": 2 * L, "mma": L, "simt": 0}, {"causal": L, "noncausal": 2 * L})
    if prefill != want or decode[0] != 0:
        raise AssertionError(f"serve audio launches: prefill {prefill}, decode {decode[0]}; "
                             f"want {want} and 0")
    flash_row["launches_by_path"] = {"hymba-1.5b": flash_row["launches"], cfg.name: total[0]}
    flash_row["launches"] += total[0]
    flash_row["noncausal"]["launches"] = total[2]["noncausal"]
    del run

    # one prefill and one decode step traced (CUDA activity only): device
    # time, kernels and copies, flash's share
    batch = {"tokens": prompts, "frames": torch.zeros(
        (SERVE_BATCH, cfg.src_frames, cfg.d_model), dtype=torch.float32, device=dev)}
    with torch.inference_mode():
        lg, cache = model.prefill(params, batch, cache_len)
        tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
        for label, fn in (("prefill", lambda: model.prefill(params, batch, cache_len)),
                          ("decode", lambda: model.decode_step(params, tok, cache))):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            n, dev_ms = count_device(prof)
            flash_ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                           if "flash_fwd" in e.name()) / 1e6
            res[f"{label}_trace"] = {"kernels": n, "device_ms": dev_ms, "flash_ms": flash_ms}
            print(f"serve audio {label} traced: {n} device kernels and copies, {dev_ms:.2f} ms "
                  f"of device time, flash_fwd {flash_ms:.2f} ms", flush=True)
    del cache, lg
    res.update(check_audio_prefill(dev, model, params, prompts, cache_len))
    del params
    torch.cuda.empty_cache()
    return res


def check_audio_prefill(dev, model, params: dict, prompts, cache_len: int) -> dict:
    """``Model.prefill`` of full-width SeamlessM4T-medium over random frame
    embeddings (numpy seed 2, so the encoder's input varies across the
    batch), its logits and every cache entry (k, v, xk, xv) held to
    :func:`anchor_check`; each flash launch of the kernel run within one
    bf16 step of the plain version on the same inputs.  A planted fault,
    the encoder's and the cross-attention's flash launched causal, must
    fail both checks."""
    import torch

    import repro_torch.kernels.flash_attention.ops as fops
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel

    cfg = model.cfg
    frames = torch.as_tensor(np.random.default_rng(2).normal(
        size=(SERVE_BATCH, AUDIO_FRAMES, cfg.d_model)).astype(np.float32), device=dev)
    batch = {"tokens": prompts, "frames": frames}

    def twin(m, p, decode: bool = True) -> dict:
        lg, c = m.prefill(p, batch, cache_len)
        r = {"logits": lg[:, -1].float()}
        r.update({k: v.float() for k, v in c["layers"].items()})
        return r

    def kind(q, k, causal):
        return "self" if causal else "cross" if q.shape[2] != k.shape[2] else "encoder"

    def flash_faulty(q, k, v, *, causal=True, window=0):
        return flash_attention_kernel(q, k, v, causal=True, window=window)

    layer_err, last = {}, {}
    errs = anchor_check(
        "serve audio", model, params, twin,
        {(fops, "flash_attention_kernel"): flash_checked(layer_err, last, kind)}, model,
        {(fops, "flash_attention_kernel"): flash_faulty}, "a causal fault")
    # the planted fault, layer by layer: the last encoder and cross
    # launches' inputs through the causal kernel must leave the bound
    fault_off = {}
    with torch.inference_mode():
        for label in ("encoder", "cross"):
            q, k, v, _, want = last.pop(label)
            d = (flash_attention_kernel(q, k, v, causal=True).float() - want.float()).abs()
            fault_off[label] = int((d > FLASH_MAIN_BF16_ATOL
                                    + FLASH_MAIN_BF16_RTOL * want.float().abs()).sum())
    last.clear()
    print(f"serve audio prefill's flash inputs, {cfg.enc_layers} + {cfg.n_layers} layers, "
          f"within {FLASH_MAIN_BF16_ATOL} + 2^-7 |ref| of the plain version: max abs diff "
          + ", ".join(f"{n} {e:.3e}" for n, e in layer_err.items())
          + f"; launched causal instead: elements off {fault_off}", flush=True)
    if min(fault_off.values()) == 0:
        raise AssertionError(f"serve audio: the layer check passed a causal fault {fault_off}")
    return {"layer_max_abs_err": layer_err, "layer_fault_elements_off": fault_off,
            "vs_fp32_rel_err": errs}


def round_setup(dev, warm_up: bool = True, **comm):
    """A main-path round step built by hand (``comm`` overrides the
    FLConfig), its state (after one warm-up round with ``warm_up``) and what
    the tracing reads: ``(step, state, eng, strat, task, fl)``."""
    import torch

    from repro_torch.data.federated import Population
    from repro_torch.data.tasks import CharLMTask
    from repro_torch.fed.cohort.engine import CohortEngine
    from repro_torch.fed.losses import make_loss
    from repro_torch.fed.rounds import build_round_step
    from repro_torch.fed.strategy import bind_strategy
    from repro_torch.launch.train import charlm_e2e_config
    from repro_torch.models.model import build_model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, fl = charlm_e2e_config(engine="cohort", rr_backend="device", prefetch=0, **comm)
    task = CharLMTask(vocab=cfg.vocab, seq_len=128, num_clients=fl.num_clients)
    eng = CohortEngine.build(task, Population.build(fl), fl, device=dev)
    model = build_model(cfg)
    loss_fn = make_loss(model)
    strat = bind_strategy(None, fl, loss_fn, num_clients=fl.num_clients)
    step = build_round_step(loss_fn, strat, fl, plane=eng.plane, device=dev)
    state = strat.init(model.init(0, dev))
    if warm_up:
        state, _ = step(state, eng.device_plan(0))
    torch.cuda.synchronize()
    return step, state, eng, strat, task, fl


def device_events(ka):
    """The device-side rows of ``key_averages()`` (kernels, copies; CPU ops
    repeat their kernels' time) and the name of their time field."""
    from torch.autograd import DeviceType

    field = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") \
        else "self_cuda_time_total"
    return [e for e in ka if e.device_type != DeviceType.CPU], field


def count_device(prof) -> tuple[int, float]:
    """(device kernels and copies, their device ms) of a finished
    torch.profiler trace, read from its raw kineto events: building
    ``key_averages()`` costs ~0.2 ms an event, this ~3 us (a sequential
    round has ~240 k).  ``profile_round`` prints both."""
    from torch.autograd import DeviceType

    n, ns = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            n += 1
            ns += e.duration_ns()
    return n, ns / 1e6


def round_kernels(dev, **comm) -> tuple[int, float]:
    """(device kernels and copies, their device ms) of one main-path round
    step, traced with torch.profiler (CUDA activity only, which keeps the
    trace small).  No warm-up round: it runs after the path's own run, in
    the same process, and a round's kernels do not change with its index."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step, state, eng, *_ = round_setup(dev, warm_up=False, **comm)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, mets = step(state, eng.device_plan(0))
        float(mets["local_loss"])
        torch.cuda.synchronize()
    del state
    torch.cuda.empty_cache()
    return count_device(prof)


def profile_round(dev, out_dir: Path, label: str, **comm) -> None:
    """One main-path round step (after a warm-up round; ``comm`` overrides
    the FLConfig, e.g. the codecs, the server opt or the cohort mode) under
    torch.profiler: the kernel-time table and the device's busy share of the
    round's wall time, written to ``out_dir/profile_round_<label>.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step, state, eng, strat, task, fl = round_setup(dev, **comm)
    t0 = time.perf_counter()
    state, mets = step(state, eng.device_plan(1))  # an unprofiled round: its wall time
    float(mets["local_loss"])
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, mets = step(state, eng.device_plan(2))
        float(mets["local_loss"])
        torch.cuda.synchronize()
    ka = prof.key_averages()
    dev_events, field = device_events(ka)
    busy_s = sum(getattr(e, field) for e in dev_events) / 1e6
    launches = sum(e.count for e in dev_events)
    raw = count_device(prof)
    mm_s = sum(getattr(e, field) for e in ka if e.key in ("aten::mm", "aten::bmm")) / 1e6
    quant = [e for e in dev_events if "quantize" in e.key]
    quant_s = sum(getattr(e, field) for e in quant) / 1e6
    upd = [e for e in dev_events if "server_update" in e.key]
    upd_s = sum(getattr(e, field) for e in upd) / 1e6
    # dense-layer FLOPs of the round: 6 * (weights of the x @ w products) per
    # token per gradient pass (forward + two backward products), masked steps
    # included; an mvr step takes two passes, at y and at x, and the exact
    # server step two more per client step (full_local_gradient at x and x_prev)
    passes = 1 if strat.local_update != "mvr" else (4 if fl.mvr_exact else 2)
    plan = eng.index_plan(2)
    steps = plan.step_mask.size
    tokens = fl.local_batch * task.seq_len
    lin = sum(v.numel() for k, v in state.params.items() if v.dim() == 2 and k != "embed")
    mm_flop = 6 * lin * tokens * steps * passes
    real = int(plan.step_mask.sum())
    summary = (f"one round step: unprofiled wall {wall * 1e3:.1f} ms; the next (profiled) "
               f"round: device time {busy_s * 1e3:.1f} ms = {100 * busy_s / wall:.1f} % of "
               f"that wall, {launches} device kernels/copies ({wall / launches * 1e6:.1f} us "
               f"of wall each; count_device: {raw[0]}, {raw[1]:.1f} ms), aten::mm + aten::bmm "
               f"{mm_s * 1e3:.1f} ms for {mm_flop / 1e12:.2f} "
               f"TFLOP = {mm_flop / mm_s / 1e12:.1f} TFLOP/s; quantize kernels "
               f"{quant_s * 1e3:.3f} ms in {sum(e.count for e in quant)} launches; "
               f"server_update kernel {upd_s * 1e3:.3f} ms in {sum(e.count for e in upd)} "
               f"launches; {steps} client steps, {real} of them unmasked; peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"profile_round_{label}.txt"
    path.write_text(summary + "\n" + ka.table(sort_by=field, row_limit=40) + "\n")
    print(f"profile {label}: {summary} -> {path}", flush=True)


def vmapped_main_paths(dev, seq: dict, seq_params: dict, rows: dict) -> tuple[dict, dict]:
    """Main path 6: the four training paths again in the vmapped cohort mode
    (every client's local steps batched over the cohort), each with its
    launch counts set to 0 just before and read just after, written into
    ``rows`` (the kernels line's rows, key ``vmapped_launches``).  Checks:
    dense: rr_perm once a round, parameters bitwise equal to the
    ``device_ref`` run and within ``VMAPPED_SEQ_RTOL`` of the sequential
    run's ``seq_params``; qsgd both ways: 96 + 96 quantize launches, all on
    ``warp``, bitwise equal to the ``uplink_backend="ref"`` run; MVR App. F:
    one server_update launch a round, a finite gradient estimate; MVR exact:
    no server_update launch.  Prints each path's mean round wall after the
    first round and its peak memory beside the sequential path's, and for
    the dense path the device kernels and copies in one round (traced after
    the run; ``--profile`` traces the others) beside the sequential path's
    (``seq``: label -> (round wall ms, peak bytes, kernels and copies in a
    round, their device ms; the last two for the dense path alone)).
    Returns each path's parameters (on the host; MVR App. F's gradient
    estimate too, as ``"mvr_m"``) and the same stats of the vmapped paths,
    which the bucketed and the prefetched and resumed paths are held and
    printed against."""
    import torch

    from repro_torch.kernels.quantize.kernel import quantize_pack_kernel, unpack_dequantize_kernel
    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel
    from repro_torch.kernels.server_update.kernel import server_update_kernel
    from repro_torch.launch.train import charlm_e2e_config

    kernels = {"rr_perm": rr_indices_kernel, "quantize_pack": quantize_pack_kernel,
               "unpack_dequantize": unpack_dequantize_kernel,
               "server_update": server_update_kernel}
    nq = 2 * len(e2e_wire_leaves()) * ROUNDS
    paths = [("dense", {}, ROUNDS, {"rr_perm": ROUNDS}),
             ("qsgd", COMM, ROUNDS, {"rr_perm": ROUNDS, "quantize_pack": nq,
                                     "unpack_dequantize": nq}),
             ("mvr", MVR, ROUNDS, {"rr_perm": ROUNDS, "server_update": ROUNDS}),
             ("mvr_exact", dict(mvr_exact=True, **MVR), MVR_EXACT_ROUNDS,
              {"rr_perm": MVR_EXACT_ROUNDS, "server_update": 0})]
    twins, stats = {}, {}
    for label, kw, rounds, want in paths:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(*kernels.values())
        t0 = time.perf_counter()
        res = run_main_path(dev, "device", rounds, **kw, **VMAPPED)
        torch.cuda.synchronize()
        got = {name: kern.launches for name, kern in kernels.items()}
        routes = {name: dict(kern.route_launches) for name, kern in kernels.items()
                  if hasattr(kern, "route_launches")}
        peak = torch.cuda.max_memory_allocated()
        wall = report_rounds(f"vmapped {label} path", res, time.perf_counter() - t0, peak, rounds)
        for name, n in got.items():
            rows[name].setdefault("vmapped_launches", {})[label] = n
        bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        if bad:
            raise AssertionError(f"vmapped {label} path launches (got, want): {bad}")
        if label == "qsgd" and routes != {k: {"warp": nq, "block": 0} for k in routes}:
            raise AssertionError(f"vmapped qsgd path routes: {routes} (want all {nq} warp)")
        print(f"vmapped {label} path launches: {got}, as predicted", flush=True)
        params = res.state.params
        if label.startswith("mvr") and not all(torch.isfinite(v).all()
                                               for v in res.state.opt["m"].values()):
            raise AssertionError(f"vmapped {label} path: non-finite gradient estimate")
        if label == "qsgd":
            check_comm_metrics(res.metrics.rows, charlm_e2e_config(**COMM)[1])
        if label == "mvr":       # the resumed run (train_loop_paths) is held to it
            twins["mvr_m"] = {k: v.cpu() for k, v in res.state.opt["m"].items()}
        del res
        if label == "dense":
            # the sequential run has SEQ_CUT_ROUNDS rounds: a vmapped one as long
            cut = run_main_path(dev, "device", SEQ_CUT_ROUNDS, **VMAPPED).state.params
            worst = max(float((cut[k].cpu() - v).abs().max() / v.abs().max())
                        for k, v in seq_params.items())
            del cut
            if worst > VMAPPED_SEQ_RTOL:
                raise AssertionError(f"vmapped vs sequential dense params: {worst:.3e} of a "
                                     f"leaf's max (bound {VMAPPED_SEQ_RTOL})")
            print(f"vmapped vs sequential dense params: largest difference {worst:.3e} of its "
                  f"leaf's max (bound {VMAPPED_SEQ_RTOL})", flush=True)
        twin = {"dense": dict(rr_backend="device_ref"), "qsgd": dict(uplink_backend="ref")}
        if label in twin:
            torch.cuda.empty_cache()
            t = dict(twin[label])
            ref = run_main_path(dev, t.pop("rr_backend", "device"), rounds, **t, **kw,
                                **VMAPPED).state.params
            differ = [k for k in ref if not torch.equal(params[k], ref[k])]
            if differ:
                raise AssertionError(f"vmapped {label} path vs its plain-kernel twin: "
                                     f"params differ in {differ}")
            print(f"vmapped {label} path with {twin[label]}: parameters bitwise equal",
                  flush=True)
            del ref
        twins[label] = {k: v.cpu() for k, v in params.items()}
        del params
        s_wall, s_peak, *s_kernels = seq[label]
        stats[label] = (wall, peak)
        traced = ""
        if label == "dense":
            t0 = time.perf_counter()
            n, busy_ms = round_kernels(dev, **kw, **VMAPPED)
            stats[label] += (n, busy_ms)
            traced = (f"; device kernels and copies in a round {n} vs {s_kernels[0]}, their "
                      f"device time {busy_ms:.1f} vs {s_kernels[1]:.1f} ms (traced in "
                      f"{time.perf_counter() - t0:.1f} s)")
        print(f"vmapped vs sequential, {label}: round wall {wall:.1f} vs {s_wall:.1f} ms "
              f"({s_wall / wall:.2f}x); peak {peak / 2**30:.3f} vs {s_peak / 2**30:.3f} "
              f"GiB{traced}", flush=True)
    torch.cuda.empty_cache()
    return twins, stats


def held_to_twin(label: str, got: dict, want: dict, level: float | None = None) -> str:
    """A bucketed path's parameters against its padded twin's: "bitwise",
    or else (the vmapped mode) each leaf within ``VMAPPED_SEQ_RTOL`` of its
    largest magnitude, except, with a codec (``level`` given: one uplink
    level over the path's rounds), elements within one level of their twin,
    under ``BUCKETED_FLIP_SHARE`` of them.  Raises past the bound; returns
    what held.  ``want`` is on the host."""
    import torch

    got = {k: v.cpu() for k, v in got.items()}
    if all(torch.equal(got[k], want[k]) for k in want):
        return "bitwise"
    worst, flips, total = 0.0, 0, 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        top = float(w.abs().max().clamp_min(1e-12))
        off = d > VMAPPED_SEQ_RTOL * top
        if bool(off.any()) and (level is None or bool((d[off] > level * (1 + 1e-3)).any())):
            raise AssertionError(f"bucketed {label} path vs its padded twin: {k} off by "
                                 f"{float(d.max()) / top:.3e} of its max (bound "
                                 f"{VMAPPED_SEQ_RTOL}, one level {level})")
        flips += int(off.sum())
        total += d.numel()
        worst = max(worst, float(d.max()) / top)
    if flips > BUCKETED_FLIP_SHARE * total:
        raise AssertionError(f"bucketed {label} path: {flips} of {total} elements flipped a level")
    return (f"not bitwise: largest difference {worst:.3e} of a leaf's max; {flips} of {total} "
            f"elements past {VMAPPED_SEQ_RTOL} of it, each within one level ({level})")


def qsgd_level(rounds: int, scales: list) -> float:
    """One uplink level of the qsgd main path over ``rounds`` rounds:
    rounds * server_lr * the largest aggregation coefficient of its host
    plans * the largest qsgd scale met (``scales``, device tensors) / L."""
    import torch

    from repro_torch.data.federated import FederatedPipeline, Population
    from repro_torch.fed.rounds import as_device_meta
    from repro_torch.fed.strategy import bind_strategy
    from repro_torch.launch.train import charlm_e2e_config

    _, fl = charlm_e2e_config(**COMM, **BUCKETED)
    pipe = FederatedPipeline(None, Population.build(fl), fl)
    strat = bind_strategy(None, fl, None, num_clients=fl.num_clients)
    coeff = max(float(strat.agg_coeffs(as_device_meta(pipe.index_plan(r, with_idx=False).meta,
                                                      "cpu")).abs().max())
                for r in range(rounds))
    scale = float(torch.stack(scales).max())
    return rounds * fl.server_lr * coeff * scale / (2 ** (fl.uplink_bits - 1) - 1)


# the cohort sizes a bucket's batch may take below the padded C = 8
BUCKET_ROWS = tuple(range(1, 8))


def gemm_batch_twins(dev) -> dict[int, list[str]]:
    """Whether a batched fp32 product over a bucket's C_b rows (C_b in
    ``BUCKET_ROWS``) gives the bits the same rows get in the padded [8]
    batch, at the products the vmapped CharLM-100M step issues (4 x 127
    tokens at width 768, 12 heads of 64): the dense layers x @ w (the
    attention projections, the MLP up and down, the logits), their weight
    gradients x^T @ g and input gradients g @ w^T; the attention scores q @
    k^T and values p @ v over the [C_b x 4 x 12] head batch, and their
    gradients (dp = g @ v^T, dv = p^T @ g, dq = ds @ k, dk = ds^T @ q).
    Returns C_b -> the products that differ.  One way a vmapped bucketed
    round can leave its padded twin's bits."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    C, T, hb, t, hd = 8, 4 * 127, 4 * 12, 127, 64

    def rnd(*shape):
        return torch.randn((C, *shape), generator=gen, device=dev)

    cases = []
    for d, f in ((768, 768), (768, 3072), (3072, 768), (768, 512)):
        x, w, g = rnd(T, d), rnd(d, f), rnd(T, f)
        cases += [(f"xw {d}x{f}", lambda a, b: a @ b, x, w),
                  (f"xTg {d}x{f}", lambda a, b: a.transpose(-1, -2) @ b, x, g),
                  (f"gwT {d}x{f}", lambda a, b: a @ b.transpose(-1, -2), g, w)]
    q, k, p, g = rnd(hb, t, hd), rnd(hb, t, hd), rnd(hb, t, t), rnd(hb, t, hd)

    def heads(fn):
        # the [C, 4 x 12] head batch flattened as the vmapped einsum issues it
        return lambda a, b: fn(a.flatten(0, 1), b.flatten(0, 1)).unflatten(0, a.shape[:2])

    tr = lambda a: a.transpose(-1, -2)       # noqa: E731
    cases += [("scores q@kT", heads(lambda a, b: a @ tr(b)), q, k),
              ("values p@v", heads(lambda a, b: a @ b), p, k),
              ("dp g@vT", heads(lambda a, b: a @ tr(b)), g, k),
              ("dv pT@g", heads(lambda a, b: tr(a) @ b), p, g),
              ("dq ds@k", heads(lambda a, b: a @ b), p, k),
              ("dk dsT@q", heads(lambda a, b: tr(a) @ b), p, q)]
    differ = {cb: [] for cb in BUCKET_ROWS}
    for name, fn, a, b in cases:
        full = fn(a, b)
        for cb in BUCKET_ROWS:
            if not torch.equal(fn(a[:cb], b[:cb]), full[:cb]):
                differ[cb].append(name)
    return differ


def step_batch_twins(dev) -> dict[int, list[str]]:
    """The whole vmapped local step at full width: two steps of
    ``build_cohort_step`` (the empty chain) on CharLM-100M over C_b rows
    against the same rows of the [8] cohort, on the same random tokens.
    Returns C_b -> the delta leaves (and "loss") that are not bitwise equal:
    every product, reduction and elementwise kernel of the step at once."""
    import torch

    from repro_torch.core.local import build_cohort_step
    from repro_torch.fed.losses import make_loss
    from repro_torch.launch.train import charlm_e2e_config
    from repro_torch.models.model import build_model

    cfg, fl = charlm_e2e_config()
    model = build_model(cfg)
    params = model.init(0, dev)
    step = build_cohort_step((), make_loss(model))
    gen = torch.Generator(device=dev).manual_seed(1)
    C, K = 8, 2
    data = {"tokens": torch.randint(0, cfg.vocab, (C, K, fl.local_batch, 128), generator=gen,
                                    device=dev, dtype=torch.int32)}
    mask = torch.ones((C, K), device=dev)
    eta = torch.full((C,), fl.local_lr / K, device=dev)
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    full, full_loss, _ = step(params, mom, {}, data, mask, eta, {})
    differ = {}
    for cb in BUCKET_ROWS:
        part, loss, _ = step(params, mom, {}, {k: v[:cb] for k, v in data.items()}, mask[:cb],
                             eta[:cb], {})
        differ[cb] = [k for k in part if not torch.equal(part[k], full[k][:cb])]
        if not torch.equal(loss, full_loss[:cb]):
            differ[cb].append("loss")
        del part
    return differ


def bucketed_main_paths(dev, seq: dict, seq_params: dict, vm: dict, vm_params: dict,
                        rows: dict) -> tuple[dict, dict]:
    """Main path 8: the bucketed layout (``exec_mode="bucketed"``, 4
    buckets): dense sequential, then dense, qsgd both ways and MVR exact
    vmapped, each with its launch counts set to 0 just before and
    read just after (the kernels line's rows, key ``bucketed_launches``).
    The predicted counts come from the host plans: rr_perm once a non-empty
    bucket a round, quantize 2 x 12 a direction a round (all ``warp``),
    no server_update (App. F is not driven bucketed: its one launch a round
    does not depend on the layout).  The sequential dense parameters must
    equal ``seq_params`` (on the host) bitwise; each vmapped path's is
    held to its padded twin in ``vm_params`` by ``held_to_twin``.  Prints
    each path's round wall and peak memory beside the padded path's (``seq``
    and ``vm``: label -> (round wall ms, peak bytes[, kernels and copies in a
    round, their device ms])), the client steps a round (occupied, static,
    padded) and, for dense, the device kernels and time of one traced round
    (round 0).  Returns the dense vmapped path's parameters (on the host)
    and each path's (round wall ms, peak bytes), keyed ``label_mode``."""
    import torch

    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize.kernel import quantize_pack_kernel, unpack_dequantize_kernel
    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel
    from repro_torch.kernels.server_update.kernel import server_update_kernel
    from repro_torch.launch.train import charlm_e2e_config

    kernels = {"rr_perm": rr_indices_kernel, "quantize_pack": quantize_pack_kernel,
               "unpack_dequantize": unpack_dequantize_kernel,
               "server_update": server_update_kernel}
    layout = bucketed_layout(ROUNDS)
    differ = gemm_batch_twins(dev)
    print(f"batched fp32 products over C_b = 1..7 rows vs the same rows of a [8] batch, "
          f"C_b: cases that differ: {differ}", flush=True)
    differ = step_batch_twins(dev)
    print(f"the vmapped CharLM-100M step (2 steps) over C_b = 1..7 rows vs the same rows of "
          f"the [8] cohort, C_b: leaves that differ: "
          f"{ {cb: len(v) for cb, v in differ.items()} } (C_b 1: {differ[1][:3]} ...)",
          flush=True)
    print(f"bucketed layout, rounds 0-{ROUNDS - 1}: non-empty buckets "
          f"{[r[0] for r in layout]}, client steps a round: occupied {[r[1] for r in layout]}, "
          f"run {[r[2] for r in layout]} (static layout {layout[0][3]}, padded "
          f"{layout[0][4]})", flush=True)
    nq = 2 * len(e2e_wire_leaves()) * ROUNDS
    seq_kw = dict(cohort_mode="sequential")
    paths = [("dense", "sequential", seq_kw, SEQ_CUT_ROUNDS),
             ("dense", "vmapped", VMAPPED, ROUNDS),
             ("qsgd", "vmapped", COMM | VMAPPED, ROUNDS),
             ("mvr_exact", "vmapped", dict(mvr_exact=True, **MVR, **VMAPPED),
              MVR_EXACT_ROUNDS)]
    pack = qops.quantize_pack
    kept, stats = {}, {}
    for label, mode, kw, rounds in paths:
        want = {"rr_perm": sum(r[0] for r in layout[:rounds]),
                "quantize_pack": nq if label == "qsgd" else 0,
                "unpack_dequantize": nq if label == "qsgd" else 0,
                "server_update": 0}
        scales = []

        def recording(*a, **k):
            out = pack(*a, **k)
            scales.append(out[1].amax())
            return out

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        qops.quantize_pack = recording
        try:
            zero_counts(*kernels.values())
            t0 = time.perf_counter()
            res = run_main_path(dev, "device", rounds, **kw, **BUCKETED)
            torch.cuda.synchronize()
            got = {name: kern.launches for name, kern in kernels.items()}
            routes = {name: dict(kern.route_launches) for name, kern in kernels.items()
                      if hasattr(kern, "route_launches")}
        finally:
            qops.quantize_pack = pack
        peak = torch.cuda.max_memory_allocated()
        tag = f"bucketed {label} path, {mode}"
        wall = report_rounds(tag, res, time.perf_counter() - t0, peak, rounds)
        for name, n in got.items():
            rows[name].setdefault("bucketed_launches", {})[f"{label}_{mode}"] = n
        if got != want:
            raise AssertionError(f"{tag} launches (got, want): {got}, {want}")
        if label == "qsgd" and routes != {k: {"warp": nq, "block": 0} for k in routes}:
            raise AssertionError(f"{tag} routes: {routes} (want all {nq} warp)")
        print(f"{tag} launches: {got}, as predicted from the host plans", flush=True)
        if label.startswith("mvr") and not all(torch.isfinite(v).all()
                                               for v in res.state.opt["m"].values()):
            raise AssertionError(f"{tag}: non-finite gradient estimate")
        if label == "qsgd":
            check_comm_metrics(res.metrics.rows, charlm_e2e_config(**COMM)[1])
        params = res.state.params
        del res
        if mode == "sequential":
            differ = [k for k in seq_params if not torch.equal(params[k].cpu(), seq_params[k])]
            if differ:
                raise AssertionError(f"{tag} vs the padded sequential path: params differ "
                                     f"in {differ}")
            held = "bitwise"
            twin_wall, twin_peak, *twin_kernels = seq[label]
        else:
            level = qsgd_level(rounds, scales) if label == "qsgd" else None
            held = held_to_twin(f"{label} {mode}", params, vm_params[label], level)
            twin_wall, twin_peak, *twin_kernels = vm[label]
        if (label, mode) == ("dense", "vmapped"):
            kept = {k: v.cpu() for k, v in params.items()}
        stats[f"{label}_{mode}"] = (wall, peak)
        del params
        print(f"{tag} vs its padded twin: parameters {held}", flush=True)
        traced = ""
        if label == "dense":
            t0 = time.perf_counter()
            n, busy_ms = round_kernels(dev, **kw, **BUCKETED)
            traced = (f"; round 0: device kernels and copies {n} vs {twin_kernels[0]}, their "
                      f"device time {busy_ms:.1f} vs {twin_kernels[1]:.1f} ms (traced in "
                      f"{time.perf_counter() - t0:.1f} s)")
        steps = [r[2 if mode == "vmapped" else 1] for r in layout[:rounds]]
        print(f"bucketed vs padded, {label} {mode}: round wall {wall:.1f} vs {twin_wall:.1f} ms "
              f"({twin_wall / wall:.2f}x); peak {peak / 2**30:.3f} vs {twin_peak / 2**30:.3f} "
              f"GiB; client steps a round {steps} (static {layout[0][3]}, padded "
              f"{layout[0][4]}){traced}", flush=True)
    torch.cuda.empty_cache()
    return kept, stats


# main path 12: FedShuffle + SCAFFOLD, its per-client bank of control
# variates (one [N+1, ...] row set in fp32) and the server's c
SCAFFOLD = dict(server_opt="scaffold")
# the server's c after round 0 against the w/p-weighted sum of the rows the
# round committed, recomputed in fp64 on the host: each element within this
# share of sum_i |wp_i c_i| (an 8-term fp32 sum is within 8 * 2^-24 = 4.8e-7
# of it, whatever order it adds in)
SCAFFOLD_C_RTOL = 1e-6
# the other rules driven at full width, 2 rounds each, vmapped padded; all
# four on CharLM-tiny on the card against the port on the CPU, 2 vmapped
# rounds each, every element within 1e-4 of its leaf's largest magnitude
# (check_small_reference's dense bound)
# FedAdam at a server step of 0.01 (Reddi et al.'s range): its first step
# moves every weight by server_lr * sign(Delta), and at the e2e config's
# server_lr 1.0 the model leaves its basin in one round (CharLM-tiny's eval
# loss 4.16 -> 32.1 on the CPU)
CHAIN_RULES = {"scaffold": SCAFFOLD, "fedprox": dict(local_update="fedprox"),
               "local_clip": dict(local_update="local_clip"),
               "adam": dict(server_opt="adam", server_lr=0.01)}
# tests/test_client_transforms.py's claim on the duplicated quadratic with
# partial participation: FedAvg + SCAFFOLD within this distance of x* after
# this many rounds, and under this share of plain FedAvg's distance
SCAFFOLD_CLAIM = dict(rounds=400, err=0.02, share=0.25)


def sampled_clients(rounds: int, **kw) -> set[int]:
    """The clients the e2e run's host plans sample (valid slots) in rounds
    0..rounds-1; the layout does not change who is sampled."""
    from repro_torch.data.federated import FederatedPipeline, Population
    from repro_torch.launch.train import charlm_e2e_config

    _, fl = charlm_e2e_config(**kw)
    pipe = FederatedPipeline(None, Population.build(fl), fl)
    out = set()
    for r in range(rounds):
        meta = pipe.index_plan(r, with_idx=False).meta
        out |= {int(c) for c, v in zip(meta.client_id, meta.valid) if v > 0}
    return out


def check_scaffold_bank(label: str, state, sampled: set[int]) -> int:
    """The bank is [N+1, ...] fp32 for every parameter; the scratch row (N)
    and the rows of clients never sampled are exactly zero, each sampled
    client's row is not.  Returns its bytes."""
    import torch

    bank = state.clients["scaffold"]["c"]
    n = {v.shape[0] for v in bank.values()}
    if n != {33} or any(v.dtype != torch.float32 for v in bank.values()) or \
            bank.keys() != state.params.keys():
        raise AssertionError(f"{label}: bank rows {n}, dtypes {({v.dtype for v in bank.values()})}")
    for i in range(33):
        used = any(bool(v[i].any()) for v in bank.values())
        if used != (i in sampled):
            raise AssertionError(f"{label}: bank row {i} {'written' if used else 'zero'}, "
                                 f"sampled {i in sampled}")
    return sum(v.numel() * v.element_size() for v in bank.values())


def check_scaffold_c_round0(dev) -> dict:
    """One vmapped round of FedShuffle + SCAFFOLD at full width: the server's
    c against sum_i (w/p)_i * c_i+ over the rows the round committed (the
    gathered rows were zero), recomputed in fp64 on the host, each element
    within ``SCAFFOLD_C_RTOL`` of sum_i |(w/p)_i c_i+|."""
    import torch

    from repro_torch.fed.rounds import as_device_meta

    step, state, eng, strat, task, fl = round_setup(dev, warm_up=False, **SCAFFOLD, **VMAPPED)
    state, _ = step(state, eng.device_plan(0))
    meta = as_device_meta(eng.index_plan(0).meta, "cpu")
    keep = meta.valid > 0
    wp = (meta.valid * meta.weight / meta.prob)[keep].double()
    ids = meta.client_id[keep].to(dev)
    worst = 0.0
    for k, c in state.opt["c"].items():
        rows = state.clients["scaffold"]["c"][k].index_select(0, ids).cpu().double()
        want = torch.einsum("c,c...->...", wp, rows)
        bound = SCAFFOLD_C_RTOL * torch.einsum("c,c...->...", wp.abs(), rows.abs())
        err = (c.cpu().double() - want).abs()
        if bool((err > bound).any()):
            raise AssertionError(f"scaffold round 0: server c[{k}] off the fp64 w/p sum by "
                                 f"{float(err.max()):.3e} (bound {SCAFFOLD_C_RTOL} of the "
                                 f"|terms| sum)")
        worst = max(worst, float((err / bound.clamp_min(1e-30)).max()))
    del state, step, eng
    torch.cuda.empty_cache()
    print(f"scaffold round 0: the server's c equals the fp64 w/p-weighted sum of the "
          f"{int(keep.sum())} committed rows within {worst:.3f} of the stated bound "
          f"({SCAFFOLD_C_RTOL} of sum |wp_i c_i|)", flush=True)
    return {"c_err_share_of_bound": worst}


# main path 12's three SCAFFOLD forms run 2 rounds, not ROUNDS:
# every check reads them alike (the launches a round, the bank's sampled
# and scratch rows, bucketed and sequential held to the vmapped run), and a
# second round already runs each client's control variate from its bank
SCAFFOLD_ROUNDS = 2


def scaffold_main_paths(dev, rows: dict) -> dict:
    """Main path 12: FedShuffle + SCAFFOLD on full-width CharLM-100M through
    ``run_charlm_e2e`` (cohort engine, ``rr_backend="device"``),
    ``SCAFFOLD_ROUNDS`` rounds in three forms, each with its rr_perm count
    set to 0 just before and read just after (written into
    ``rows["rr_perm"]["scaffold_launches"]``): vmapped padded (a launch a
    round), vmapped bucketed (one a non-empty bucket, from the host plans),
    held to the padded run by ``held_to_twin`` over params, the server's c
    and the bank, and sequential padded (a launch a round), its params held
    to the vmapped run's within ``VMAPPED_SEQ_RTOL`` of each leaf's largest
    magnitude.  Each form's bank is [33, ...] fp32 with the
    scratch row and never-sampled clients' rows exactly zero; before the
    runs, one round checks the server's c against the fp64 sum
    (:func:`check_scaffold_c_round0`).  Then fedprox, local_clip and adam 2
    rounds each at full width (vmapped padded; finite losses, parameters and
    adam's moments); the four rules on CharLM-tiny on the card against the
    CPU; and the quadratic claim (:func:`scaffold_claim`).  Prints each
    form's round wall and peak memory."""
    import torch

    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel

    out = check_scaffold_c_round0(dev)
    layout = bucketed_layout(SCAFFOLD_ROUNDS)
    sampled = sampled_clients(SCAFFOLD_ROUNDS)
    forms = [("vmapped", VMAPPED, SCAFFOLD_ROUNDS),
             ("bucketed", VMAPPED | BUCKETED, sum(r[0] for r in layout)),
             ("sequential", dict(cohort_mode="sequential"), SCAFFOLD_ROUNDS)]
    kept, launches, twin_bytes = {}, {}, 0
    for label, kw, want in forms:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(rr_indices_kernel)
        t0 = time.perf_counter()
        res = run_main_path(dev, "device", SCAFFOLD_ROUNDS, **SCAFFOLD, **kw)
        torch.cuda.synchronize()
        launches[label] = rr_indices_kernel.launches
        # the padded twin, held on the card for the later forms, left out
        peak = torch.cuda.max_memory_allocated() - twin_bytes
        wall = report_rounds(f"scaffold path, {label}", res, time.perf_counter() - t0, peak,
                             SCAFFOLD_ROUNDS)
        if launches[label] != want:
            raise AssertionError(f"scaffold path, {label}: rr_perm launched {launches[label]} "
                                 f"times, want {want}")
        nbytes = check_scaffold_bank(f"scaffold path, {label}", res.state, sampled)
        if not all(torch.isfinite(v).all() for v in res.state.opt["c"].values()):
            raise AssertionError(f"scaffold path, {label}: non-finite server c")
        state = res.state
        del res
        got = {**{f"params/{k}": v for k, v in state.params.items()},
               **{f"c/{k}": v for k, v in state.opt["c"].items()},
               **{f"bank/{k}": v for k, v in state.clients["scaffold"]["c"].items()}}
        if label == "vmapped":
            # the twin stays on the card (a host copy of the bank costs
            # seconds); the later forms' peaks leave its bytes out
            held, kept = "twin", got
            twin_bytes = sum(v.numel() * v.element_size() for v in kept.values())
        elif label == "bucketed":
            held = "bitwise" if all(torch.equal(got[k], v) for k, v in kept.items()) else \
                held_to_twin("scaffold vmapped", got, {k: v.cpu() for k, v in kept.items()})
        else:
            worst = {part: max(float((got[k] - v).abs().max() / v.abs().max().clamp_min(1e-12))
                               for k, v in kept.items() if k.startswith(part))
                     for part in ("params", "c", "bank")}
            if worst["params"] > VMAPPED_SEQ_RTOL:
                raise AssertionError(f"scaffold sequential vs vmapped params: "
                                     f"{worst['params']:.3e} of a leaf's max (bound "
                                     f"{VMAPPED_SEQ_RTOL})")
            held = (f"params within {worst['params']:.3e} of a leaf's max (bound "
                    f"{VMAPPED_SEQ_RTOL}); c {worst['c']:.3e}, bank {worst['bank']:.3e} of "
                    f"theirs (not bounded: 1/(K eta) scales the rounding of y - x)")
        del state, got
        out[label] = {"round_ms": wall, "peak_bytes": peak, "bank_bytes": nbytes,
                      "rr_perm": launches[label], "held": held}
        print(f"scaffold path, {label}: rr_perm {launches[label]} launches, as predicted; "
              f"bank {nbytes} bytes ([33, ...] fp32, scratch and never-sampled rows zero); "
              f"round wall {wall:.1f} ms, peak {peak / 2**30:.3f} GiB (the padded twin held "
              f"aside excluded); vs the vmapped padded run: {held}", flush=True)
    del kept
    rows["rr_perm"]["scaffold_launches"] = launches
    torch.cuda.empty_cache()
    out["rules"] = chain_rule_paths(dev, rows)
    out["claim"] = scaffold_claim(dev)
    return out


def chain_rule_paths(dev, rows: dict) -> dict:
    """fedprox, local_clip and adam at full width, 2 rounds each, vmapped
    padded (rr_perm once a round), then all four rules on CharLM-tiny on
    the card against the port on the CPU (:func:`check_small_reference`)."""
    import torch

    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel

    out = {}
    rounds = 2
    for name in ("fedprox", "local_clip", "adam"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(rr_indices_kernel)
        t0 = time.perf_counter()
        res = run_main_path(dev, "device", rounds, **CHAIN_RULES[name], **VMAPPED)
        torch.cuda.synchronize()
        n = rr_indices_kernel.launches
        peak = torch.cuda.max_memory_allocated()
        wall = report_rounds(f"{name} path", res, time.perf_counter() - t0, peak, rounds)
        if n != rounds:
            raise AssertionError(f"{name} path: rr_perm launched {n} times in {rounds} rounds")
        if not all(torch.isfinite(v).all() for tree in res.state.opt.values()
                   for v in tree.values()):
            raise AssertionError(f"{name} path: non-finite optimizer state")
        del res
        rows["rr_perm"].setdefault("scaffold_launches", {})[name] = n
        out[name] = {"round_ms": wall, "peak_bytes": peak}
        print(f"{name} path (vmapped, {rounds} rounds): rr_perm {n}; round wall {wall:.1f} ms, "
              f"peak {peak / 2**30:.3f} GiB", flush=True)
    torch.cuda.empty_cache()
    for name, kw in CHAIN_RULES.items():
        t0 = time.perf_counter()
        worst, flips = check_small_reference(dev, **kw, **VMAPPED)
        out[f"tiny_{name}_err"] = worst
        print(f"CharLM-tiny {name} on the card vs the port on the CPU: max relative diff "
              f"{worst:.3e} (bound 1e-4), {flips} sign flips of a step "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def scaffold_claim(dev) -> dict:
    """``tests/test_client_transforms.py``'s claim on the card: the
    duplicated quadratic (copies 1, 2, 3) with partial participation (2 of
    3 clients), FedAvg and FedAvg + SCAFFOLD ``SCAFFOLD_CLAIM["rounds"]``
    rounds each (vmapped); SCAFFOLD must land within ``err`` of x* and under
    ``share`` of FedAvg's distance."""
    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.data.federated import FederatedPipeline, Population
    from repro_torch.data.tasks import DuplicatedQuadraticTask
    from repro_torch.fed.losses import make_quadratic_loss
    from repro_torch.fed.rounds import build_round_step
    from repro_torch.fed.strategy import bind_strategy

    task, loss = DuplicatedQuadraticTask(copies=(1, 2, 3)), make_quadratic_loss(3)
    errs, t0 = {}, time.perf_counter()
    for opt in ("sgd", "scaffold"):
        fl = FLConfig(num_clients=3, cohort_size=2, sampling="uniform", epochs=2, local_batch=1,
                      algorithm="fedavg", local_lr=0.05, server_lr=1.0, seed=3, server_opt=opt)
        pipe = FederatedPipeline(task, Population.build(fl, sizes=task.sizes()), fl)
        strat = bind_strategy(None, fl, loss, num_clients=3)
        step = build_round_step(loss, strat, fl, device=dev)
        state = strat.init({"x": torch.zeros(3, device=dev)})
        for r in range(SCAFFOLD_CLAIM["rounds"]):
            state, _ = step(state, pipe.round_batch(r))
        errs[opt] = float(np.linalg.norm(state.params["x"].cpu().numpy() - task.optimum()))
    print(f"scaffold claim ({SCAFFOLD_CLAIM['rounds']} rounds on the duplicated quadratic, "
          f"partial participation): |x - x*| fedavg {errs['sgd']:.6f}, fedavg+scaffold "
          f"{errs['scaffold']:.6f} (bound {SCAFFOLD_CLAIM['err']} and {SCAFFOLD_CLAIM['share']}x "
          f"fedavg's; {time.perf_counter() - t0:.1f} s)", flush=True)
    if not (errs["scaffold"] < SCAFFOLD_CLAIM["err"]
            and errs["scaffold"] < SCAFFOLD_CLAIM["share"] * errs["sgd"]):
        raise AssertionError(f"scaffold claim failed: {errs}")
    return errs


# main path 13: the fleet plane (sync faults, the buffered FedBuff server)
# and the Byzantine-robustness plane, on full-width CharLM-100M through
# run_charlm_e2e (cohort engine, rr_backend="device"), vmapped.
# (a) a tiered fleet with every fault; the deadline 20 caps the slowest
# tier (speed 1/4, latency 4) at 4 steps, under its clients' K of 9 and 12,
# and folds the caps into the bucket edges
FLEET_SYNC = dict(fleet="tiered", fleet_tiers=3, tier_spread=4.0, faults="dropout,straggler,abort",
                  drop_prob=0.125, straggler_prob=0.25, straggler_factor=3.0, round_deadline=20.0)
# (b) FedBuff: 8 clients in flight, a tick aggregates the first 4 arrivals
FLEET_BUFFERED = dict(server_mode="buffered", buffer_size=4, fleet="zipf_latency",
                      staleness="poly", staleness_power=0.5, faults="dropout", drop_prob=0.1)
# (c) a sign flip by a quarter of the clients, both guards, each aggregator
ROBUST = dict(attack="sign_flip", attack_frac=0.25, attack_scale=4.0, trim_frac=0.25, guard="full")
ROBUST_AGGREGATORS = ("coordinate_median", "trimmed_mean", "norm_clip", "centered_clip", "krum",
                      "multi_krum")
ROBUST_ROUNDS = 2
# the aggregators whose round is traced: the sorting ones, and krum's Gram
ROBUST_TRACED = ("coordinate_median", "trimmed_mean", "krum")
# trimmed mean and the clips against the same estimator in fp64 on the same
# stack: each element within this share of its leaf's largest magnitude (an
# fp32 sum of 8 weighted terms is within 8 * 2^-24 = 4.8e-7 of its terms'
# magnitudes, whatever order it adds in; the clip factors add as much again)
ROBUST_FP64_RTOL = 1e-5
# the median's leaves recomputed on the CPU (the CPU's sorts of all 114 M
# coordinates would take minutes there)
MEDIAN_CPU_LEAVES = ("embed", "blocks/0/attn/wq", "blocks/11/mlp/down", "lm_head")
# (d) a blown round: the sign flip at 1e6 through the plain mean; SCAFFOLD
# gives the round an opt (c) and a bank for the guard to restore
REJECT = dict(attack="sign_flip", attack_frac=0.25, attack_scale=1e6, aggregator="mean",
              guard="reject", server_opt="scaffold")
# (e) the whole stack: (b)'s ticks, (c)'s attack, qsgd both ways, quarantine
# and the trimmed mean over the staleness-discounted coefficients
COMPOSED = {**FLEET_BUFFERED, **ROBUST, "aggregator": "trimmed_mean", "guard": "quarantine",
            **COMM}
COMPOSED_ROUNDS = 2
# (e) with a spike that quarantine removes: the sign flip at 64x (eight
# times SPIKE_MULT, so an adversary whose own update is an eighth of the
# median's still trips it), one round on tick 2 of the buffered schedule,
# whose 4 arrivals hold one adversary and are stale by [2, 2, 0, 1] ticks
# (quarantine_path checks both on the host plan)
QUARANTINE = {**COMPOSED, "attack_scale": 64.0}
QUARANTINE_TICK = 2
# the coefficients against the port's on the CPU and against the fp64
# renormalization: each within this share of the largest (a few fp32 ulps)
QUARANTINE_COEFF_RTOL = 1e-6


def e2e_host_plans(rounds: int, **kw):
    """The e2e run's host pipeline and its index plans for rounds
    0..rounds-1 as the cohort engine makes them (bucketized under
    ``exec_mode="bucketed"``), without task data."""
    from repro_torch.data.federated import FederatedPipeline, Population
    from repro_torch.launch.train import charlm_e2e_config

    _, fl = charlm_e2e_config(**kw)
    pipe = FederatedPipeline(None, Population.build(fl), fl)
    plans = [pipe.index_plan(r, with_idx=False) for r in range(rounds)]
    if fl.exec_mode == "bucketed":
        plans = [pipe.bucketize(p) for p in plans]
    return pipe, plans


def rr_launches_of(plans) -> int:
    """rr_perm launches the device plane makes for these host plans: one a
    padded round, one a bucket the round runs (``bucketing.occupied``)."""
    from repro_torch.data.federated import BucketedPlan
    from repro_torch.fed.bucketing import occupied

    return sum(len(occupied(p.buckets, p.pos)[0]) if isinstance(p, BucketedPlan) else 1
               for p in plans)


def fleet_round(dev, label: str, rounds: int, kw: dict, plans):
    """One path-13 run through ``run_charlm_e2e`` with rr_perm's count set
    to 0 just before and read just after, held to the launches its host
    plans predict; returns (result, round wall ms, peak bytes, launches)."""
    import torch

    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rr_indices_kernel)
    t0 = time.perf_counter()
    res = run_main_path(dev, "device", rounds, **kw)
    torch.cuda.synchronize()
    n = rr_indices_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    wall = report_rounds(label, res, time.perf_counter() - t0, peak, rounds)
    want = rr_launches_of(plans)
    if n != want:
        raise AssertionError(f"{label}: rr_perm launched {n} times, the host plans make {want}")
    return res, wall, peak, n


def host_fleet_metrics(meta) -> dict:
    """The fleet keys a round's metrics must carry, from its host plan's
    meta in numpy fp32 (the round computes them in fp32 on the card)."""
    f32 = np.float32
    valid = meta.valid.astype(f32)
    return {"round_virtual_time": float((meta.arrive_time.astype(f32) * valid).max()),
            "arrived_clients": float(valid.sum()),
            "dropped_clients": float(meta.dropped.astype(f32).sum()),
            "mean_staleness": float((meta.staleness.astype(f32) * valid).sum()
                                    / max(f32(valid.sum()), f32(1.0)))}


def check_fleet_rows(label: str, rows, plans) -> None:
    for r, p in zip(rows, plans):
        want = host_fleet_metrics(p.meta)
        got = {k: r[k] for k in want}
        if got != want:
            raise AssertionError(f"{label} round {r['round']}: fleet metrics {got}, host plan "
                                 f"{want}")


def sync_fleet_path(dev) -> dict:
    """(a): the tiered fleet with dropout, stragglers and the deadline, 4
    rounds vmapped padded and bucketed (the abort caps folded into the
    bucket edges), held bitwise by ``held_bitwise``; every round's
    ``round_virtual_time`` and dropped and arrived counts equal to its host
    plan's."""
    import torch

    out = {}
    pipe, plans = e2e_host_plans(ROUNDS, **FLEET_SYNC, **VMAPPED, **BUCKETED)
    unfolded, _ = e2e_host_plans(0, **VMAPPED, **BUCKETED)
    out["edges"] = {"folded": list(pipe.bucket_layout.edges),
                    "caps": list(pipe.bucket_layout.caps),
                    "unfolded": list(unfolded.bucket_layout.edges),
                    "deadline_caps_by_tier": [sorted({int(c) for c in pipe.fleet.deadline_caps(
                        FLEET_SYNC["round_deadline"])[pipe.fleet.tier == t]}) for t in range(3)]}
    print(f"sync fleet: deadline caps by tier {out['edges']['deadline_caps_by_tier']}; bucket "
          f"edges with the caps folded in {out['edges']['folded']} (caps "
          f"{out['edges']['caps']}), without {out['edges']['unfolded']}", flush=True)
    twin = None
    for label, kw in (("padded", {}), ("bucketed", BUCKETED)):
        _, pplans = e2e_host_plans(ROUNDS, **FLEET_SYNC, **VMAPPED, **kw)
        res, wall, peak, n = fleet_round(dev, f"sync fleet path, {label}", ROUNDS,
                                         {**FLEET_SYNC, **VMAPPED, **kw}, pplans)
        check_fleet_rows(f"sync fleet {label}", res.metrics.rows, plans)
        vt = [(r["round_virtual_time"], r["arrived_clients"], r["dropped_clients"])
              for r in res.metrics.rows]
        if twin is None:
            twin = {k: v.cpu() for k, v in res.state.params.items()}
            held = "twin"
        else:
            held = held_bitwise("sync fleet, bucketed", res.state.params, twin)
        del res
        out[label] = {"round_ms": wall, "peak_bytes": peak, "rr_perm": n, "held": held,
                      "virtual_time_arrived_dropped": vt}
        print(f"sync fleet path, {label}: (round_virtual_time, arrived, dropped) a round {vt}, "
              f"equal to the host plans'; rr_perm {n}; round wall {wall:.1f} ms, peak "
              f"{peak / 2**30:.3f} GiB; vs padded: {held}", flush=True)
    torch.cuda.empty_cache()
    out["padded"]["trace"] = traced_round(dev, "sync fleet, padded", {**FLEET_SYNC, **VMAPPED})
    return out


def held_bitwise(label: str, got: dict, want: dict) -> str:
    """Path 13's bucketed (or plain-kernel) runs against their padded twins:
    every leaf bitwise equal, or raise naming the leaves that differ and
    their largest difference.  ``want`` on the host or on the card."""
    import torch

    differ = {}
    for k, w in want.items():
        g = got[k].to(w.device)
        if not torch.equal(g, w):
            differ[k] = float((g.double() - w.double()).abs().max())
    if differ:
        raise AssertionError(f"{label}: not bitwise equal to its padded twin in "
                             f"{len(differ)} leaves, largest differences {differ}")
    return "bitwise"


def traced_round(dev, label: str, kw: dict) -> tuple[int, float]:
    """(device kernels and copies, their device ms) of one round of a
    path-13 configuration (:func:`round_kernels`), printed."""
    t0 = time.perf_counter()
    n, ms = round_kernels(dev, **kw)
    print(f"{label}: one round {n} device kernels and copies, {ms:.1f} ms of device time "
          f"(traced in {time.perf_counter() - t0:.1f} s)", flush=True)
    return n, ms


def schedule_counts(pipe, ticks: int) -> tuple[np.ndarray, np.ndarray]:
    """Each client's aggregations and summed staleness over the buffered
    schedule's ticks 0..ticks-1 ([N+1] fp32, the scratch row 0)."""
    n = pipe.population.num_clients
    arrivals, stale = np.zeros(n + 1, np.float32), np.zeros(n + 1, np.float32)
    for t in range(ticks):
        tick = pipe._fleet_sched.tick(t)
        np.add.at(arrivals, tick.ids, np.float32(1.0))
        np.add.at(stale, tick.ids, tick.staleness.astype(np.float32))
    return arrivals, stale


def buffered_path(dev) -> dict:
    """(b): the buffered FedBuff server, 4 ticks vmapped padded and
    bucketed, held bitwise; the fleet bank's ``arrivals`` / ``stale_sum``
    equal to the schedule's own counts; each tick's fleet metrics equal to
    its host plan's."""
    import torch

    out = {}
    pipe, plans = e2e_host_plans(ROUNDS, **FLEET_BUFFERED, **VMAPPED)
    arrivals, stale = schedule_counts(pipe, ROUNDS)
    twin = None
    for label, kw in (("padded", {}), ("bucketed", BUCKETED)):
        _, pplans = e2e_host_plans(ROUNDS, **FLEET_BUFFERED, **VMAPPED, **kw)
        res, wall, peak, n = fleet_round(dev, f"buffered path, {label}", ROUNDS,
                                         {**FLEET_BUFFERED, **VMAPPED, **kw}, pplans)
        check_fleet_rows(f"buffered {label}", res.metrics.rows, plans)
        bank = {k: v.cpu() for k, v in res.state.clients["fleet"].items()}
        if not (np.array_equal(bank["arrivals"].numpy(), arrivals)
                and np.array_equal(bank["stale_sum"].numpy(), stale)):
            raise AssertionError(f"buffered {label}: fleet bank {bank} vs the schedule's counts "
                                 f"{arrivals}, {stale}")
        got = {**{f"params/{k}": v for k, v in res.state.params.items()},
               **{f"fleet/{k}": v for k, v in res.state.clients["fleet"].items()}}
        if twin is None:
            twin, held = {k: v.cpu() for k, v in got.items()}, "twin"
        else:
            held = held_bitwise("buffered, bucketed", got, twin)
        del res, got
        out[label] = {"tick_ms": wall, "peak_bytes": peak, "rr_perm": n, "held": held}
        print(f"buffered path, {label}: {ROUNDS} ticks of {pipe.fl.buffer_size} arrivals "
              f"({pipe.cohort_slots} slots); fleet bank equal to the schedule's counts "
              f"(arrivals {int(arrivals.sum())}, stale_sum {float(stale.sum())}); rr_perm {n}; "
              f"tick wall {wall:.1f} ms, peak {peak / 2**30:.3f} GiB; vs padded: {held}",
              flush=True)
    torch.cuda.empty_cache()
    out["padded"]["trace"] = traced_round(dev, "buffered, padded", {**FLEET_BUFFERED, **VMAPPED})
    return out


@contextlib.contextmanager
def captured_aggregator(name: str):
    """Swap the registered robust aggregator ``name`` for a wrapper that
    keeps round 0's inputs and output on the card (the decoded, scrubbed
    [C] stack the round hands it, its renormalized coefficients), and put
    the original back after."""
    from repro_torch.fed.robust import ROBUST_AGGS, register_robust_agg

    inner = ROBUST_AGGS[name]
    seen: dict = {}

    def wrapper(deltas, coeff, meta, fl):
        out = inner(deltas, coeff, meta, fl)
        if not seen:
            seen.update(deltas=deltas, coeff=coeff, out=out)
        return out

    register_robust_agg(name, wrapper, overwrite=True)
    try:
        yield seen
    finally:
        register_robust_agg(name, inner, overwrite=True)


def _bcast64(w, like):
    return w.double().reshape((-1,) + (1,) * (like.dim() - 1))


def robust_fp64(name: str, deltas, coeff, trim: float) -> dict:
    """trimmed_mean, norm_clip and centered_clip in fp64 over the same
    stack and coefficients (the estimators' definitions, as
    ``fed/robust/aggregators.py`` states them)."""
    import torch

    cf = coeff.double()
    W = cf.sum()
    keep = coeff > 0
    if name == "trimmed_mean":
        lo, hi = trim * W, (1.0 - trim) * W
        out = {}
        for k, x in deltas.items():
            xs, order = torch.sort(x.double(), dim=0, stable=True)
            ws = _bcast64(cf, x).expand(x.shape).gather(0, order)
            cw_hi = torch.cumsum(ws, 0)
            eff = cw_hi.clamp(lo, hi) - (cw_hi - ws).clamp(lo, hi)
            out[k] = (eff * xs).sum(0) / (hi - lo) * W
        return out
    norm = sum(x.double().square().flatten(1).sum(1) for x in deltas.values()).sqrt()
    valid_norms = torch.sort(norm[keep]).values
    tau = valid_norms[(valid_norms.numel() - 1) // 2]          # the lower median
    if name == "norm_clip":
        fac = torch.clamp(tau / norm.clamp_min(1e-12), max=1.0)
        return {k: torch.einsum("c,c...->...", cf * fac, x.double()) for k, x in deltas.items()}
    v = {k: torch.zeros(x.shape[1:], dtype=torch.float64, device=x.device)
         for k, x in deltas.items()}
    for _ in range(3):
        r = sum((x.double() - v[k]).square().flatten(1).sum(1) for k, x in deltas.items()).sqrt()
        fac = torch.clamp(tau / r.clamp_min(1e-12), max=1.0)
        v = {k: v[k] + torch.einsum("c,c...->...", cf / W * fac, x.double() - v[k])
             for k, x in deltas.items()}
    return {k: vl * W for k, vl in v.items()}


def krum_selection64(deltas, coeff) -> list[int]:
    """Clients in order of their krum score recomputed in fp64 from the same
    stack: the sum of squared distances to every other valid client (the
    rule the reference's threshold search realizes, ROADMAP §3); invalid
    (zero-coefficient) clients last."""
    import torch

    g = sum(torch.einsum("cn,en->ce", x.double().flatten(1), x.double().flatten(1))
            for x in deltas.values())
    sq = torch.diagonal(g)
    dist = (sq[:, None] + sq[None, :] - 2.0 * g).clamp_min(0.0)
    m = (coeff > 0).double()
    C = m.numel()
    pair = m[:, None] * m[None, :] * (1.0 - torch.eye(C, dtype=torch.float64, device=m.device))
    scores = torch.where(m > 0, (pair * dist).sum(1), torch.inf)
    return torch.sort(scores, stable=True).indices.tolist()


def check_robust_round0(name: str, seen: dict) -> dict:
    """Round 0's aggregate against its references on the same stack: the
    median bitwise against the plain torch aggregator on the CPU (the
    leaves in ``MEDIAN_CPU_LEAVES``), trimmed mean and the clips within
    ``ROBUST_FP64_RTOL`` of fp64, krum's and multi-krum's selections equal
    to fp64's."""
    import torch

    from repro_torch.fed.robust.aggregators import ROBUST_AGGS, _krum_scores
    from repro_torch.launch.train import charlm_e2e_config

    deltas, coeff, out = seen["deltas"], seen["coeff"], seen["out"]
    fl = charlm_e2e_config(**ROBUST, aggregator=name)[1]
    res = {"valid": int((coeff > 0).sum())}
    if name == "coordinate_median":
        sub = {k: deltas[k].cpu() for k in MEDIAN_CPU_LEAVES}
        cpu = ROBUST_AGGS[name](sub, coeff.cpu(), None, fl)
        differ = [k for k in sub if not torch.equal(cpu[k], out[k].cpu())]
        if differ:
            raise AssertionError(f"coordinate_median: card vs CPU differ in {differ}")
        res["held"] = f"bitwise against the CPU on {len(sub)} leaves"
    elif name in ("krum", "multi_krum"):
        scores, k = _krum_scores(deltas, coeff, fl.trim_frac)
        order32 = torch.sort(scores, stable=True).indices.tolist()
        order64 = krum_selection64(deltas, coeff)
        k = int(k)
        if name == "krum":
            sel, sel64 = order32[0], order64[0]
            W = coeff.float().sum()
            if sel != sel64 or not all(torch.equal(out[n], (x[sel] * W).to(x.dtype))
                                       for n, x in deltas.items()):
                raise AssertionError(f"krum selected {sel}, fp64 {sel64}")
            res["held"] = f"selected client slot {sel}, as fp64"
        else:
            if set(order32[:k]) != set(order64[:k]):
                raise AssertionError(f"multi_krum kept {order32[:k]}, fp64 {order64[:k]}")
            res["held"] = f"kept slots {sorted(order32[:k])} (k {k}), as fp64"
    else:
        ref = robust_fp64(name, deltas, coeff, fl.trim_frac)
        worst = max(float((out[k].double() - r).abs().max() / r.abs().max().clamp_min(1e-30))
                    for k, r in ref.items())
        if worst > ROBUST_FP64_RTOL:
            raise AssertionError(f"{name}: {worst:.3e} of a leaf's max off fp64 (bound "
                                 f"{ROBUST_FP64_RTOL})")
        res["held"] = f"within {worst:.3e} of a leaf's max of fp64 (bound {ROBUST_FP64_RTOL})"
    return res


def check_scaled_noise(dev) -> dict:
    """``scaled_noise`` on the card vs the CPU, bitwise: the adversary mask,
    the round keys and the noise over three of CharLM-100M's leaves."""
    import torch

    from repro_torch.fed.robust.attacks import ATTACKS, adversary_mask, attack_round_keys
    from repro_torch.launch.train import charlm_e2e_config

    fl = charlm_e2e_config(attack="scaled_noise", attack_frac=0.25, attack_scale=4.0)[1]
    shapes = {"embed": (512, 768), "blocks/0/mlp/up": (768, 3072),
              "blocks/1/mlp/up": (768, 3072)}
    ids = torch.tensor([21, 9, 8, 27, 10, 4, 18, 2])
    outs, t = {}, {}
    for where in (dev, torch.device("cpu")):
        i = ids.to(where)
        adv = adversary_mask(fl.seed, i, fl.attack_frac)
        keys = attack_round_keys(fl.seed, i, 3)
        deltas = {k: torch.zeros((8, *s), device=where) for k, s in shapes.items()}
        t0 = time.perf_counter()
        noise = ATTACKS["scaled_noise"](deltas, torch.ones(8, device=where), None, keys, fl)
        torch.cuda.synchronize()
        t[where.type] = time.perf_counter() - t0
        outs[where.type] = (adv.cpu(), keys.cpu(), {k: v.cpu() for k, v in noise.items()})
    (a, k, n), (ca, ck, cn) = outs[dev.type], outs["cpu"]
    if not (torch.equal(a, ca) and torch.equal(k, ck) and all(torch.equal(n[x], cn[x]) for x in n)):
        raise AssertionError("scaled_noise: card vs CPU not bitwise")
    values = sum(v.numel() for v in n.values())
    print(f"scaled_noise on the card vs the CPU: adversary mask, round keys and {values} noise "
          f"values bitwise equal ({t[dev.type]:.3f} s on the card, {t['cpu']:.3f} s on the CPU)",
          flush=True)
    return {"values": values, "card_s": t[dev.type], "cpu_s": t["cpu"]}


def robust_paths(dev) -> tuple[dict, dict]:
    """(c): under (``ROBUST``) each aggregator 2 rounds vmapped padded, each
    round 0 held to its reference (:func:`check_robust_round0`); returns the
    results and the trimmed mean's params (on the host) for (f)."""
    import torch

    out = {"scaled_noise": check_scaled_noise(dev)}
    _, plans = e2e_host_plans(ROBUST_ROUNDS, **ROBUST, **VMAPPED)
    kept = None
    for name in ROBUST_AGGREGATORS:
        with captured_aggregator(name) as seen:
            res, wall, peak, n = fleet_round(dev, f"robust path, {name}", ROBUST_ROUNDS,
                                             {**ROBUST, "aggregator": name, **VMAPPED}, plans)
        rrows = res.metrics.rows
        if name == "trimmed_mean":
            kept = {k: v.cpu() for k, v in res.state.params.items()}
        del res
        held_bytes = sum(v.numel() * v.element_size() for v in seen["deltas"].values())
        chk = check_robust_round0(name, seen)
        seen.clear()
        torch.cuda.empty_cache()
        counts = [(r["quarantined_clients"], r["suspected_adversaries"], r["rounds_rejected"])
                  for r in rrows]
        out[name] = {"round_ms": wall, "peak_bytes": peak, "held_stack_bytes": held_bytes,
                     "rr_perm": n, "quarantined_suspected_rejected": counts, **chk}
        print(f"robust path, {name}: (quarantined, suspected, rejected) a round {counts}; "
              f"rr_perm {n}; round wall {wall:.1f} ms, peak {peak / 2**30:.3f} GiB (with round "
              f"0's [C] stack, {held_bytes / 2**30:.3f} GiB, held for the check); round 0: "
              f"{chk['held']}", flush=True)
    for name in ROBUST_TRACED:
        out[name]["trace"] = traced_round(dev, f"robust, {name}",
                                          {**ROBUST, "aggregator": name, **VMAPPED})
    return out, kept


def reject_path(dev) -> dict:
    """(d): a blown round (``REJECT``) through a round step built by hand:
    ``rounds_rejected`` 1, the params, SCAFFOLD's c and its [33, ...] bank
    bitwise equal to the round's input, ``rnd`` advanced."""
    import torch

    from repro_torch.utils.pytree import flatten, tree_map

    step, state, eng, *_ = round_setup(dev, warm_up=False, **REJECT, **VMAPPED)
    before = tree_map(torch.clone, {"params": state.params, "opt": state.opt,
                                    "bank": state.clients})
    t0 = time.perf_counter()
    state, mets = step(state, eng.device_plan(0))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    after = {"params": state.params, "opt": state.opt, "bank": state.clients}
    after, before = flatten(after), flatten(before)
    same = after.keys() == before.keys() and all(torch.equal(after[k], v)
                                                 for k, v in before.items())
    if float(mets["rounds_rejected"]) != 1.0 or not same or state.rnd != 1:
        raise AssertionError(f"reject path: rounds_rejected {float(mets['rounds_rejected'])}, "
                             f"state restored {same}, rnd {state.rnd}")
    peak = torch.cuda.max_memory_allocated()
    del state, before, after, step, eng
    torch.cuda.empty_cache()
    print(f"reject path: rounds_rejected 1; params, c and the [33, ...] bank bitwise equal to "
          f"the round's input; rnd 0 -> 1; round wall {wall:.1f} ms, peak {peak / 2**30:.3f} "
          f"GiB (with the input's copy)", flush=True)
    return {"round_ms": wall, "peak_bytes": peak, "delta_norm": float(mets["delta_norm"])}


def composed_path(dev, rows: dict) -> dict:
    """(e): ``COMPOSED``, 2 ticks vmapped padded and bucketed, held
    bitwise over params, the fleet counters and the downlink references
    (the padded twin's bank held on the card, its bytes left out of the
    later runs' peaks); the quantize kernels' launches (12 wire leaves a
    direction, one launch of each kernel a leaf and a direction a tick).
    Between the two, the padded run again on the kernels' plain versions
    (``rr_backend="device_ref"``, ``uplink_backend="ref"``), held bitwise:
    it holds rr_perm over the [12, K, 4] slots of a tick and both quantize
    kernels over the [12, ...] wire stacks of attacked deltas, shapes no
    earlier path gives them."""
    import torch

    from repro_torch.kernels.quantize.kernel import quantize_pack_kernel, unpack_dequantize_kernel
    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel

    out, twin, twin_bytes = {}, None, 0
    want_q = 2 * len(e2e_wire_leaves()) * COMPOSED_ROUNDS

    def state_of(res) -> dict:
        return {**{f"params/{k}": v for k, v in res.state.params.items()},
                **{f"fleet/{k}": v for k, v in res.state.clients["fleet"].items()},
                **{f"ref/{k}": v for k, v in res.state.clients["downlink"]["ref"].items()}}

    for label, kw in (("padded", {}), ("plain kernels", None), ("bucketed", BUCKETED)):
        if kw is None:
            torch.cuda.empty_cache()
            kernels = (rr_indices_kernel, quantize_pack_kernel, unpack_dequantize_kernel)
            zero_counts(*kernels)
            res = run_main_path(dev, "device_ref", COMPOSED_ROUNDS, uplink_backend="ref",
                                **COMPOSED, **VMAPPED)
            n = [k.launches for k in kernels]
            if n != [0, 0, 0]:
                raise AssertionError(f"composed, plain kernels: kernel launches {n}, want none")
            got = state_of(res)
            del res
            out[label] = held_bitwise("composed, plain kernels", got, twin)
            del got
            print("composed path, padded with rr_backend='device_ref', uplink_backend='ref': "
                  "params, fleet bank and downlink refs bitwise equal to the kernels' run",
                  flush=True)
            continue
        _, plans = e2e_host_plans(COMPOSED_ROUNDS, **COMPOSED, **VMAPPED, **kw)
        zero_counts(quantize_pack_kernel, unpack_dequantize_kernel)
        res, wall, peak, n = fleet_round(dev, f"composed path, {label}", COMPOSED_ROUNDS,
                                         {**COMPOSED, **VMAPPED, **kw}, plans)
        q = (quantize_pack_kernel.launches, unpack_dequantize_kernel.launches)
        if q != (want_q, want_q):
            raise AssertionError(f"composed {label}: quantize launches {q}, want {want_q} each")
        got = state_of(res)
        rrows = res.metrics.rows
        del res
        if twin is None:
            twin, held = got, "twin"
            twin_bytes = sum(v.numel() * v.element_size() for v in got.values())
        else:
            peak -= twin_bytes
            held = held_bitwise(f"composed, {label}", got, twin)
        del got
        out[label] = {"tick_ms": wall, "peak_bytes": peak, "rr_perm": n, "quantize": q[0],
                      "unpack": q[1], "held": held,
                      "quarantined": [r["quarantined_clients"] for r in rrows]}
        rows["quantize_pack"].setdefault("fleet_robust_launches", {})[label] = q[0]
        rows["unpack_dequantize"].setdefault("fleet_robust_launches", {})[label] = q[1]
        print(f"composed path, {label}: quantize_pack {q[0]}, unpack_dequantize {q[1]} "
              f"launches, rr_perm {n}; quarantined a tick {out[label]['quarantined']}; tick wall "
              f"{wall:.1f} ms, peak {peak / 2**30:.3f} GiB (the padded twin held aside "
              f"excluded); vs padded: {held}", flush=True)
    del twin
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def captured_quarantine():
    """Swap ``fed/rounds.py``'s ``quarantine_masks`` and
    ``renormalize_coeffs`` for wrappers that keep what they see (the raw
    decoded [C] stack, the healthy mask, the coefficients before and after),
    and put the originals back after."""
    from repro_torch.fed import rounds

    inner_q, inner_r = rounds.quarantine_masks, rounds.renormalize_coeffs
    seen: dict = {}

    def masks(deltas, meta):
        healthy, suspected = inner_q(deltas, meta)
        seen.update(raw=dict(deltas), healthy=healthy, suspected=suspected)
        return healthy, suspected

    def renorm(coeff, healthy):
        out = inner_r(coeff, healthy)
        seen.update(coeff0=coeff, coeff=out)
        return out

    rounds.quarantine_masks, rounds.renormalize_coeffs = masks, renorm
    try:
        yield seen
    finally:
        rounds.quarantine_masks, rounds.renormalize_coeffs = inner_q, inner_r


def quarantine_path(dev) -> dict:
    """(e) with a planted spike (``QUARANTINE``): one round on tick
    ``QUARANTINE_TICK`` through a round step built by hand, in which
    quarantine removes the adversary (``quarantined_clients`` > 0).  Held,
    from the raw decoded stack the round hands the guard: the healthy mask
    against fp64 norms over the valid, finite slots' lower median; the
    staleness-discounted coefficients against the port's on the CPU from the
    host plan (and unlike the undiscounted ones); the renormalized ones
    against the fp64 renormalization, their total mass kept; the scrubbed
    stack bitwise (the healthy slots' raw rows, zeros elsewhere); the
    trimmed mean over it within ``ROBUST_FP64_RTOL`` of fp64."""
    import torch

    from repro_torch.fed.robust.attacks import adversary_mask
    from repro_torch.fed.robust.guards import SPIKE_MULT
    from repro_torch.fed.rounds import as_device_meta
    from repro_torch.fed.strategy import bind_strategy

    _, plans = e2e_host_plans(QUARANTINE_TICK + 1, **QUARANTINE, **VMAPPED)
    meta = plans[-1].meta
    with captured_aggregator(QUARANTINE["aggregator"]) as agg:     # bound at bind time
        step, state, eng, _, _, fl = round_setup(dev, warm_up=False, **QUARANTINE, **VMAPPED)
    valid = torch.as_tensor(meta.valid, dtype=torch.float64)
    adv = adversary_mask(fl.seed, torch.as_tensor(meta.client_id), fl.attack_frac).double() * valid
    stale = meta.staleness * meta.valid
    if not 0 < float(adv.sum()) < float(valid.sum()) / 2 or not (stale > 0).any():
        raise AssertionError(f"quarantine: tick {QUARANTINE_TICK} has adversaries {adv.tolist()} "
                             f"and staleness {stale.tolist()}; want a minority and some > 0")
    cpu = bind_strategy(None, fl, None, num_clients=fl.num_clients)
    host_c = cpu.agg_coeffs(as_device_meta(meta, "cpu")).double()
    flat_c = cpu.agg_coeffs(as_device_meta(meta._replace(staleness=np.zeros_like(meta.staleness)),
                                           "cpu")).double()
    torch.cuda.reset_peak_memory_stats()
    with captured_quarantine() as seen:
        t0 = time.perf_counter()
        state, mets = step(state, eng.device_plan(QUARANTINE_TICK))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    if not all(torch.isfinite(v).all() for v in state.params.values()):
        raise AssertionError("quarantine: non-finite params")
    del state, step, eng
    raw, h = seen["raw"], seen["healthy"].double()
    norm = torch.sqrt(sum(x.double().square().flatten(1).sum(1) for x in raw.values()))
    fin = torch.stack([torch.isfinite(x).flatten(1).all(1) for x in raw.values()]).all(0)
    norms = torch.sort(norm[(valid.to(norm.device) > 0) & fin]).values
    med = norms[(norms.numel() - 1) // 2]
    healthy = (fin & ~(norm > SPIKE_MULT * med)).double()
    quarantined = float((valid.to(norm.device) * (1.0 - healthy)).sum())
    if not torch.equal(h, healthy) or quarantined < 1 \
            or float(mets["quarantined_clients"]) != quarantined:
        raise AssertionError(f"quarantine: healthy {h.tolist()}, fp64 {healthy.tolist()}; "
                             f"quarantined {float(mets['quarantined_clients'])}, fp64 {quarantined}")
    c0, c = seen["coeff0"].double(), seen["coeff"].double()
    err0 = float((c0.cpu() - host_c).abs().max() / host_c.abs().max())
    c64 = c0 * healthy * (c0.sum() / (c0 * healthy).sum())
    err = float((c - c64).abs().max() / c64.abs().max())
    mass = abs(float(c.sum() / c0.sum()) - 1.0)
    if max(err0, err, mass) > QUARANTINE_COEFF_RTOL or torch.equal(host_c, flat_c) \
            or not torch.equal(agg["coeff"], seen["coeff"]):
        raise AssertionError(f"quarantine: coefficients {err0:.3e} off the CPU's, {err:.3e} off "
                             f"fp64, mass off by {mass:.3e} (bound {QUARANTINE_COEFF_RTOL})")
    keep = healthy > 0
    for k, x in raw.items():
        want = torch.where(keep.reshape((-1,) + (1,) * (x.dim() - 1)), x, torch.zeros_like(x))
        if not torch.equal(agg["deltas"][k], want):
            raise AssertionError(f"quarantine: scrubbed {k} is not the healthy slots' raw rows")
    ref = robust_fp64(fl.aggregator, agg["deltas"], agg["coeff"], fl.trim_frac)
    worst = max(float((agg["out"][k].double() - r).abs().max() / r.abs().max().clamp_min(1e-30))
                for k, r in ref.items())
    if worst > ROBUST_FP64_RTOL:
        raise AssertionError(f"quarantine: {fl.aggregator} {worst:.3e} of a leaf's max off fp64 "
                             f"(bound {ROBUST_FP64_RTOL})")
    v = valid > 0
    discount = (host_c[v] / flat_c[v]).tolist()
    ratio = (norm / med).cpu()[v].tolist()
    seen.clear()
    agg.clear()
    del raw, ref
    torch.cuda.empty_cache()
    print(f"quarantine path (tick {QUARANTINE_TICK}, sign flip x{fl.attack_scale:g}): "
          f"quarantined_clients {quarantined:g}, suspected {float(mets['suspected_adversaries']):g}"
          f"; norm / median a valid slot {[round(r, 3) for r in ratio]}; healthy mask equal to "
          f"fp64's; staleness discounts {[round(d, 6) for d in discount]}; coefficients within "
          f"{err0:.3e} of the CPU's, renormalized within {err:.3e} of fp64, mass kept within "
          f"{mass:.3e} (bound {QUARANTINE_COEFF_RTOL}); scrubbed stack bitwise; {fl.aggregator} "
          f"within {worst:.3e} of fp64 (bound {ROBUST_FP64_RTOL}); round wall {wall:.1f} ms, "
          f"peak {peak / 2**30:.3f} GiB (with the raw and scrubbed stacks held)", flush=True)
    return {"round_ms": wall, "peak_bytes": peak, "quarantined_clients": quarantined,
            "suspected": float(mets["suspected_adversaries"]), "norm_ratio": ratio,
            "discount": discount, "coeff_vs_cpu": err0, "coeff_vs_fp64": err, "mass": mass,
            "aggregate_vs_fp64": worst}


def sequential_robust_path(dev, kept: dict) -> dict:
    """(f): (c)'s trimmed mean in the sequential cohort mode, 2 rounds,
    its params within ``VMAPPED_SEQ_RTOL`` of each leaf's largest magnitude
    of the vmapped run's."""
    kw = {**ROBUST, "aggregator": "trimmed_mean", "cohort_mode": "sequential"}
    _, plans = e2e_host_plans(ROBUST_ROUNDS, **kw)
    res, wall, peak, n = fleet_round(dev, "robust path, trimmed_mean, sequential", ROBUST_ROUNDS,
                                     kw, plans)
    worst = max(float((res.state.params[k].cpu() - v).abs().max() / v.abs().max().clamp_min(1e-12))
                for k, v in kept.items())
    del res
    if worst > VMAPPED_SEQ_RTOL:
        raise AssertionError(f"robust sequential vs vmapped: {worst:.3e} of a leaf's max (bound "
                             f"{VMAPPED_SEQ_RTOL})")
    print(f"robust path, trimmed_mean, sequential: params within {worst:.3e} of a leaf's max of "
          f"the vmapped run's (bound {VMAPPED_SEQ_RTOL}); rr_perm {n}; round wall {wall:.1f} ms, "
          f"peak {peak / 2**30:.3f} GiB", flush=True)
    return {"round_ms": wall, "peak_bytes": peak, "rr_perm": n, "worst_vs_vmapped": worst}


def fleet_robust_paths(dev, rows: dict) -> dict:
    """Main path 13, (a)-(f) above; each run's rr_perm count goes into
    ``rows["rr_perm"]["fleet_robust_launches"]``, (e)'s quantize counts
    into the quantize rows'."""
    t0 = time.perf_counter()
    out = {"sync_fleet": sync_fleet_path(dev), "buffered": buffered_path(dev)}
    out["robust"], kept = robust_paths(dev)
    out["reject"] = reject_path(dev)
    out["composed"] = composed_path(dev, rows)
    out["quarantine"] = quarantine_path(dev)
    out["sequential"] = sequential_robust_path(dev, kept)
    launches = {}
    for part in ("sync_fleet", "buffered", "composed"):
        for label in ("padded", "bucketed"):
            launches[f"{part}/{label}"] = out[part][label]["rr_perm"]
    for name in ROBUST_AGGREGATORS:
        launches[f"robust/{name}"] = out["robust"][name]["rr_perm"]
    launches["robust/sequential"] = out["sequential"]["rr_perm"]
    rows["rr_perm"]["fleet_robust_launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


# main path 14, the privacy plane and the obs plane.  (a) DP: the clip is
# the median of round 0's update norms (the planes-off run captures them),
# so some updates are clipped and some are not; the noise multiplier keeps
# the noise a small fraction of the clipped update a coordinate
DP_ON = dict(dp="on", dp_noise_mult=0.01, dp_delta=1e-5)
# (b) secure aggregation over (a)'s mechanism, qsgd both ways and a fleet
# whose dropout drops 1 client in round 0 and 2 in round 1 (the host plans)
SECAGG = dict(secagg="pairwise", secagg_bits=20, faults="dropout", drop_prob=0.125, **COMM)
SECAGG_ROUNDS = 2
# (c) (a) with every span and histogram
TELEMETRY = dict(telemetry="full")
# every plane off, its inactive knobs away from their defaults
PLANES_OFF = dict(dp_clip=123.0, dp_noise_mult=9.0, dp_delta=0.42, secagg_bits=24,
                  telemetry_bins=5)
# the noise's normals on the card against the plain function on the CPU:
# the uniforms are integers (bitwise), but fp32 log, cos and sqrt may each
# differ by a few ulps between the two, and |z| <= 6.7 for u in (0, 1)
NOISE_NORMAL_ATOL = 1e-5
# the leaf whose noise is recomputed: layer 11 of JAX's stacked MLP leaf, so
# its counters start 11 layers into the leaf
NOISE_LEAF = "blocks/11/mlp/down"
ROUND_SPANS = ("round/plan_wait", "round/step_dispatch", "round/metrics_fetch", "round/eval",
               "round/log", "round/checkpoint")


@contextlib.contextmanager
def captured_privacy():
    """Swap ``fed/rounds.py``'s ``dp_clip_cohort``, ``add_dp_noise`` and
    ``secagg_combine`` for wrappers that keep what they see, and put the
    originals back after: each round's slot norms (``obs.hist.slot_sqnorms``
    of the stack the clip gets) and clipped indicators, round 0's noise
    (the input and output of its last leaf, the sigma), round 0's secure
    aggregation (its inputs and output, on the card)."""
    import torch

    import repro_torch.fed.rounds as rounds
    from repro_torch.obs.hist import slot_sqnorms

    seen: dict = {"norms": [], "clipped": [], "noise": None, "secagg": None}
    clip0, noise0, sa0 = rounds.dp_clip_cohort, rounds.add_dp_noise, rounds.secagg_combine

    def clip(deltas, fl):
        # kept on the card: a copy to the host here would wait for the round
        out = clip0(deltas, fl)
        seen["norms"].append(torch.sqrt(slot_sqnorms(deltas)))
        seen["clipped"].append(out[1])
        return out

    def noise(delta_agg, coeff, valid, fl, rnd):
        out, sigma = noise0(delta_agg, coeff, valid, fl, rnd)
        if seen["noise"] is None:
            name = NOISE_LEAF if NOISE_LEAF in delta_agg else list(delta_agg)[-1]
            seen["noise"] = {"name": name, "in": delta_agg[name].clone(), "out": out[name].clone(),
                             "sigma": sigma, "rnd": int(rnd),
                             "shapes": {k: v.shape for k, v in delta_agg.items()}}
        return out, sigma

    def secagg(deltas, coeff, valid, dropped, client_id, rnd, fl, **kw):
        out = sa0(deltas, coeff, valid, dropped, client_id, rnd, fl, **kw)
        if seen["secagg"] is None:
            seen["secagg"] = {"deltas": deltas, "coeff": coeff, "valid": valid,
                              "dropped": dropped, "ids": client_id, "rnd": int(rnd), "fl": fl,
                              "out": out}
        return out

    rounds.dp_clip_cohort, rounds.add_dp_noise, rounds.secagg_combine = clip, noise, secagg
    try:
        yield seen
    finally:
        rounds.dp_clip_cohort, rounds.add_dp_noise, rounds.secagg_combine = clip0, noise0, sa0


@contextlib.contextmanager
def captured_norms():
    """Swap the strategy module's ``weighted_sum`` (the plane-off
    aggregate) for a wrapper that keeps round 0's slot norms, computed from
    the stack it gets; the aggregate is untouched."""
    import torch

    import repro_torch.fed.strategy as strategy
    from repro_torch.obs.hist import slot_sqnorms

    seen: list = []
    inner = strategy.weighted_sum

    def wrapper(deltas, coeff):
        if not seen:
            seen.append(torch.sqrt(slot_sqnorms(deltas)))
        return inner(deltas, coeff)

    strategy.weighted_sum = wrapper
    try:
        yield seen
    finally:
        strategy.weighted_sum = inner


@contextlib.contextmanager
def captured_hist_merges():
    """Record each ``Histogram.merge_counts`` of the registry (one a round
    and histogram in ``train()``): ``[(name, counts)]``."""
    from repro_torch.obs.metrics import Histogram

    seen: list = []
    inner = Histogram.merge_counts

    def wrapper(self, counts):
        seen.append((self.name, np.asarray(counts, np.float64).copy()))
        return inner(self, counts)

    Histogram.merge_counts = wrapper
    try:
        yield seen
    finally:
        Histogram.merge_counts = inner


def host_dp_rows(fl, plans, seen) -> list[tuple[float, float]]:
    """Each round's (``dp_clipped_frac``, ``dp_sigma``) recomputed on the
    host in fp32: the clipped indicator counted from the captured slot norms
    against ``fl.dp_clip`` (and held to the round's own), sigma by the
    formula ``dp_noise_mult * dp_clip * max(valid * |coeff|)`` over the
    coefficients of the port's strategy on the CPU from the host plan."""
    from repro_torch.fed.rounds import as_device_meta
    from repro_torch.fed.strategy import bind_strategy

    f32 = np.float32
    cpu = bind_strategy(None, fl, None, num_clients=fl.num_clients)
    out = []
    for plan, norms, clipped in zip(plans, seen["norms"], seen["clipped"]):
        valid = plan.meta.valid.astype(f32)
        norms, clipped = norms.cpu(), clipped.cpu()
        recount = (norms.numpy() > f32(fl.dp_clip)).astype(f32)
        if not np.array_equal(recount, clipped.numpy()):
            raise AssertionError(f"dp: clipped {clipped.tolist()} vs the host recount "
                                 f"{recount.tolist()} from norms {norms.tolist()}")
        coeff = cpu.agg_coeffs(as_device_meta(plan.meta, "cpu")).numpy()
        sigma = f32(fl.dp_noise_mult) * (f32(fl.dp_clip) * np.max(valid * np.abs(coeff)))
        out.append((float((recount * valid).sum() / max(valid.sum(), f32(1.0))), float(sigma)))
    return out


def check_noise_leaf(dev, fl, noise: dict) -> dict:
    """Round 0's noise on one leaf (a later layer of a stacked leaf: its
    counters start past the layers before it): the card's round output
    equal, bitwise, to its input plus sigma times the normals the plain
    function makes on the card; those normals' uniforms bitwise equal to
    the plain function's on the CPU, the normals within
    ``NOISE_NORMAL_ATOL``."""
    import torch

    from repro_torch.fed.privacy.dp import _std_normal, noise_key, noise_uniforms
    from repro_torch.kernels.rr_perm.ref import key_combine_torch
    from repro_torch.utils.pytree import wire_layout

    name, shapes = noise["name"], noise["shapes"]
    for i, (_, names) in enumerate(wire_layout(shapes)):
        if name in names:
            idx, off = i, sum(math.prod(shapes[k]) for k in names[:names.index(name)])
    leaf = noise["in"]
    n = leaf.numel()
    out = {}
    for where in (dev, torch.device("cpu")):
        lk = key_combine_torch(noise_key(fl.seed, noise["rnd"], where), idx)
        out[where.type] = (noise_uniforms(lk, n, off), _std_normal(lk, n, off))
    (u_card, z_card), (u_cpu, z_cpu) = out[dev.type], out["cpu"]
    again = (leaf.float() + noise["sigma"] * z_card.reshape(leaf.shape)).to(leaf.dtype)
    if not torch.equal(again, noise["out"]):
        raise AssertionError(f"dp noise on {name}: the round's output is not its input plus "
                             f"sigma times the plain normals")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(u_card, u_cpu)):
        raise AssertionError(f"dp noise on {name}: uniforms on the card differ from the CPU's")
    err = float((z_card.cpu() - z_cpu).abs().max())
    if err > NOISE_NORMAL_ATOL:
        raise AssertionError(f"dp noise on {name}: normals {err:.3e} off the CPU's (bound "
                             f"{NOISE_NORMAL_ATOL})")
    print(f"dp noise, round 0, {name} (JAX leaf {idx}, counters {off} .. {off + n - 1}): the "
          f"round's output bitwise its input + sigma {float(noise['sigma']):.6e} x the plain "
          f"normals; uniforms bitwise the CPU's; normals {err:.3e} off the CPU's (bound "
          f"{NOISE_NORMAL_ATOL})", flush=True)
    return {"leaf": name, "jax_leaf": idx, "offset": off, "values": n, "normal_err": err}


def planes_off_path(dev, vm_params: dict) -> tuple[dict, list[float]]:
    """(c2): every plane off with its inactive knobs moved (``PLANES_OFF``),
    4 rounds vmapped padded: params bitwise equal to the dense vmapped run
    (``vm_params["dense"]``); round 0's slot norms (the stack the aggregate
    gets) for (a)'s clip."""
    _, plans = e2e_host_plans(ROUNDS, **VMAPPED)
    with captured_norms() as norms:
        res, wall, peak, n = fleet_round(dev, "planes off", ROUNDS, {**PLANES_OFF, **VMAPPED},
                                         plans)
    keys = set(res.metrics.rows[0])
    if any(k.startswith(("dp_", "hist_")) for k in keys):
        raise AssertionError(f"planes off: keys {sorted(keys)}")
    held = held_bitwise("planes off vs the dense vmapped run", res.state.params, vm_params["dense"])
    del res
    print(f"planes off ({PLANES_OFF}): params {held} to the dense vmapped run; no dp_ or hist_ "
          f"key; rr_perm {n}; round wall {wall:.1f} ms, peak {peak / 2**30:.3f} GiB", flush=True)
    return {"round_ms": wall, "peak_bytes": peak, "rr_perm": n, "held": held}, \
        [float(v) for v in norms[0]]


def dp_path(dev, norms0: list[float], tmp: str) -> tuple[dict, dict, dict]:
    """(a): DP at a clip between round 0's norms, 4 rounds vmapped padded
    and bucketed (held bitwise), each round's ``dp_clipped_frac`` and
    ``dp_sigma`` equal to the host's recount and formula; 2 rounds, a DP
    server-state file, 2 more: params and ``dp_epsilon`` bitwise the
    straight run's, and a resume under another ``dp_noise_mult`` refused;
    one leaf's noise against the plain function on the CPU.  -> (its
    numbers, the DP knobs, the padded params on the host)."""
    import dataclasses
    import os

    import torch

    from repro_torch.fed.privacy import accountant_for, dp_checkpoint_record
    from repro_torch.fed.train_loop import SCHEDULES, train
    from repro_torch.launch.train import charlm_e2e_config
    from repro_torch.utils.checkpoint import load_metadata, load_server_state, save_server_state

    s = sorted(norms0)
    dp = {**DP_ON, "dp_clip": float(np.float32(0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2])))}
    out = {"dp_clip": dp["dp_clip"], "round0_norms": norms0}
    twin = None
    for label, kw in (("padded", {}), ("bucketed", BUCKETED)):
        _, plans = e2e_host_plans(ROUNDS, **dp, **VMAPPED, **kw)
        with captured_privacy() as seen:
            res, wall, peak, n = fleet_round(dev, f"dp path, {label}", ROUNDS,
                                             {**dp, **VMAPPED, **kw}, plans)
        rows = res.metrics.rows
        got = [(r["dp_clipped_frac"], r["dp_sigma"]) for r in rows]
        fl = charlm_e2e_config(**dp, **VMAPPED, **kw)[1]
        want = host_dp_rows(fl, plans, seen)
        if got != want:
            raise AssertionError(f"dp {label}: (dp_clipped_frac, dp_sigma) a round {got}, the "
                                 f"host's {want}")
        if not 0 < got[0][0] < 1:
            raise AssertionError(f"dp {label}: round 0 clipped fraction {got[0][0]}")
        acct = accountant_for(fl)
        eps = [r["dp_epsilon"] for r in rows]
        if eps != [acct.epsilon(r + 1) for r in range(ROUNDS)]:
            raise AssertionError(f"dp {label}: dp_epsilon {eps}")
        params = {k: v.cpu() for k, v in res.state.params.items()}
        if twin is None:
            twin, held, straight_rows = params, "twin", rows
            out["noise"] = check_noise_leaf(dev, fl, seen["noise"])
        else:
            held = held_bitwise("dp, bucketed", params, twin)
        del res, seen
        out[label] = {"round_ms": wall, "peak_bytes": peak, "rr_perm": n, "held": held,
                      "clipped_frac_sigma": got, "dp_epsilon": eps}
        print(f"dp path, {label}: clip {dp['dp_clip']:.6e}; (dp_clipped_frac, dp_sigma) a round "
              f"{got}, equal to the host's recount and formula; dp_epsilon {eps}; rr_perm {n}; "
              f"round wall {wall:.1f} ms, peak {peak / 2**30:.3f} GiB; vs padded: {held}",
              flush=True)
    # 2 rounds, the DP server-state file, 2 more (the first half takes the
    # staircase of the unbroken 4-round run, as resume_path does)
    torch.cuda.empty_cache()
    loss_fn, params, pipe, fl, strat = e2e_parts(dev, prefetch=0, **dp, **VMAPPED)
    run = dict(strategy=strat, log_every=0, device=dev)
    half, path = ROUNDS // 2, os.path.join(tmp, "dp_state.npz")
    staircase, first_half = SCHEDULES["staircase"], f"staircase_over_{ROUNDS}"
    SCHEDULES[first_half] = lambda r, total: staircase(r, ROUNDS)
    try:
        first = train(loss_fn, params, pipe, fl, half, schedule=first_half, **run)
    finally:
        del SCHEDULES[first_half]
    save_server_state(path, first.state, {"round": half - 1}, fl=fl)
    record = load_metadata(path)["dp_accounting"]
    if record != dp_checkpoint_record(fl, half):
        raise AssertionError(f"dp resume: record {record}")
    del first
    torch.cuda.empty_cache()
    try:
        load_server_state(path, strat.init(params), fl=dataclasses.replace(
            fl, dp_noise_mult=2 * fl.dp_noise_mult))
    except ValueError as e:
        refused = str(e).split(" — ")[0]
    else:
        raise AssertionError("dp resume under another dp_noise_mult was not refused")
    torch.cuda.empty_cache()
    restored = load_server_state(path, strat.init(params), fl=fl)
    res = train(loss_fn, params, pipe, fl, ROUNDS, schedule="staircase", state=restored,
                start_round=half, **run)
    held = held_bitwise("dp, resumed", {k: v.cpu() for k, v in res.state.params.items()}, twin)
    eps = [r["dp_epsilon"] for r in res.metrics.rows]
    if eps != [r["dp_epsilon"] for r in straight_rows[half:]]:
        raise AssertionError(f"dp resumed: dp_epsilon {eps}, straight "
                             f"{[r['dp_epsilon'] for r in straight_rows[half:]]}")
    del res, restored
    torch.cuda.empty_cache()
    out["resume"] = {"held": held, "dp_epsilon": eps, "record": record, "refused": refused}
    print(f"dp resumed ({half} + {ROUNDS - half} rounds through a DP server-state file): params "
          f"{held} to the straight run; dp_epsilon {eps} bitwise its; the record {record}; a "
          f"resume at dp_noise_mult x2 refused ({refused})", flush=True)
    return out, dp, twin


def secagg_path(dev, dp: dict, rows: dict) -> dict:
    """(b): ``SECAGG`` over (a)'s DP, 2 rounds vmapped padded and bucketed,
    held bitwise over params and downlink refs; the quantize kernels 12
    launches each a direction and round; on round 0's captured stack (one
    client dropped), the masked aggregate bitwise ``secagg_reference``,
    every dispatched client's payload unlike its encoding, and the
    aggregate within the fixed-point grid of the float ``weighted_sum``."""
    import torch

    from repro_torch.kernels.quantize.kernel import quantize_pack_kernel, unpack_dequantize_kernel

    kw = {**dp, **SECAGG, **VMAPPED}
    want_q = 2 * len(e2e_wire_leaves()) * SECAGG_ROUNDS
    out, twin = {}, None
    for label, lay in (("padded", {}), ("bucketed", BUCKETED)):
        _, plans = e2e_host_plans(SECAGG_ROUNDS, **kw, **lay)
        drops = [int(p.meta.dropped.sum()) for p in plans]
        if drops[0] < 1:
            raise AssertionError(f"secagg: no client dropped in round 0 ({drops})")
        zero_counts(quantize_pack_kernel, unpack_dequantize_kernel)
        with captured_privacy() as seen:
            res, wall, peak, n = fleet_round(dev, f"secagg path, {label}", SECAGG_ROUNDS,
                                             {**kw, **lay}, plans)
        q = (quantize_pack_kernel.launches, unpack_dequantize_kernel.launches)
        if q != (want_q, want_q):
            raise AssertionError(f"secagg {label}: quantize launches {q}, want {want_q} each")
        got = {**{f"params/{k}": v.cpu() for k, v in res.state.params.items()},
               **{f"ref/{k}": v.cpu() for k, v in res.state.clients["downlink"]["ref"].items()}}
        del res
        if twin is None:
            twin, held = got, "twin"
            out["round0"] = check_secagg_round0(seen["secagg"])
        else:
            held = held_bitwise(f"secagg, {label}", got, twin)
        del seen, got
        torch.cuda.empty_cache()
        out[label] = {"round_ms": wall, "peak_bytes": peak, "rr_perm": n, "quantize": q[0],
                      "unpack": q[1], "held": held, "dropped": drops}
        rows["quantize_pack"].setdefault("privacy_obs_launches", {})[label] = q[0]
        rows["unpack_dequantize"].setdefault("privacy_obs_launches", {})[label] = q[1]
        print(f"secagg path, {label}: dropped a round {drops}; quantize_pack {q[0]}, "
              f"unpack_dequantize {q[1]}, rr_perm {n}; round wall {wall:.1f} ms, peak "
              f"{peak / 2**30:.3f} GiB; vs padded: {held}", flush=True)
    return out


def check_secagg_round0(sa: dict) -> dict:
    """Round 0's secure aggregation on the card, from what the round gave
    it (the decoded, clipped [C] stack, the coefficients, the fleet's
    dropped slots)."""
    import torch

    from repro_torch.fed.privacy import secagg_chunks, secagg_reference
    from repro_torch.fed.strategy import weighted_sum

    t0 = time.perf_counter()
    fl, deltas, coeff, valid = sa["fl"], sa["deltas"], sa["coeff"], sa["valid"]
    ref = secagg_reference(deltas, coeff, valid, fl)
    differ = [k for k in ref if not torch.equal(ref[k], sa["out"][k])]
    if differ:
        raise AssertionError(f"secagg round 0: masked aggregate vs secagg_reference differ in "
                             f"{differ}")
    del ref
    C = valid.shape[0]
    blinded = torch.zeros(C, dtype=torch.bool, device=valid.device)
    for _, _, enc, pay, _ in secagg_chunks(deltas, coeff, valid, sa["dropped"], sa["ids"],
                                           sa["rnd"], fl):
        blinded |= (pay != enc).any(1)
    dispatched = (valid + sa["dropped"]) > 0
    if not bool(blinded[dispatched].all()):
        raise AssertionError(f"secagg round 0: payload equal to its encoding for dispatched "
                             f"slots {torch.nonzero(dispatched & ~blinded).flatten().tolist()}")
    # the grid: each valid encoding rounds by at most half a step, the
    # decode and the fp32 weighted sum round by a few ulps of the terms
    coeff_v = (valid * coeff).float()
    plain = weighted_sum(deltas, coeff_v)
    step, n_valid, worst = 2.0 ** -fl.secagg_bits, float(valid.sum()), 0.0
    for k, agg in sa["out"].items():
        terms = torch.einsum("c,c...->...", coeff_v.abs(), deltas[k].float().abs())
        bound = n_valid * step / 2 + 2.0 ** -20 * terms
        worst = max(worst, float(((agg.float() - plain[k].float()).abs() / bound).max()))
    if worst > 1.0:
        raise AssertionError(f"secagg round 0: the aggregate off the float weighted_sum by "
                             f"{worst:.3f} of the fixed-point bound")
    info = {"dispatched": int(dispatched.sum()), "valid": int(n_valid),
            "dropped": int(sa["dropped"].sum()), "grid_share": worst,
            "check_s": time.perf_counter() - t0}
    print(f"secagg round 0 ({info['valid']} valid, {info['dropped']} dropped, recovered): masked "
          f"aggregate bitwise secagg_reference; all {info['dispatched']} dispatched payloads "
          f"unlike their encodings; within {worst:.3f} of the fixed-point bound of the float "
          f"weighted_sum ({info['check_s']:.1f} s)", flush=True)
    return info


def telemetry_path(dev, dp: dict, dp_params: dict, tmp: str) -> dict:
    """(c): (a)'s padded run with ``telemetry="full"`` through ``train()``
    at prefetch 2 with eval and a log line each round and a params file
    every other round, into
    a ``telemetry_dir``: params bitwise (a)'s; each round's ``hist_steps``
    summing to its valid count; ``hist_dp_scale`` in the summary; every
    ``round/*`` span in ``trace.json`` and ``prefetch/plan_build`` on the
    producer's thread; the spans' median ms printed."""
    import json
    import os

    import torch

    from repro_torch.fed.train_loop import train
    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel
    from repro_torch.utils.checkpoint import load_metadata

    torch.cuda.empty_cache()
    loss_fn, params, pipe, fl, strat = e2e_parts(dev, prefetch=2, **dp, **VMAPPED, **TELEMETRY)
    ev = pipe.task.batch(0, np.arange(4).reshape(1, 4))
    batch = {k: torch.as_tensor(v[0], device=dev) for k, v in ev.items()}
    tele, ckpt = os.path.join(tmp, "telemetry"), os.path.join(tmp, "tele_params")
    zero_counts(rr_indices_kernel)
    t0 = time.perf_counter()
    with captured_hist_merges() as merges:
        res = train(loss_fn, params, pipe, fl, ROUNDS, strategy=strat, schedule="staircase",
                    eval_fn=torch.no_grad()(lambda p: {"loss": loss_fn(p, batch)[0]}),
                    eval_every=1, log_every=1, checkpoint_path=ckpt, checkpoint_every=2,
                    telemetry_dir=tele, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = rr_indices_kernel.launches
    held = held_bitwise("telemetry full vs off", {k: v.cpu() for k, v in res.state.params.items()},
                        dp_params)
    rows = res.metrics.rows
    del res
    steps = [c for name, c in merges if name == "hist_steps"]
    if [float(c.sum()) for c in steps] != [r["cohort"] for r in rows]:
        raise AssertionError(f"telemetry: hist_steps sums {[c.sum() for c in steps]}, valid "
                             f"{[r['cohort'] for r in rows]}")
    summary = json.load(open(os.path.join(tele, "summary.json")))
    if "hist_dp_scale" not in summary["histograms"] or \
            summary["histograms"]["hist_dp_scale"]["total"] != sum(r["cohort"] for r in rows):
        raise AssertionError(f"telemetry: summary histograms {sorted(summary['histograms'])}")
    jsonl = [json.loads(line) for line in open(os.path.join(tele, "metrics.jsonl"))]
    if [r["round"] for r in jsonl] != list(range(ROUNDS)):
        raise AssertionError(f"telemetry: metrics.jsonl rounds {[r['round'] for r in jsonl]}")
    evs = json.load(open(os.path.join(tele, "trace.json")))["traceEvents"]
    threads = {e["tid"]: e["args"]["name"] for e in evs if e["name"] == "thread_name"}
    spans: dict = {}
    for e in evs:
        if e["ph"] == "X":
            spans.setdefault(e["name"], []).append((e["dur"] / 1e3, threads[e["tid"]]))
    missing = [s for s in ROUND_SPANS + ("prefetch/plan_build",) if s not in spans]
    if missing:
        raise AssertionError(f"telemetry: trace.json lacks spans {missing}")
    producer = {t for _, t in spans["prefetch/plan_build"]}
    if producer != {"cohort-prefetch"} or len(spans["prefetch/plan_build"]) != ROUNDS:
        raise AssertionError(f"telemetry: prefetch/plan_build on threads {producer}")
    if load_metadata(ckpt)["dp_accounting"]["rounds"] != ROUNDS:
        raise AssertionError("telemetry: the params file's dp_accounting record")
    medians = {k: float(np.median([d for d, _ in v])) for k, v in sorted(spans.items())}
    print("telemetry spans, median ms (count): " + ", ".join(
        f"{k} {medians[k]:.3f} ({len(spans[k])})" for k in medians), flush=True)
    print(f"telemetry path (full, telemetry_dir): params {held} to the dp path's; hist_steps a "
          f"round sums to its valid count; hist_dp_scale total "
          f"{summary['histograms']['hist_dp_scale']['total']}; every round/* span, "
          f"prefetch/plan_build on the cohort-prefetch thread; rr_perm {n}; {ROUNDS} rounds in "
          f"{wall:.2f} s with eval and logs each round, a params file every 2", flush=True)
    return {"held": held, "rr_perm": n, "span_median_ms": medians, "seconds": wall,
            "files": sorted(os.listdir(tele))}


def privacy_obs_paths(dev, vm_params: dict, rows: dict) -> dict:
    """Main path 14: (c2) every plane off, (a) DP, (b) secure aggregation
    composed, (c) telemetry; files in a temporary directory.  rr_perm
    counts go to ``rows["rr_perm"]["privacy_obs_launches"]``, (b)'s quantize
    counts to the quantize rows'."""
    import tempfile

    t0 = time.perf_counter()
    out = {}
    out["planes_off"], norms0 = planes_off_path(dev, vm_params)
    with tempfile.TemporaryDirectory() as tmp:
        out["dp"], dp, dp_params = dp_path(dev, norms0, tmp)
        out["secagg"] = secagg_path(dev, dp, rows)
        out["telemetry"] = telemetry_path(dev, dp, dp_params, tmp)
    rows["rr_perm"]["privacy_obs_launches"] = {
        "planes_off": out["planes_off"]["rr_perm"], "dp/padded": out["dp"]["padded"]["rr_perm"],
        "dp/bucketed": out["dp"]["bucketed"]["rr_perm"],
        "secagg/padded": out["secagg"]["padded"]["rr_perm"],
        "secagg/bucketed": out["secagg"]["bucketed"]["rr_perm"],
        "telemetry": out["telemetry"]["rr_perm"]}
    out["seconds"] = time.perf_counter() - t0
    return out


# phase (a)'s prefetch depths, run in this order, each held bitwise to the
# earlier prefetch-0 run (whose wall is a third sample of depth 0)
PREFETCH_TURNS = (2, 0)
# CharLM-100M served from the resumed run's params file: batch 4, prompts of
# the training sequence length, 16 greedy tokens
CKPT_SERVE_BATCH, CKPT_SERVE_PROMPT, CKPT_SERVE_STEPS = 4, 128, 16


def host_plan_ms(dev, **kw) -> list[float]:
    """The host plan alone (``CohortEngine.device_plan(r)``: cohort sampling,
    index assembly, the copy to the card), ms for rounds 0 .. ROUNDS-1 of
    the e2e configuration with ``kw``."""
    import torch

    from repro_torch.data.federated import Population
    from repro_torch.data.tasks import CharLMTask
    from repro_torch.fed.cohort.engine import CohortEngine
    from repro_torch.launch.train import charlm_e2e_config

    cfg, fl = charlm_e2e_config(engine="cohort", rr_backend="device", **kw)
    task = CharLMTask(vocab=cfg.vocab, seq_len=128, num_clients=fl.num_clients)
    eng = CohortEngine.build(task, Population.build(fl), fl, device=dev)
    out = []
    for r in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.device_plan(r)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def prefetch_twins(dev, vm_params: dict, vm: dict, bk_params: dict, bk: dict,
                   rows: dict) -> dict:
    """Phase (a): vmapped dense, padded and bucketed (``buckets=4``), run at
    the depths of ``PREFETCH_TURNS`` in turns (at 2 the producer thread
    makes the plans and copies them to the card), each run
    with its launch counts set to 0 just before and read just after
    (``prefetch_launches``: the first run at depth 2) and its parameters
    bitwise equal to the earlier ``prefetch=0`` run of the same path
    (``vm_params`` / ``bk_params``, on the host; its wall in ``vm`` /
    ``bk``).  Prints each run's round wall and the host plan's ms a round.
    -> {layout: {"walls": {depth: [ms]}, "earlier_prefetch0": ms,
    "plan_ms": ms}}."""
    import torch

    from repro_torch.kernels.quantize.kernel import quantize_pack_kernel, unpack_dequantize_kernel
    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel
    from repro_torch.kernels.server_update.kernel import server_update_kernel

    kernels = {"rr_perm": rr_indices_kernel, "quantize_pack": quantize_pack_kernel,
               "unpack_dequantize": unpack_dequantize_kernel,
               "server_update": server_update_kernel}
    layout = bucketed_layout(ROUNDS)
    out = {}
    for label, kw, want, (wall0, *_), rr in (
            ("padded", {}, vm_params["dense"], vm["dense"], ROUNDS),
            ("bucketed", BUCKETED, bk_params, bk["dense_vmapped"], sum(r[0] for r in layout))):
        plan = host_plan_ms(dev, **kw, **VMAPPED)
        walls: dict[int, list] = {d: [] for d in sorted(set(PREFETCH_TURNS))}
        for depth in PREFETCH_TURNS:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(*kernels.values())
            t0 = time.perf_counter()
            res = run_main_path(dev, "device", prefetch=depth, **kw, **VMAPPED)
            torch.cuda.synchronize()
            got = {name: kern.launches for name, kern in kernels.items()}
            tag = f"prefetch {depth}, vmapped dense {label}"
            walls[depth].append(report_rounds(tag, res, time.perf_counter() - t0,
                                              torch.cuda.max_memory_allocated()))
            rows["rr_perm"].setdefault("prefetch_launches", {}).setdefault(label, got["rr_perm"])
            if got != {"rr_perm": rr, "quantize_pack": 0, "unpack_dequantize": 0,
                       "server_update": 0}:
                raise AssertionError(f"{tag} launches: {got} (want rr_perm {rr}, no other)")
            differ = [k for k in want if not torch.equal(res.state.params[k].cpu(), want[k])]
            if differ:
                raise AssertionError(f"{tag} vs the earlier prefetch-0 run: params differ in "
                                     f"{differ}")
            del res
        out[label] = {"walls": walls, "earlier_prefetch0": wall0, "plan_ms": sum(plan) / len(plan)}
        mean = {d: sum(w) / len(w) for d, w in walls.items()}
        print(f"vmapped dense {label}, prefetch in turns {PREFETCH_TURNS}: rr_perm {rr} launches "
              f"a run, parameters bitwise equal to the earlier prefetch-0 run; round wall at "
              f"depth 2 {', '.join(f'{w:.1f}' for w in walls[2])} ms, at depth 0 "
              f"{', '.join(f'{w:.1f}' for w in walls[0])} ms (means {mean[2]:.1f} vs "
              f"{mean[0]:.1f}, {mean[0] / mean[2]:.3f}x; the earlier prefetch-0 run {wall0:.1f}); "
              f"host plan {out[label]['plan_ms']:.3f} ms a round (rounds 0-{ROUNDS - 1}: "
              f"{', '.join(f'{t:.3f}' for t in plan)})", flush=True)
    torch.cuda.empty_cache()
    return out


def e2e_parts(dev, **kw):
    """The pieces ``launch.train.run_charlm_e2e`` trains with ``kw`` (cohort
    engine, device RR): its loss, its params (seed 0, on the card), its
    pipeline, ``FLConfig`` and bound strategy, whose ``init`` is the
    template a server-state checkpoint loads into."""
    from repro_torch.data.federated import FederatedPipeline, Population
    from repro_torch.data.tasks import CharLMTask
    from repro_torch.fed.losses import make_loss
    from repro_torch.fed.strategy import bind_strategy
    from repro_torch.launch.train import charlm_e2e_config
    from repro_torch.models.model import build_model

    cfg, fl = charlm_e2e_config(engine="cohort", rr_backend="device", **kw)
    model = build_model(cfg)
    loss_fn = make_loss(model)
    task = CharLMTask(vocab=cfg.vocab, seq_len=128, num_clients=fl.num_clients)
    return (loss_fn, model.init(0, dev), FederatedPipeline(task, Population.build(fl), fl), fl,
            bind_strategy(None, fl, loss_fn, num_clients=fl.num_clients))


def resume_path(dev, vm_params: dict, rows: dict, tmp: str) -> tuple[dict, dict]:
    """Phase (b): vmapped MVR App. F at ``prefetch=2`` for 2 rounds,
    ``save_server_state`` and ``load_server_state`` through a file in
    ``tmp``, then ``train(state=, start_round=2)`` for 2 more, which also
    writes its params file (``checkpoint_path=``), both halves through
    ``train`` over the pieces of :func:`e2e_parts`; launch counts set to 0 before
    the first half and read after the second (``resume_launches``).  The
    params, ``m`` and ``rnd`` must equal the unbroken 4-round ``prefetch=0``
    run's (``vm_params["mvr"]``, ``["mvr_m"]``) bitwise.  -> the final
    params (on the card) and the file's numbers."""
    import os

    import torch

    from repro_torch.fed.train_loop import SCHEDULES, train
    from repro_torch.kernels.quantize.kernel import quantize_pack_kernel, unpack_dequantize_kernel
    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel
    from repro_torch.kernels.server_update.kernel import server_update_kernel
    from repro_torch.utils.checkpoint import load_server_state, save_server_state

    kernels = {"rr_perm": rr_indices_kernel, "quantize_pack": quantize_pack_kernel,
               "unpack_dequantize": unpack_dequantize_kernel,
               "server_update": server_update_kernel}
    half = ROUNDS // 2
    state_path, params_path = os.path.join(tmp, "mvr_state.npz"), os.path.join(tmp, "params")
    torch.cuda.empty_cache()
    loss_fn, params, pipe, fl, strat = e2e_parts(dev, prefetch=2, **MVR, **VMAPPED)
    run = dict(strategy=strat, log_every=0, device=dev)
    # the first half takes the staircase of the unbroken ROUNDS-round run
    # (train() keys a schedule by its own round count), under a name
    # registered for this one call
    staircase, first_half = SCHEDULES["staircase"], f"staircase_over_{ROUNDS}"
    SCHEDULES[first_half] = lambda r, total: staircase(r, ROUNDS)
    zero_counts(*kernels.values())
    try:
        first = train(loss_fn, params, pipe, fl, half, schedule=first_half, **run).state
    finally:
        del SCHEDULES[first_half]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_server_state(state_path, first, {"round": half - 1})
    save_s = time.perf_counter() - t0
    del first
    torch.cuda.empty_cache()
    template = strat.init(params)
    t0 = time.perf_counter()
    restored = load_server_state(state_path, template)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del template
    res = train(loss_fn, params, pipe, fl, ROUNDS, schedule="staircase", state=restored,
                start_round=half, checkpoint_path=params_path, **run)
    torch.cuda.synchronize()
    got = {name: kern.launches for name, kern in kernels.items()}
    rows["rr_perm"]["resume_launches"] = got["rr_perm"]
    rows["server_update"]["resume_launches"] = got["server_update"]
    if got != {"rr_perm": ROUNDS, "quantize_pack": 0, "unpack_dequantize": 0,
               "server_update": ROUNDS}:
        raise AssertionError(f"resumed mvr path launches: {got} (want rr_perm and "
                             f"server_update {ROUNDS} each)")
    state = res.state
    if state.rnd != ROUNDS or [r["round"] for r in res.metrics.rows] != list(range(half, ROUNDS)):
        raise AssertionError(f"resumed mvr path: rnd {state.rnd}, rounds "
                             f"{[r['round'] for r in res.metrics.rows]}")
    for name, tree, want in (("params", state.params, vm_params["mvr"]),
                             ("m", state.opt["m"], vm_params["mvr_m"])):
        differ = [k for k in want if not torch.equal(tree[k].cpu(), want[k])]
        if differ:
            raise AssertionError(f"resumed mvr path vs the unbroken run: {name} differ in "
                                 f"{differ}")
    info = {"state_bytes": os.path.getsize(state_path), "save_s": save_s, "load_s": load_s,
            "params_path": params_path}
    print(f"resumed mvr path ({half} + {ROUNDS - half} rounds at prefetch 2 through "
          f"save_server_state / load_server_state): params, m and rnd {ROUNDS} bitwise equal to "
          f"the unbroken {ROUNDS}-round prefetch-0 run; launches rr_perm {got['rr_perm']}, "
          f"server_update {got['server_update']}; the state file {info['state_bytes']} bytes, "
          f"saved in {save_s:.3f} s, loaded in {load_s:.3f} s", flush=True)
    params = state.params
    del res, state, restored
    torch.cuda.empty_cache()
    return params, info


def serve_checkpoint(dev, params_path: str, params: dict, flash_row: dict) -> dict:
    """Phase (c): CharLM-100M's params file from the resumed run loaded into
    the model's init params (``load_checkpoint``), then ``generate``
    ``CKPT_SERVE_STEPS`` greedy tokens at batch 4 over 128-token prompts
    (numpy seed 1), the flash launch count set to 0 just before and read
    just after (``charlm_ckpt_launches``), each launch held to the plain
    version at ``FLASH_TOL`` on its own inputs; tokens and every step's
    logits bitwise equal to the same call on the in-memory ``params``."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.launch.serve import generate
    from repro_torch.launch.train import charlm_e2e_config
    from repro_torch.models.model import build_model
    from repro_torch.utils.checkpoint import load_checkpoint

    cfg, _ = charlm_e2e_config()
    model = build_model(cfg)
    t0 = time.perf_counter()
    loaded = load_checkpoint(params_path, model.init(0, dev))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (CKPT_SERVE_BATCH, CKPT_SERVE_PROMPT)), device=dev)
    err = [0.0]
    checked = flash_held(err, FLASH_TOL["float32"], "CharLM-100M prefill flash on the path's "
                         "inputs")

    def serve(p):
        seen = []
        out = generate(model, p, prompts, steps=CKPT_SERVE_STEPS,
                       cache_len=CKPT_SERVE_PROMPT + CKPT_SERVE_STEPS + 1,
                       on_logits=lambda i, lg: seen.append(lg.clone()))
        return out, seen

    want, want_logits = serve(params)
    torch.cuda.synchronize()
    zero_counts(flash_attention_kernel)
    with swapped({(fops, "flash_attention_kernel"): checked}):
        got, got_logits = serve(loaded)
    torch.cuda.synchronize()
    launches, by_route, by_mode = read_counts(flash_attention_kernel)[0]
    flash_row["charlm_ckpt_launches"] = {"launches": launches, "routes": by_route,
                                         "modes": by_mode}
    if launches != cfg.n_layers:
        raise AssertionError(f"served checkpoint: {launches} flash launches (want one a layer, "
                             f"{cfg.n_layers}, all in the prefill)")
    if len(got_logits) != CKPT_SERVE_STEPS or not all(torch.isfinite(x).all()
                                                      for x in got_logits):
        raise AssertionError("served checkpoint: missing or non-finite logits")
    if not torch.equal(got, want) or not all(torch.equal(a, b)
                                             for a, b in zip(got_logits, want_logits)):
        raise AssertionError("served checkpoint: tokens or logits differ from the in-memory "
                             "params' run")
    print(f"CharLM-100M served from the resumed run's params file (loaded in {load_s:.3f} s): "
          f"{CKPT_SERVE_BATCH} x {CKPT_SERVE_STEPS} greedy tokens and every step's logits "
          f"bitwise equal to the in-memory params; flash launches {launches} (routes {by_route}, "
          f"modes {by_mode}), each within {FLASH_TOL['float32']} of the plain version (max abs "
          f"diff {err[0]:.3e})", flush=True)
    return {"load_s": load_s, "flash_launches": launches, "flash_routes": by_route,
            "flash_max_abs_err": err[0]}


def bank_resume(dev, tmp: str) -> dict:
    """Phase (d): CharLM-tiny with both banks on the card (``ef_qsgd`` up,
    ``qsgd`` down, the quantize kernels), 2 rounds at ``prefetch=2``,
    ``save_server_state`` / ``load_server_state``, 2 more, against 4
    unbroken rounds at ``prefetch=0``: params, the EF and downlink banks and
    ``rnd`` bitwise equal, and the quantize launch counts of the two halves
    equal to the unbroken run's."""
    import os

    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.paper_tasks import CHARLM_TINY
    from repro_torch.data.federated import Population
    from repro_torch.data.tasks import CharLMTask
    from repro_torch.fed.cohort.engine import CohortEngine
    from repro_torch.fed.losses import make_loss
    from repro_torch.fed.strategy import bind_strategy
    from repro_torch.fed.train_loop import train
    from repro_torch.kernels.quantize.kernel import quantize_pack_kernel, unpack_dequantize_kernel
    from repro_torch.models.model import build_model
    from repro_torch.utils.checkpoint import load_server_state, save_server_state

    kw = dict(num_clients=4, cohort_size=2, local_batch=2, algorithm="fedshuffle",
              local_lr=0.05, mean_samples=3, seed=1, engine="cohort", rr_backend="device",
              uplink="ef_qsgd", downlink="qsgd")
    model = build_model(CHARLM_TINY)
    loss_fn = make_loss(model)
    params = model.init(0, dev)
    quant = (quantize_pack_kernel, unpack_dequantize_kernel)

    def run(prefetch, rounds, **more):
        fl = FLConfig(**kw, prefetch=prefetch)
        task = CharLMTask(vocab=CHARLM_TINY.vocab, seq_len=16, num_clients=fl.num_clients)
        eng = CohortEngine.build(task, Population.build(fl), fl, device=dev)
        strat = bind_strategy(None, fl, loss_fn, num_clients=fl.num_clients)
        return train(loss_fn, params, eng, fl, rounds, strategy=strat, log_every=0,
                     device=dev, **more).state, strat

    zero_counts(*quant)
    full, _ = run(0, ROUNDS)
    torch.cuda.synchronize()
    want = [k.launches for k in quant]
    zero_counts(*quant)
    half, strat = run(2, ROUNDS // 2)
    path = os.path.join(tmp, "tiny_banks.npz")
    save_server_state(path, half)
    restored = load_server_state(path, strat.init(params))
    resumed, _ = run(2, ROUNDS, state=restored, start_round=ROUNDS // 2)
    torch.cuda.synchronize()
    got = [k.launches for k in quant]
    if got != want or not want[0]:
        raise AssertionError(f"tiny bank resume: quantize launches {got}, unbroken run {want}")
    if resumed.rnd != full.rnd or sorted(resumed.clients) != ["downlink", "uplink"]:
        raise AssertionError(f"tiny bank resume: rnd {resumed.rnd}, bank {sorted(resumed.clients)}")
    differ = [f"params/{k}" for k in full.params if not torch.equal(resumed.params[k],
                                                                    full.params[k])]
    for name, entry in full.clients.items():
        for field, tree in entry.items():
            differ += [f"{name}/{field}/{k}" for k in tree
                       if not torch.equal(resumed.clients[name][field][k], tree[k])]
    if differ:
        raise AssertionError(f"tiny bank resume vs the unbroken run: differ in {differ}")
    print(f"CharLM-tiny with both banks on the card ({ROUNDS // 2} + {ROUNDS - ROUNDS // 2} "
          f"rounds at prefetch 2 vs {ROUNDS} at prefetch 0): params, EF and downlink banks "
          f"bitwise equal; quantize launches {got} in both", flush=True)
    return {"quantize_launches": got}


def train_loop_paths(dev, vm_params: dict, vm: dict, bk_params: dict, bk: dict, rows: dict,
                     flash_row: dict) -> dict:
    """Main path 9: the host side of ``train()``, phases (a) to (d)
    (:func:`prefetch_twins`, :func:`resume_path`, :func:`serve_checkpoint`,
    :func:`bank_resume`), files in a temporary directory."""
    import tempfile

    out = {"prefetch": prefetch_twins(dev, vm_params, vm, bk_params, bk, rows)}
    with tempfile.TemporaryDirectory() as tmp:
        params, out["resume"] = resume_path(dev, vm_params, rows, tmp)
        out["serve_ckpt"] = serve_checkpoint(dev, out["resume"].pop("params_path"), params,
                                             flash_row)
        del params
        out["bank_resume"] = bank_resume(dev, tmp)
    return out


# the paper's vision task as benchmarks/bench_vision.py:44-53 runs it: an
# equal split of 6 samples over 8 clients, 4 a round, E_i ~ U{2..5} (what
# exercises FedShuffleGen), seed 31; five methods, 30 rounds each, eval
# every 5 rounds and at the last
VISION_FL = dict(num_clients=8, cohort_size=4, sampling="uniform", epochs=2, epochs_max=5,
                 local_batch=2, local_lr=0.1, server_opt="sgd", imbalance="equal",
                 mean_samples=6, seed=31)
VISION_METHODS = ("fedavg_min", "fedavg_mean", "fedavg", "fednova", "fedshuffle")
VISION_ROUNDS, VISION_EVAL_EVERY = 30, 5
# FedShuffle on the cohort engine and its device_ref twin (their checks: one
# rr_perm launch a round, the twin bitwise) run 10 rounds, not 30
VISION_ENGINE_ROUNDS = 10
# bench_vision.py's claim (the paper's Table 3): the methods are close on
# the equal split, FedShuffle within this margin of the best final eval
# accuracy, and the best above this floor (training learns)
VISION_MARGIN, VISION_FLOOR = 0.08, 0.2
# serving LLaVA-NeXT-Mistral-7B at full width: batch 4, 256-token prompts
# after its 1,176 patch embeddings (zeros, as generate feeds them), 32
# greedy tokens
LLAVA_PROMPT = 256


def paper_lr_convention(fl, pipe):
    """A copy of ``benchmarks/common.py:paper_lr_convention``: FedShuffle's
    (and FedShuffleGen's) eta_l is quoted for a reference client, so its
    per-step rate matches the grid value; the reference is the
    population-average step count."""
    import dataclasses

    from repro_torch.data.reshuffle import steps_for

    if fl.algorithm in ("fedshuffle", "gen", "fedshuffle_so"):
        ks = [steps_for(int(s), fl.epochs, fl.local_batch) for s in pipe.population.sizes]
        return dataclasses.replace(fl, local_lr=fl.local_lr * float(np.mean(ks)))
    return fl


def vision_eval_fn(model, task, dev):
    """``benchmarks/bench_vision.py:_eval_fn`` on the card: classification
    accuracy on a held-out batch pooled across clients (ids 60,000..60,007
    of each of the 8: B 64), the label predicted at the BOS position after
    the 64 patches by ``Model.prefill`` (T 65: one flash launch a layer)."""
    import torch

    idx = np.arange(8).reshape(1, 8) + 60_000
    batches = [task.batch(c, idx) for c in range(task.num_clients)]
    patches = torch.as_tensor(np.concatenate([b["patches"][0] for b in batches]), device=dev)
    toks = torch.as_tensor(np.concatenate([b["tokens"][0] for b in batches]), device=dev)

    def acc(params):
        with torch.inference_mode():
            logits, _ = model.prefill(params, {"tokens": toks[:, :1], "patches": patches},
                                      cache_len=patches.shape[1] + 2)
            return {"acc": (logits[:, -1].argmax(-1) == toks[:, 1]).float().mean()}

    return acc


def vision_flash_timing(acc_fn, params) -> dict:
    """The vision eval's fp32 ``flash_fwd`` launch (``simt``) at its own
    inputs (the last layer's of one eval): its time, its bound (the larger
    of its products over the fp32 rate and its bytes over HBM's), the plain
    version's time and ``F.scaled_dot_product_attention``'s (causal, the
    backend PyTorch picks for fp32)."""
    import torch
    import torch.nn.functional as F

    import repro_torch.kernels.flash_attention.ops as fops
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch

    seen = []

    def record(q, k, v, *, causal=True, window=0):
        seen.append((q, k, v, causal, window))
        return flash_attention_kernel(q, k, v, causal=causal, window=window)

    with swapped({(fops, "flash_attention_kernel"): record}):
        acc_fn(params)
    q, k, v, causal, window = seen[-1]
    if not causal or window or q.dtype != torch.float32 or k.shape[1] != q.shape[1]:
        raise AssertionError(f"vision eval flash: {q.shape} {q.dtype} causal {causal} "
                             f"window {window}")
    B, H, T, hd = q.shape
    got = flash_attention_kernel(q, k, v, causal=True)
    ms = time_ms(lambda: flash_attention_kernel(q, k, v, causal=True), 20)[0]
    plain_ms = time_ms(lambda: flash_attention_torch(q, k, v, causal=True), 20)[0]
    sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    sdpa_err = float((sdpa - got).abs().max())
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20)[0]
    flops = 4 * B * H * hd * band_pairs(0, T, 0, T)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
    terms = {"operations": flops / FP32_FLOP_PER_S * 1e3, "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    bound, by = max(terms.values()), max(terms, key=terms.get)
    print(f"vision eval flash_fwd (simt, fp32) at [{B}, {T}, {H}/{k.shape[1]}, {hd}], causal: "
          f"{ms:.5f} ms against its {by} bound {bound:.6f} ms ({flops} FLOP at 67 TFLOP/s fp32, "
          f"{nbytes} B); the plain version {plain_ms:.5f} ms; SDPA (causal) {sdpa_ms:.5f} ms, "
          f"max abs diff {sdpa_err:.3e} from the kernel", flush=True)
    return {"shape": [B, T, H, k.shape[1], hd], "ms": ms, "bound_ms": bound, "bound_by": by,
            "plain_ms": plain_ms, "library_ms": sdpa_ms, "library_max_abs_err": sdpa_err}


def vision_path(dev, rr_row: dict, flash_row: dict) -> dict:
    """Main path 10, the paper's vision task (vision-tiny at full width, 2 x
    128, 64 patches; random weights from seed 0) as
    ``benchmarks/bench_vision.py`` runs it, through ``train()`` in the
    vmapped cohort mode (FLConfig's default) with the paper's lr convention:
    the five methods 30 rounds each, the eval accuracy from the vlm prefill
    (2 fp32 flash launches an eval on ``simt``, 7 evals a run), the launch
    counts set to 0 before the five runs and read after; then FedShuffle
    once more through the cohort engine with ``rr_backend="device"``,
    ``VISION_ENGINE_ROUNDS`` rounds (one ``rr_perm`` launch a round), bitwise
    equal to its ``device_ref`` twin.
    Checks: ``bench_vision.py``'s claim, and each method's last eval again
    with every flash launch within ``FLASH_TOL`` of the plain version,
    giving the same accuracy."""
    import torch

    import repro_torch.kernels.flash_attention.ops as fops
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.paper_tasks import VISION_TINY
    from repro_torch.data.federated import FederatedPipeline, Population
    from repro_torch.data.tasks import VisionTask
    from repro_torch.fed.losses import make_loss
    from repro_torch.fed.train_loop import train
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel
    from repro_torch.models.model import build_model

    cfg = VISION_TINY
    task = VisionTask(num_classes=cfg.vocab, num_patches=cfg.num_patches, d_model=cfg.d_model,
                      num_clients=VISION_FL["num_clients"], alpha=0.5)
    model = build_model(cfg)
    loss_fn = make_loss(model)
    acc_fn = vision_eval_fn(model, task, dev)
    params0 = model.init(0, dev)
    evals = sum(r % VISION_EVAL_EVERY == 0 or r == VISION_ROUNDS - 1
                for r in range(VISION_ROUNDS))

    def run(alg, rounds=VISION_ROUNDS, **more):
        fl = FLConfig(**VISION_FL, algorithm=alg, **more)
        fl = paper_lr_convention(fl, FederatedPipeline(task, Population.build(fl), fl))
        pipe = FederatedPipeline(task, Population.build(fl), fl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train(loss_fn, params0, pipe, fl, rounds, eval_fn=acc_fn,
                    eval_every=VISION_EVAL_EVERY, log_every=0, name=f"vision-{alg}", device=dev)
        torch.cuda.synchronize()
        rows = res.metrics.rows
        plain = [rows[r]["elapsed_s"] - rows[r - 1]["elapsed_s"] for r in range(1, len(rows))
                 if "eval_acc" not in rows[r]]
        return res, {"local_lr": fl.local_lr, "wall_s": time.perf_counter() - t0,
                     "round_ms": 1e3 * float(np.mean(plain)),
                     "accs": [r["eval_acc"] for r in rows if "eval_acc" in r],
                     "local_loss": (rows[0]["local_loss"], rows[-1]["local_loss"])}, pipe

    torch.cuda.reset_peak_memory_stats()
    zero_counts(flash_attention_kernel, rr_indices_kernel)
    out, finals = {}, {}
    for alg in VISION_METHODS:
        res, out[alg], pipe = run(alg)
        finals[alg] = res.state.params
    torch.cuda.synchronize()
    ((flash_n, flash_routes, flash_modes),), rr_n = (read_counts(flash_attention_kernel),
                                                     rr_indices_kernel.launches)
    peak = torch.cuda.max_memory_allocated()
    want = len(VISION_METHODS) * evals * cfg.n_layers
    for alg, r in out.items():
        print(f"vision path {alg}: local_lr {r['local_lr']:.4f}, eval accuracy "
              f"{', '.join(f'{a:.4f}' for a in r['accs'])}, local loss {r['local_loss'][0]:.4f} "
              f"-> {r['local_loss'][1]:.4f}; {VISION_ROUNDS} rounds in {r['wall_s']:.2f} s, "
              f"{r['round_ms']:.2f} ms a round without eval", flush=True)
    print(f"vision path launches in the five runs: flash_attention {flash_n} (routes "
          f"{flash_routes}, modes {flash_modes}; want {want}, {evals} evals x {cfg.n_layers} "
          f"layers x {len(VISION_METHODS)} methods, all simt), rr_perm {rr_n} (want 0: host RR); "
          f"peak device memory {peak / 2**30:.3f} GiB", flush=True)
    if (flash_n, flash_routes["simt"], flash_modes["causal"], rr_n) != (want, want, want, 0):
        raise AssertionError(f"vision path launches: flash {flash_n} {flash_routes} "
                             f"{flash_modes}, rr_perm {rr_n}")
    final = {alg: r["accs"][-1] for alg, r in out.items()}
    best = max(final.values())
    if final["fedshuffle"] < best - VISION_MARGIN or best <= VISION_FLOOR:
        raise AssertionError(f"vision path: bench_vision.py's claim fails: {final}")
    print(f"vision path claim (bench_vision.py): fedshuffle {final['fedshuffle']:.4f} >= best "
          f"{best:.4f} - {VISION_MARGIN}, best > {VISION_FLOOR}: held", flush=True)

    # the host's share: VisionTask.batch draws one numpy Generator a sample
    t0 = time.perf_counter()
    for r in range(VISION_ROUNDS):
        pipe.round_batch(r)
    host_ms = (time.perf_counter() - t0) * 1e3 / VISION_ROUNDS

    # each method's last eval again, every flash launch held to the plain
    # version on its inputs, the accuracy equal to the run's
    err = [0.0]
    with swapped({(fops, "flash_attention_kernel"): flash_held(
            err, FLASH_TOL["float32"], "vision eval flash on the path's inputs")}):
        for alg, p in finals.items():
            again = float(acc_fn(p)["acc"])
            if again != final[alg]:
                raise AssertionError(f"vision path {alg}: eval accuracy {again} != {final[alg]}")
    print(f"vision path: the host's round batch (VisionTask.batch, a numpy Generator a sample) "
          f"{host_ms:.2f} ms a round; each method's last eval again: equal accuracy, every flash "
          f"launch within {FLASH_TOL['float32']} of the plain version (max abs diff "
          f"{err[0]:.3e})", flush=True)
    flash_row["vision_eval_fp32"] = vision_flash_timing(acc_fn, finals["fedshuffle"])
    del finals

    # FedShuffle through the cohort engine: the device RR streams, one
    # rr_perm launch a round; its device_ref twin bitwise
    zero_counts(flash_attention_kernel, rr_indices_kernel)
    eng, eng_stats, _ = run("fedshuffle", VISION_ENGINE_ROUNDS, engine="cohort",
                            rr_backend="device")
    torch.cuda.synchronize()
    eng_flash, eng_rr = flash_attention_kernel.launches, rr_indices_kernel.launches
    twin, _, _ = run("fedshuffle", VISION_ENGINE_ROUNDS, engine="cohort", rr_backend="device_ref")
    eng_evals = sum(r % VISION_EVAL_EVERY == 0 or r == VISION_ENGINE_ROUNDS - 1
                    for r in range(VISION_ENGINE_ROUNDS))
    differ = [k for k in twin.state.params
              if not torch.equal(eng.state.params[k], twin.state.params[k])]
    print(f"vision path, fedshuffle on the cohort engine (rr_backend='device'): eval accuracy "
          f"{', '.join(f'{a:.4f}' for a in eng_stats['accs'])}, {eng_stats['round_ms']:.2f} ms "
          f"a round; launches rr_perm {eng_rr} (want {VISION_ENGINE_ROUNDS}), flash_attention "
          f"{eng_flash} (want {eng_evals * cfg.n_layers}); params vs the device_ref twin: "
          f"{'bitwise equal' if not differ else differ}", flush=True)
    if (eng_rr, eng_flash) != (VISION_ENGINE_ROUNDS, eng_evals * cfg.n_layers) or differ:
        raise AssertionError(f"vision path on the cohort engine: rr_perm {eng_rr}, flash "
                             f"{eng_flash}, params differ from the device_ref twin in {differ}")
    rr_row["launches_by_path"] = {"charlm-100m": rr_row["launches"], cfg.name: eng_rr}
    flash_row["launches_by_path"][cfg.name] = flash_n + eng_flash
    flash_row["launches"] += flash_n + eng_flash
    del eng, twin
    torch.cuda.empty_cache()
    return {"methods": out, "final_acc": final, "peak_gib": peak / 2**30,
            "host_batch_ms_per_round": host_ms, "flash_launches": flash_n,
            "flash_max_abs_err": err[0], "engine": eng_stats | {"rr_perm_launches": eng_rr,
                                                                 "flash_launches": eng_flash}}


def serve_llava_path(dev, flash_row: dict) -> dict:
    """Main path 11: full-width LLaVA-NeXT-Mistral-7B (32 x 4096, 32 / 8
    heads of 128, d_ff 14,336, vocab 32,000, bf16, random weights from seed
    0; the vision tower a stub, as in JAX) serves batch 4 x 256-token
    prompts (numpy seed 1) after 1,176 zero patch embeddings for 32 greedy
    tokens through ``generate`` (:func:`timed_generate`; the cache holds
    1,176 + 256 + 32 + 1 positions, the JAX serve CLI's formula): one
    causal flash launch a layer in the prefill on ``mma`` at q [4, 1432,
    32, 128], k/v [4, 1432, 8, 128], none in decode.  One prefill and one
    decode step are traced for their device time and the kernels that take
    the most of it.  Then the checks
    (:func:`check_llava_prefill`), ``flash_fwd_mma`` timed at that shape
    beside SDPA (causal, ``enable_gqa``) and its bound, and LLaVA-tiny
    served on the card against the CPU."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.models.model import build_model

    cfg = get_arch("llava-next-mistral-7b")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, dev)
    n_params = sum(v.numel() for v in params.values())
    weight_bytes = sum(v.numel() * v.element_size() for v in params.values())
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (SERVE_BATCH, LLAVA_PROMPT)), device=dev)
    T = cfg.num_patches + LLAVA_PROMPT
    cache_len = T + SERVE_STEPS + 1
    run = timed_generate(model, params, prompts, cache_len, (flash_attention_kernel,))
    (total,), (prefill,), (decode,) = run["total"], run["prefill"], run["decode"]
    st, L = run["stats"], cfg.n_layers
    res = {"arch": cfg.name, "params": n_params, "weight_bytes": weight_bytes,
           "dtype": cfg.dtype, "batch": SERVE_BATCH, "patches": cfg.num_patches,
           "prompt": LLAVA_PROMPT, "steps": SERVE_STEPS, "cache_len": cache_len, **st,
           "prefill_launches": {"flash_attention": prefill[0], "by_route": prefill[1],
                                "by_mode": prefill[2]},
           "decode_launches": {"flash_attention": decode[0]}}
    print(f"serve llava path: {cfg.name} {n_params} params ({cfg.dtype}, {weight_bytes} bytes), "
          f"batch {SERVE_BATCH} x {LLAVA_PROMPT}-token prompts after {cfg.num_patches} patches, "
          f"{SERVE_STEPS} greedy tokens: prefill {st['prefill_ms']:.2f} ms, decode "
          f"{st['decode_ms_per_step']:.2f} ms a step ({st['decode_tok_per_s']:.1f} tokens/s), "
          f"{st['e2e_tok_per_s']:.1f} tokens/s end to end, peak device memory "
          f"{st['peak_gib']:.3f} GiB; flash_attention launches in the prefill: {prefill[0]} (by "
          f"route {prefill[1]}, by mode {prefill[2]}); in decode: {decode[0]}", flush=True)
    want = (L, {"wgmma": 0, "mma": L, "simt": 0}, {"causal": L, "noncausal": 0})
    if prefill != want or decode[0] != 0:
        raise AssertionError(f"serve llava launches: prefill {prefill}, decode {decode[0]}; "
                             f"want {want} and 0")
    flash_row["launches_by_path"][cfg.name] = total[0]
    flash_row["launches"] += total[0]
    out = run["tokens"]
    del run

    # one prefill and one decode step traced (CUDA activity only)
    batch = {"tokens": prompts, "patches": torch.zeros(
        (SERVE_BATCH, cfg.num_patches, cfg.d_model), dtype=torch.float32, device=dev)}
    cache_bytes = 2 * L * SERVE_BATCH * cache_len * cfg.n_kv_heads * cfg.hd() * 2
    with torch.inference_mode():
        lg, cache = model.prefill(params, batch, cache_len)
        tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
        for label, fn in (("prefill", lambda: model.prefill(params, batch, cache_len)),
                          ("decode", lambda: model.decode_step(params, tok, cache))):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            n, dev_ms = count_device(prof)
            by_name = {}
            for e in prof.profiler.kineto_results.events():
                if e.device_type() != DeviceType.CPU:
                    by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns() / 1e6
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            flash_ms = sum(ms for name, ms in by_name.items() if "flash_fwd" in name)
            res[f"{label}_trace"] = {"kernels": n, "device_ms": dev_ms, "flash_ms": flash_ms,
                                     "top_ms": {name[:80]: ms for name, ms in top}}
            print(f"serve llava {label} traced: {n} device kernels and copies, {dev_ms:.2f} ms "
                  f"of device time, flash_fwd {flash_ms:.2f} ms; the most time: " + "; ".join(
                      f"{name[:80]} {ms:.2f} ms" for name, ms in top), flush=True)
        if cache["pos"] != T + 1:
            raise AssertionError(f"serve llava: cache at {cache['pos']}, want {T + 1}")
    bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    res["decode_bound_ms"] = {"weights": bound, "weights_and_cache": bound + cache_bytes
                              / HBM_BYTES_PER_S * 1e3}
    print(f"serve llava decode step: {res['decode_trace']['device_ms']:.2f} ms of device time in "
          f"{res['decode_trace']['kernels']} kernels, {st['decode_ms_per_step']:.2f} ms of wall, "
          f"against the weight-read bound {bound:.3f} ms ({weight_bytes} B at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s; {res['decode_bound_ms']['weights_and_cache']:.3f} ms "
          f"with the whole {cache_bytes}-byte cache read)", flush=True)
    del cache, lg, tok

    res.update(check_llava_prefill(dev, model, params, prompts, cache_len, out))
    del params
    torch.cuda.empty_cache()

    # flash_fwd_mma at the prefill's shape, beside SDPA and its bound
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, KV, hd = SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    q, k, v = (torch.randn((B, T, n, hd), generator=gen, device=dev).to(torch.bfloat16)
               for n in (H, KV, KV))
    t = time_flash(q, k, v, lambda qt, kt, vt: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True),
        4 * hd * band_pairs(0, T, 0, T) * B * H, "mma")
    flash_row["llava"] = {"shape": [B, T, H, KV, hd], "dtype": "bfloat16",
                          "library": "F.scaled_dot_product_attention(is_causal=True, "
                                     "enable_gqa=True)", **t}
    print(f"flash_attention at bf16 {[B, T, H, KV, hd]}, causal (LLaVA's prefill): "
          f"flash_fwd_mma {t['ms']:.4f} ms, flash_fwd {t['simt_ms']:.4f} ms, SDPA "
          f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}, {t['gflop']:.2f} GFLOP)", flush=True)
    del q, k, v
    res["tiny_card_vs_cpu_err"] = check_serve_tiny(dev, "llava-next-mistral-7b")
    print(f"LLaVA-tiny served on the card vs the port on the CPU: equal tokens, logits max abs "
          f"diff {res['tiny_card_vs_cpu_err']:.3e}", flush=True)
    torch.cuda.empty_cache()
    return res


def check_llava_prefill(dev, model, params: dict, prompts, cache_len: int, out) -> dict:
    """The serving path's checks: (1) ``Model.prefill`` on the path's own
    inputs (the zero patches and the prompts) with each of the 32 flash
    launches held within one bf16 step of the plain version on its inputs;
    the last layer's inputs launched non-causal must leave that bound; (2)
    the prefill over random patch embeddings (numpy seed 2), its logits and
    caches held to :func:`anchor_check` (the plain versions in fp32 on the
    same weights), with the flash launches made non-causal as the planted
    fault that must fail it."""
    import torch

    import repro_torch.kernels.flash_attention.ops as fops
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel

    cfg = model.cfg
    layer_err, last = {}, {}
    checked = flash_checked(layer_err, last, lambda q, k, causal: "flash_attention")
    zeros = torch.zeros((SERVE_BATCH, cfg.num_patches, cfg.d_model), dtype=torch.float32,
                        device=dev)
    with torch.inference_mode(), swapped({(fops, "flash_attention_kernel"): checked}):
        lg, _ = model.prefill(params, {"tokens": prompts, "patches": zeros}, cache_len)
    if not torch.equal(lg[:, -1].argmax(-1), out[:, 0]):
        raise AssertionError("serve llava: the checked prefill picks other first tokens")
    q, k, v, _, want = last.pop("flash_attention")
    with torch.inference_mode():
        d = (flash_attention_kernel(q, k, v, causal=False).float() - want.float()).abs()
    fault_off = int((d > FLASH_MAIN_BF16_ATOL + FLASH_MAIN_BF16_RTOL * want.float().abs()).sum())
    print(f"serve llava prefill's flash inputs, {cfg.n_layers} layers: within "
          f"{FLASH_MAIN_BF16_ATOL} + 2^-7 |ref| of the plain version (max abs diff "
          f"{layer_err['flash_attention']:.3e}); the last layer launched non-causal: {fault_off} "
          f"of {q.numel()} elements off", flush=True)
    if fault_off == 0:
        raise AssertionError("serve llava: the layer check passed a non-causal fault")
    del q, k, v, want, d, lg

    patches = torch.as_tensor(np.random.default_rng(2).normal(
        size=(SERVE_BATCH, cfg.num_patches, cfg.d_model)).astype(np.float32), device=dev)
    batch = {"tokens": prompts, "patches": patches}

    def twin(m, p, decode: bool = True) -> dict:
        lg, c = m.prefill(p, batch, cache_len)
        r = {"logits": lg[:, -1].float()}
        r.update({name: x.float() for name, x in c["layers"].items()})
        return r

    def flash_faulty(q, k, v, *, causal=True, window=0):
        return flash_attention_kernel(q, k, v, causal=False, window=window)

    anchor_err = {}
    layer_check = flash_checked(anchor_err, {}, lambda q, k, causal: "flash_attention")
    errs = anchor_check("serve llava", model, params, twin,
                        {(fops, "flash_attention_kernel"): layer_check}, model,
                        {(fops, "flash_attention_kernel"): flash_faulty}, "a non-causal fault")
    return {"layer_max_abs_err": layer_err["flash_attention"],
            "layer_fault_elements_off": fault_off,
            "random_patches_layer_max_abs_err": anchor_err["flash_attention"],
            "vs_fp32_rel_err": errs}


# ---------------------------------------------------------------------------
# main path 15: the rest of the model zoo
# ---------------------------------------------------------------------------

# the dense archs served at full width, batch 4 x 2,048-token prompts, 32
# greedy tokens: MiniCPM-2B (MHA at hd 64), ChatGLM3-6B (16-way GQA at hd
# 128, the "half" RoPE) and Qwen2-72B (8-way GQA at hd 128, width 8192)
ZOO_DENSE = ("minicpm-2b", "chatglm3-6b", "qwen2-72b")
# Qwen2-72B's depth cut from 80 layers: 20 layers of full width are ~40.1 GB
# of bf16 weights, which leave room on an 80 GB card for the cache, the
# prefill and the per-launch checks' plain attention (~11 GB at its width)
ZOO_DEPTH = {"qwen2-72b": 20}
# the fp32 anchor's depth where a full-depth fp32 copy does not fit beside
# the bf16 weights
ZOO_ANCHOR_DEPTH = {"qwen2-72b": 2}
# the families whose train loss is new, smoke-trained on the card in both
# cohort modes and held to the port on the CPU
ZOO_TRAIN = ("mamba2-1.3b", "hymba-1.5b", "seamless-m4t-medium")
ZOO_TRAIN_ROUNDS = 2
# the card vs the CPU in fp32 with a dense wire: every element within this
# share of its leaf's largest magnitude (check_small_reference's bound)
CARD_CPU_RTOL = 1e-4


def traced_serve(label: str, model, params: dict, batch: dict, cache_len: int,
                 names: tuple, top: int = 0) -> dict:
    """One prefill and one decode step traced (CUDA activity only): device
    kernels and copies, device ms, the ms of the kernels whose names hold
    each of ``names``, and with ``top`` the ms of the ``top`` kernels (by
    name) that take the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    res = {}
    with torch.inference_mode():
        lg, cache = model.prefill(params, batch, cache_len)
        tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
        for phase, fn in (("prefill", lambda: model.prefill(params, batch, cache_len)),
                          ("decode", lambda: model.decode_step(params, tok, cache))):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            n, dev_ms = count_device(prof)
            mine = {f"{nm}_ms": sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                                    if nm in e.name()) / 1e6 for nm in names}
            res[f"{phase}_trace"] = {"kernels": n, "device_ms": dev_ms, **mine}
            most = ""
            if top:
                by_name = {}
                for e in prof.profiler.kineto_results.events():
                    if e.device_type() != DeviceType.CPU:
                        by_name[e.name()[:80]] = by_name.get(e.name()[:80], 0) + e.duration_ns()
                res[f"{phase}_trace"]["top_ms"] = {k: ns / 1e6 for k, ns in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:top]}
                most = "; the most time: " + "; ".join(
                    f"{k} {ms:.2f}" for k, ms in res[f"{phase}_trace"]["top_ms"].items())
            print(f"{label} {phase} traced: {n} device kernels and copies, {dev_ms:.2f} ms of "
                  f"device time, " + ", ".join(f"{k} {v:.2f}" for k, v in mine.items()) + most,
                  flush=True)
    del cache, lg, tok
    return res


def decode_bound(label: str, params: dict, cache_bytes: int, st: dict) -> dict:
    """A decode step's weight-read bound (every weight read once at the
    card's memory rate), and with the whole cache read too, beside the
    step's wall."""
    weight_bytes = sum(v.numel() * v.element_size() for v in params.values())
    bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    print(f"{label} decode step: {st['decode_ms_per_step']:.2f} ms of wall against the "
          f"weight-read bound {bound:.3f} ms ({weight_bytes} B at {HBM_BYTES_PER_S / 1e12} TB/s; "
          f"{bound + cache_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms with the {cache_bytes}-byte "
          f"cache read)", flush=True)
    return {"weight_bytes": weight_bytes, "decode_bound_ms": {
        "weights": bound, "weights_and_cache": bound + cache_bytes / HBM_BYTES_PER_S * 1e3}}


def ssd_step64(xdt, a, bm, cm):
    """The SSD recurrence a step at a time in float64 throughout, the
    witness the whole scan is held to: xdt [B,T,H,P]; a [B,T,H]; B/C
    [B,T,N] -> (y [B,T,H,P], S [B,H,P,N]), float64."""
    import torch

    x, a, b, c = xdt.double(), a.double(), bm.double(), cm.double()
    S = torch.zeros(x.shape[:1] + x.shape[2:] + b.shape[-1:], dtype=torch.float64,
                    device=x.device)
    ys = []
    for t in range(x.shape[1]):
        S = S * torch.exp(a[:, t])[..., None, None] + torch.einsum("bn,bhp->bhpn", b[:, t],
                                                                    x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t], S))
    return torch.stack(ys, dim=1), S


def scan_fp32_cumsum(xdt, a, bm, cm, chunk: int):
    """``ssd_scan`` as it was before the cross-chunk term's ``cum`` was summed
    in fp64: the intra-chunk kernel, then the chunk decays and ``exp(cum)``
    from torch's fp32 cumsum on the card; y in fp32."""
    import torch

    from repro_torch.kernels.ssd.ops import ssd_intra_chunk

    B, T, H, P = xdt.shape
    N = bm.shape[-1]
    nc = T // chunk
    x_c, a_c = xdt.reshape(B, nc, chunk, H, P), a.reshape(B, nc, chunk, H).float()
    b_c, c_c = bm.reshape(B, nc, chunk, N), cm.reshape(B, nc, chunk, N)
    y_intra, s_local = ssd_intra_chunk(x_c, a_c, b_c, c_c)
    cum = torch.cumsum(a_c, dim=2)
    decay = torch.exp(cum[:, :, -1])
    S = torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device)
    prev = []
    for c in range(nc):
        prev.append(S)
        S = S * decay[:, c, :, None, None] + s_local[:, c]
    y = y_intra + torch.einsum("bcqn,bchpn->bcqhp", c_c.float(),
                               torch.stack(prev, dim=1)) * torch.exp(cum)[..., None]
    return y.reshape(B, T, H, P), S


def serve_mamba2_path(dev, ssd_row: dict) -> dict:
    """Main path 15 (a): full-width mamba2-1.3b (48 x 2048, d_inner 4096,
    64 heads of P 64, N 128, vocab 50,280, bf16, random weights from seed 0)
    serves batch 4 x 2,048-token prompts (numpy seed 1; 8 SSD chunks of 256)
    for 32 greedy tokens through ``generate`` (:func:`timed_generate`): one
    ``ssd_intra_chunk_mma`` launch a layer in the prefill, none in decode.
    One prefill and one decode step traced.  Then the checks: (1) each
    launch against its plain version on the path's own inputs (atol 3e-5,
    rtol 3e-4), the last one with its last chunk's decay dropped (a = 0)
    leaving that bound; (2) the whole ``ssd_scan`` of the last layer (y in
    fp32 and the final state) against the step in fp64 (:func:`ssd_step64`),
    before (:func:`scan_fp32_cumsum`) and after the fp64 cum, and the
    kernel timed on those inputs; (3) :func:`anchor_check` of the prefill
    logits, the state and conv caches and the decode logits, the planted
    fault the last chunk's decay dropped in every launch; (4) fp32 at full
    width, a prefill -> decode consistency check (the plain versions: the
    ``simt`` kernel refuses this tile in fp32); (5) mamba2-tiny served on
    the card against the CPU."""
    import dataclasses

    import torch

    import repro_torch.kernels.ssd.ops as sops
    import repro_torch.models.mamba2 as m2
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_kernel
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_torch
    from repro_torch.models.model import build_model

    cfg = get_arch("mamba2-1.3b")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, dev)
    n_params = sum(v.numel() for v in params.values())
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    cache_len = SERVE_PROMPT + SERVE_STEPS + 1
    run = timed_generate(model, params, prompts, cache_len, (ssd_intra_chunk_kernel,))
    (total,), (prefill,), (decode,) = run["total"], run["prefill"], run["decode"]
    st, L = run["stats"], cfg.n_layers
    res = {"arch": cfg.name, "params": n_params, "dtype": cfg.dtype, "batch": SERVE_BATCH,
           "prompt": SERVE_PROMPT, "steps": SERVE_STEPS, **st,
           "prefill_launches": {"ssd_intra_chunk": prefill[0], "by_route": prefill[1]},
           "decode_launches": {"ssd_intra_chunk": decode[0]}}
    print(f"zoo path (a): {cfg.name} {n_params} params ({cfg.dtype}), batch {SERVE_BATCH} x "
          f"{SERVE_PROMPT}-token prompts, {SERVE_STEPS} greedy tokens: prefill "
          f"{st['prefill_ms']:.2f} ms, decode {st['decode_ms_per_step']:.2f} ms a step "
          f"({st['decode_tok_per_s']:.1f} tokens/s), {st['e2e_tok_per_s']:.1f} tokens/s end to "
          f"end, peak device memory {st['peak_gib']:.3f} GiB; ssd_intra_chunk launches in the "
          f"prefill: {prefill[0]} ({prefill[1]}); in decode: {decode[0]}", flush=True)
    if (prefill[0], prefill[1], decode[0]) != (L, {"mma": L, "simt": 0}, 0):
        raise AssertionError(f"zoo {cfg.name} launches: prefill {prefill}, decode {decode}; "
                             f"want {L} on mma and 0")
    ssd_row["launches_by_path"] = {"hymba-1.5b": ssd_row["launches"], cfg.name: total[0]}
    ssd_row["launches"] += total[0]
    ssd_row["route_launches"] = {r: ssd_row["route_launches"][r] + n for r, n in total[1].items()}
    out, seen = run["tokens"], run["logits"]
    del run
    res.update(traced_serve(f"zoo {cfg.name}", model, params, {"tokens": prompts}, cache_len,
                            ("ssd_intra_chunk",)))
    d_inner, H, P, N = m2.dims(cfg)
    state_bytes = L * SERVE_BATCH * (4 * H * P * N + 2 * (cfg.ssm.conv_width - 1)
                                     * (d_inner + 2 * N))
    res.update(decode_bound(f"zoo {cfg.name}", params, state_bytes, st))

    # (1) each launch against its plain version on the path's own inputs;
    # the last layer's whole scan kept for (2)
    layer_err, last = {"ssd_intra_chunk": 0.0}, {}

    def ssd_checked(*args):
        got = ssd_intra_chunk_kernel(*args)
        for g, w in zip(got, ssd_intra_chunk_torch(*args)):
            layer_err["ssd_intra_chunk"] = max(layer_err["ssd_intra_chunk"], _allclose(
                g, w, SSD_ATOL, SSD_RTOL, f"{cfg.name} ssd on the path's inputs"))
        last["intra"] = args
        return got

    def decay_dropped(xdt, a, bm, cm):
        a = a.clone()
        a[:, -1] = 0.0
        return ssd_intra_chunk_kernel(xdt, a, bm, cm)

    scan = m2.ssd_scan

    def scan_kept(*args, **kw):
        last["scan"] = args[:5]
        return scan(*args, **kw)

    with torch.inference_mode(), swapped({(sops, "ssd_intra_chunk_kernel"): ssd_checked,
                                          (m2, "ssd_scan"): scan_kept}):
        lg, _ = model.prefill(params, {"tokens": prompts}, cache_len)
    if not torch.equal(lg[:, -1].argmax(-1), out[:, 0]):
        raise AssertionError(f"zoo {cfg.name}: the checked prefill picks other first tokens")
    with torch.inference_mode():
        xdt, a, bm, cm = last.pop("intra")
        want = ssd_intra_chunk_torch(xdt, a, bm, cm)
        fault_off = [_off(g, w, SSD_ATOL, SSD_RTOL)[0]
                     for g, w in zip(decay_dropped(xdt, a, bm, cm), want)]
        t_ms, _ = time_ms(lambda: ssd_intra_chunk_kernel(xdt, a, bm, cm), 20)
        t_plain, _ = time_ms(lambda: ssd_intra_chunk_torch(xdt, a, bm, cm), 3, behind_sleep=False)
        Bz, nc, Q = xdt.shape[:3]
        tri = Q * (Q + 1) // 2
        flops = 2 * (Bz * nc * tri * N + Bz * nc * H * (tri * P + Q * P * N))
        nbytes = ((2 + 4) * xdt.numel() + 4 * a.numel() + 2 * (bm.numel() + cm.numel())
                  + 4 * Bz * nc * H * P * N)
        t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        ssd_row["mamba2_in_path"] = {
            "shape": list(xdt.shape[:4]) + [P, N], "ms": t_ms, "plain_ms": t_plain,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops > t_bytes
            else "bytes", "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
        del want
    print(f"zoo {cfg.name} prefill's ssd inputs, {L} layers: within atol {SSD_ATOL} / rtol "
          f"{SSD_RTOL} of the plain version (max abs diff {layer_err['ssd_intra_chunk']:.3e}); "
          f"the last layer with its last chunk's decay dropped: (y, S) elements off "
          f"{fault_off}; on those inputs {list(xdt.shape)}: ssd_intra_chunk_mma {t_ms:.4f} ms, "
          f"plain {t_plain:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms", flush=True)
    if fault_off[0] == 0:
        raise AssertionError(f"zoo {cfg.name}: the layer check passed a dropped chunk decay")
    res["layer_max_abs_err"] = layer_err["ssd_intra_chunk"]
    res["layer_fault_elements_off"] = fault_off

    # (2) the whole scan of the last layer against the step in fp64
    xdt, a, bm, cm, chunk = last.pop("scan")
    with torch.inference_mode():
        exact = ssd_step64(xdt, a, bm, cm)
        scans = {"before (fp32 cumsum)": scan_fp32_cumsum(xdt, a, bm, cm, chunk),
                 "after (fp64 cum)": scan(xdt, a, bm, cm, chunk, out_dtype=torch.float32)}
        witness = {name: [_off(g, w, SSD_ATOL, SSD_RTOL) for g, w in zip(got, exact)]
                   for name, got in scans.items()}
    del exact, scans
    res["scan_fp64_witness"] = witness
    print(f"zoo {cfg.name} whole ssd_scan of the last layer ({list(xdt.shape)}, chunk {chunk}, "
          f"N {N}) against the step in fp64, (elements off atol {SSD_ATOL} / rtol {SSD_RTOL}, "
          f"worst share of the bound) of y, S: " + "; ".join(
              f"{k} {v}" for k, v in witness.items()), flush=True)
    if any(n for n, _ in witness["after (fp64 cum)"]):
        raise AssertionError(f"zoo {cfg.name}: the whole scan is off the fp64 step: "
                             f"{witness['after (fp64 cum)']}")
    del xdt, a, bm, cm

    # (3) the bf16 run held to the plain versions in fp32
    def twin(m, p, decode: bool = True) -> dict:
        lg, c = m.prefill(p, {"tokens": prompts}, cache_len)
        r = {"logits": lg[:, -1].float()}
        r.update({k: v.to(torch.float32, copy=True) for k, v in c["layers"].items()})
        if decode:
            r["decode_logits"] = torch.stack([
                m.decode_step(p, out[:, i - 1:i], c)[0][:, -1].float()
                for i in range(1, SERVE_STEPS)])
        return r

    anchor_err = {"ssd_intra_chunk": 0.0}

    def anchor_checked(*args):
        got = ssd_intra_chunk_kernel(*args)
        for g, w in zip(got, ssd_intra_chunk_torch(*args)):
            anchor_err["ssd_intra_chunk"] = max(anchor_err["ssd_intra_chunk"], _allclose(
                g, w, SSD_ATOL, SSD_RTOL, f"{cfg.name} ssd in the anchor's kernel run"))
        return got

    res["vs_fp32_rel_err"] = anchor_check(
        f"zoo {cfg.name}", model, params, twin, {(sops, "ssd_intra_chunk_kernel"): anchor_checked},
        model, {(sops, "ssd_intra_chunk_kernel"): decay_dropped}, "the last chunk's decay dropped",
        {"logits": seen[0], "decode_logits": torch.stack(seen[1:])})
    del params, seen
    torch.cuda.empty_cache()

    # (4) fp32 at full width: 3 decoded tokens against the prefill of all
    # 2,051 (a ragged last chunk)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ref32 = build_model(cfg32, backend="ref")
    params = ref32.init(0, dev)
    T = SERVE_PROMPT
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, T + 3)), device=dev)
    with torch.inference_mode():
        lg, cache = ref32.prefill(params, {"tokens": toks[:, :T]}, T + 5)
        for i in range(3):
            lg, cache = ref32.decode_step(params, toks[:, T + i:T + i + 1], cache)
        full, _ = ref32.prefill(params, {"tokens": toks}, T + 5)
    res["fp32_decode_vs_prefill"] = _allclose(lg, full, FP32_ATOL, FP32_RTOL,
                                              f"{cfg.name} fp32 prefill -> decode consistency")
    del params, cache, lg, full
    torch.cuda.empty_cache()
    res["tiny_card_vs_cpu_err"] = check_serve_tiny(dev, cfg.name)
    print(f"zoo {cfg.name} fp32 at full width (2 x {T} prompts, plain versions): 3 decoded "
          f"tokens vs the prefill of {T + 3}, max abs diff {res['fp32_decode_vs_prefill']:.3e} "
          f"(within {FP32_ATOL} + {FP32_RTOL}|ref|); mamba2-tiny served on the card vs the port "
          f"on the CPU: equal tokens, logits max abs diff {res['tiny_card_vs_cpu_err']:.3e}",
          flush=True)
    return res


def serve_zoo_dense_path(dev, arch: str, flash_row: dict) -> dict:
    """Main path 15 (b)-(d): a dense arch at full width (depth cut by
    ``ZOO_DEPTH``; bf16, random weights from seed 0) serves batch 4 x
    2,048-token prompts (numpy seed 1) for 32 greedy tokens through
    ``generate`` (:func:`timed_generate`): one causal flash launch a layer
    in the prefill on ``mma``, none in decode.  One prefill and one decode
    step traced.  Then the checks of :func:`check_llava_prefill`: each launch
    within one bf16 step of the plain version on the path's inputs (the
    last one launched non-causal leaving that bound); the prefill's logits
    and caches held to :func:`anchor_check` (at ``ZOO_ANCHOR_DEPTH``'s depth
    where it is set, on the first layers' weights), the flash launches made
    non-causal the planted fault; ``flash_fwd_mma`` timed at the path's
    shape beside SDPA (causal, ``enable_gqa``) and its bound; the tiny
    config served on the card against the CPU."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    import repro_torch.kernels.flash_attention.ops as fops
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.models.model import build_model

    full = get_arch(arch)
    L = ZOO_DEPTH.get(arch, full.n_layers)
    cfg = dataclasses.replace(full, n_layers=L)
    cut = f", depth cut from {full.n_layers} to {L} layers" if L != full.n_layers else ""
    model = build_model(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, dev)
    n_params = sum(v.numel() for v in params.values())
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    cache_len = SERVE_PROMPT + SERVE_STEPS + 1
    run = timed_generate(model, params, prompts, cache_len, (flash_attention_kernel,))
    (total,), (prefill,), (decode,) = run["total"], run["prefill"], run["decode"]
    st = run["stats"]
    B, H, KV, hd, T = SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd(), SERVE_PROMPT
    res = {"arch": arch, "layers": L, "full_layers": full.n_layers, "params": n_params,
           "dtype": cfg.dtype, "batch": B, "prompt": T, "steps": SERVE_STEPS, **st,
           "prefill_launches": {"flash_attention": prefill[0], "by_route": prefill[1],
                                "by_mode": prefill[2]},
           "decode_launches": {"flash_attention": decode[0]}}
    print(f"zoo path: {arch} at full width ({cfg.d_model}, {H} / {KV} heads of {hd}){cut}: "
          f"{n_params} params ({cfg.dtype}), batch {B} x {T}-token prompts, {SERVE_STEPS} greedy "
          f"tokens: prefill {st['prefill_ms']:.2f} ms, decode {st['decode_ms_per_step']:.2f} ms "
          f"a step ({st['decode_tok_per_s']:.1f} tokens/s), {st['e2e_tok_per_s']:.1f} tokens/s "
          f"end to end, peak device memory {st['peak_gib']:.3f} GiB; flash_attention launches in "
          f"the prefill: {prefill[0]} (by route {prefill[1]}, by mode {prefill[2]}); in decode: "
          f"{decode[0]}", flush=True)
    want = (L, {"wgmma": 0, "mma": L, "simt": 0}, {"causal": L, "noncausal": 0})
    if prefill != want or decode[0] != 0:
        raise AssertionError(f"zoo {arch} launches: prefill {prefill}, decode {decode[0]}; "
                             f"want {want} and 0")
    flash_row["launches_by_path"][arch] = total[0]
    flash_row["launches"] += total[0]
    out = run["tokens"]
    del run
    res.update(traced_serve(f"zoo {arch}", model, params, {"tokens": prompts}, cache_len,
                            ("flash_fwd",)))
    res.update(decode_bound(f"zoo {arch}", params, 2 * L * B * cache_len * KV * hd * 2, st))

    # each launch within one bf16 step of the plain version on its inputs;
    # the last layer's launched non-causal must leave that bound
    layer_err, last = {}, {}
    checked = flash_checked(layer_err, last, lambda q, k, causal: "flash_attention")
    with torch.inference_mode(), swapped({(fops, "flash_attention_kernel"): checked}):
        lg, _ = model.prefill(params, {"tokens": prompts}, cache_len)
    if not torch.equal(lg[:, -1].argmax(-1), out[:, 0]):
        raise AssertionError(f"zoo {arch}: the checked prefill picks other first tokens")
    q, k, v, _, want = last.pop("flash_attention")
    with torch.inference_mode():
        d = (flash_attention_kernel(q, k, v, causal=False).float() - want.float()).abs()
    fault_off = int((d > FLASH_MAIN_BF16_ATOL + FLASH_MAIN_BF16_RTOL * want.float().abs()).sum())
    print(f"zoo {arch} prefill's flash inputs, {L} layers: within {FLASH_MAIN_BF16_ATOL} + 2^-7 "
          f"|ref| of the plain version (max abs diff {layer_err['flash_attention']:.3e}); the "
          f"last layer launched non-causal: {fault_off} of {q.numel()} elements off", flush=True)
    if fault_off == 0:
        raise AssertionError(f"zoo {arch}: the layer check passed a non-causal fault")
    res["layer_max_abs_err"] = layer_err["flash_attention"]
    res["layer_fault_elements_off"] = fault_off
    del q, k, v, want, d, lg

    # the bf16 run held to the plain versions in fp32, at a cut depth on the
    # first layers' weights where a full-depth fp32 copy does not fit
    depth = ZOO_ANCHOR_DEPTH.get(arch, L)
    if depth != L:
        params = {n: t for n, t in params.items()
                  if not n.startswith("blocks/") or int(n.split("/")[1]) < depth}
        model = build_model(dataclasses.replace(cfg, n_layers=depth))
        torch.cuda.empty_cache()

    def twin(m, p, decode: bool = True) -> dict:
        lg, c = m.prefill(p, {"tokens": prompts}, cache_len)
        r = {"logits": lg[:, -1].float()}
        r.update({name: x.float() for name, x in c["layers"].items()})
        return r

    def flash_faulty(q, k, v, *, causal=True, window=0):
        return flash_attention_kernel(q, k, v, causal=False, window=window)

    anchor_err = {}
    errs = anchor_check(f"zoo {arch} ({depth} layers)", model, params, twin,
                        {(fops, "flash_attention_kernel"): flash_checked(
                            anchor_err, {}, lambda q, k, causal: "flash_attention")}, model,
                        {(fops, "flash_attention_kernel"): flash_faulty}, "a non-causal fault")
    res["anchor_layers"] = depth
    res["vs_fp32_rel_err"] = errs
    del params
    torch.cuda.empty_cache()

    # flash_fwd_mma at the prefill's shape, beside SDPA and its bound
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, T, n, hd), generator=gen, device=dev).to(torch.bfloat16)
               for n in (H, KV, KV))
    t = time_flash(q, k, v, lambda qt, kt, vt: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True),
        4 * hd * band_pairs(0, T, 0, T) * B * H, "mma")
    flash_row[arch] = {"shape": [B, T, H, KV, hd], "dtype": "bfloat16",
                       "library": "F.scaled_dot_product_attention(is_causal=True, "
                                  "enable_gqa=True)", **t}
    print(f"flash_attention at bf16 {[B, T, H, KV, hd]}, causal ({arch}'s prefill): "
          f"flash_fwd_mma {t['ms']:.4f} ms, flash_fwd {t['simt_ms']:.4f} ms, SDPA "
          f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}, {t['gflop']:.2f} GFLOP)", flush=True)
    del q, k, v
    res["tiny_card_vs_cpu_err"] = check_serve_tiny(dev, arch)
    print(f"zoo {arch}-tiny served on the card vs the port on the CPU: equal tokens, logits max "
          f"abs diff {res['tiny_card_vs_cpu_err']:.3e}", flush=True)
    torch.cuda.empty_cache()
    return res


def card_vs_cpu(label: str, got: dict, want: dict) -> float:
    """A run on the card against the same run of the port on the CPU (fp32,
    TF32 off, a dense wire): every element finite and within
    ``CARD_CPU_RTOL`` of its leaf's largest magnitude.  -> the largest
    share."""
    import torch

    worst = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label} on the card: non-finite {k}")
        rel = float((g - w).abs().max() / w.abs().max().clamp_min(1e-12))
        if rel > CARD_CPU_RTOL:
            raise AssertionError(f"{label}: {k} differs from the CPU by {rel:.3e} of its largest "
                                 f"magnitude (bound {CARD_CPU_RTOL})")
        worst = max(worst, rel)
    return worst


def zoo_train_paths(dev) -> dict:
    """Main path 15 (e): the smoke run (``launch/train.py:run_smoke``: the
    reduced config, 6 clients, 3 a round, 32-token samples) of the three
    families whose train loss is new, mamba2-1.3b (ssm), hymba-1.5b (hybrid)
    and seamless-m4t-medium (audio, 32 frames a sample), ``ZOO_TRAIN_ROUNDS``
    rounds in each cohort mode on the card, each held to the same run of
    the port on the CPU (:func:`card_vs_cpu`), both from the weights seed 0
    draws on the CPU (a CUDA generator draws others); Hymba's bucketed run
    (``exec_mode="bucketed"``) bitwise equal to its padded twin in each
    mode."""
    import torch

    from repro_torch.launch.train import run_smoke
    from repro_torch.models.model import Model

    init = Model.init

    def cpu_drawn(self, seed, device):
        return {k: v.to(device) for k, v in init(self, seed, "cpu").items()}

    res = {}
    for arch in ZOO_TRAIN:
        for mode in ("vmapped", "sequential"):
            with swapped({(Model, "init"): cpu_drawn}):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                card = run_smoke(arch, ZOO_TRAIN_ROUNDS, device=dev, cohort_mode=mode)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                cpu = run_smoke(arch, ZOO_TRAIN_ROUNDS, device="cpu", cohort_mode=mode)
                bucketed = (run_smoke(arch, ZOO_TRAIN_ROUNDS, device=dev, cohort_mode=mode,
                                      exec_mode="bucketed") if arch == "hymba-1.5b" else None)
            row = {"wall_s": wall, "local_loss": [r["local_loss"] for r in card.metrics.rows],
                   "card_vs_cpu": card_vs_cpu(f"{arch} {mode} smoke", card.state.params,
                                              cpu.state.params)}
            if bucketed is not None:
                row["bucketed"] = held_bitwise(f"{arch} {mode} bucketed smoke",
                                               bucketed.state.params, card.state.params)
            res[f"{arch} {mode}"] = row
            print(f"zoo train {arch} {mode}: {ZOO_TRAIN_ROUNDS} rounds on the card in "
                  f"{wall:.2f} s, local_loss {row['local_loss']}, max share of a leaf's largest "
                  f"magnitude off the CPU {row['card_vs_cpu']:.3e} (bound {CARD_CPU_RTOL})"
                  + (f", bucketed {row['bucketed']}" if bucketed is not None else ""), flush=True)
    return res


def zoo_paths(dev, flash_row: dict, ssd_row: dict) -> dict:
    """Main path 15, the rest of the model zoo: (a) mamba2-1.3b served
    (:func:`serve_mamba2_path`), (b)-(d) MiniCPM-2B, ChatGLM3-6B and
    Qwen2-72B (depth cut) served (:func:`serve_zoo_dense_path`), each model
    freed before the next, and (e) the smoke runs of the ssm, hybrid and
    audio families' train losses (:func:`zoo_train_paths`)."""
    t0 = time.perf_counter()
    res = {"mamba2-1.3b": serve_mamba2_path(dev, ssd_row)}
    for arch in ZOO_DENSE:
        res[arch] = serve_zoo_dense_path(dev, arch, flash_row)
    res["train"] = zoo_train_paths(dev)
    res["seconds"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# main path 16: MLA and the moe family (DeepSeek-V2-Lite-16B, DeepSeek-V3)
# ---------------------------------------------------------------------------

MOE_SERVE = ("deepseek-v2-lite-16b", "deepseek-v3-671b")
# DeepSeek-V3's depth cut from 61 layers to 2: ~49.7 GB of bf16 weights
# (an MoE layer is 11.5 B params), which leave room on an 80 GB card for the
# prefill's plain MLA attention (fp32 scores [4, 128, 2048, 2048], ~16 GiB
# at their peak).  Its MTP block enters the train loss only, so the served
# model is built with mtp=False; the train smoke holds the MTP block.
MOE_DEPTH = {"deepseek-v3-671b": 2}
# the depth of V2-Lite's bf16-vs-fp32 prefill comparison (reported, not a
# limit: in bf16 a token near a routing tie may take another expert)
MOE_ANCHOR_DEPTH = 2
# the card-vs-CPU checks' prompt: 4 x 300 = 1,200 tokens, two dispatch
# groups of 1,024, the second holding 848 pad rows
MOE_CHECK_PROMPT = 300
# the card's and the CPU's fp32 router probabilities of the same input
MOE_PROB_ATOL = 1e-5


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the port, each with its launch count."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.quantize.kernel import quantize_pack_kernel, unpack_dequantize_kernel
    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel
    from repro_torch.kernels.server_update.kernel import server_update_kernel
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_kernel

    return (rr_indices_kernel, quantize_pack_kernel, unpack_dequantize_kernel,
            server_update_kernel, flash_attention_kernel, ssd_intra_chunk_kernel)


def top_k_high(probs, k: int):
    """The planted fault of the dispatch's tie order: the k largest with
    ties broken toward the higher index."""
    import torch

    vals, idx = torch.sort(probs.flip(-1), dim=-1, descending=True, stable=True)
    return vals[..., :k], probs.shape[-1] - 1 - idx[..., :k]


@contextlib.contextmanager
def dispatch_seen(route_by: list | None = None):
    """Swap ``moe._dispatch_group`` for one that records each group's
    {probs, disp, k, cap} in the list it yields.  With ``route_by`` (a list
    of probability tensors, one a group in call order) each group is routed
    by those (moved to its device) in place of its own probabilities, which
    are recorded."""
    from repro_torch.models import moe

    orig, seen = moe._dispatch_group, []

    def recording(probs, k, cap):
        used = probs if route_by is None else route_by[len(seen)].to(probs.device)
        out = orig(used, k, cap)
        seen.append({"probs": probs, "disp": out[0], "k": k, "cap": cap})
        return out

    with swapped({(moe, "_dispatch_group"): recording}):
        yield seen


def drops_of(seen: list) -> dict:
    """Token choices (assignments) the capacity dropped, and tokens that
    lost at least one of their k choices, over the recorded groups."""
    out = {"assignments": 0, "assignments_dropped": 0, "tokens": 0, "tokens_losing_a_choice": 0}
    for s in seen:
        kept = s["disp"].sum(dim=(1, 2))                       # [g]
        out["assignments"] += kept.numel() * s["k"]
        out["assignments_dropped"] += int(kept.numel() * s["k"] - kept.sum())
        out["tokens"] += kept.numel()
        out["tokens_losing_a_choice"] += int((kept < s["k"]).sum())
    return out


def routing_flips(card: list, cpu: list, k: int) -> dict:
    """The card's and the CPU's own fp32 router probabilities of the same
    groups: within ``MOE_PROB_ATOL`` of each other, and every token whose
    ordered top-k differs between them sits at a near tie (two adjacent
    probabilities of the card's top k+1 no further apart than twice that
    token's largest card-vs-CPU difference, the most a difference can
    reorder).  -> the largest difference and the tokens that differ."""
    import torch

    from repro_torch.models import moe

    diff, flips = 0.0, 0
    for pc, pg in zip(card, cpu):
        pc, pg = pc.float().cpu(), pg.float().cpu()
        d = (pc - pg).abs().amax(dim=-1)                        # [g]
        diff = max(diff, float(d.max()))
        bad = (moe.top_k(pc, k)[1] != moe.top_k(pg, k)[1]).any(dim=-1)
        if bad.any():
            vals = moe.top_k(pc, min(k + 1, pc.shape[-1]))[0]
            gap = (vals[:, :-1] - vals[:, 1:]).amin(dim=-1)
            if (bad & (gap > 2 * d)).any():
                raise AssertionError("moe routing: a token's top-k differs card vs CPU away "
                                     "from any near tie")
        flips += int(bad.sum())
    if diff > MOE_PROB_ATOL:
        raise AssertionError(f"moe routing: router probabilities differ card vs CPU by {diff:.3e} "
                             f"(bound {MOE_PROB_ATOL})")
    return {"max_prob_diff": diff, "tokens_differing": flips}


def dispatch_fault(card_seen: list, want: list) -> list[int]:
    """The planted fault: each recorded group dispatched again from the
    card's probabilities with ties broken toward the higher index; -> the
    elements of each group's mask off ``want``'s."""
    import torch

    from repro_torch.models import moe

    with torch.inference_mode(), swapped({(moe, "top_k"): top_k_high}):
        return [int((moe._dispatch_group(s["probs"], s["k"], s["cap"])[0].cpu() != w.cpu()).sum())
                for s, w in zip(card_seen, want)]


def check_moe_block(dev, cfg, params: dict, prompts) -> dict:
    """DeepSeek-V2-Lite's first MoE block at full width in fp32 (TF32 off),
    from the served model's layer-0 weights, on the card and on the CPU,
    over the prompts' embeddings (4 x 300 tokens: two dispatch groups, the
    second padded with 848 rows), then one decode step of the block at
    batch 4 (capacity 1) over each device's own prefill cache.  The CPU is
    routed by the card's router probabilities (:func:`routing_flips` holds
    its own): every group's dispatch mask bitwise equal, the block's output,
    caches and aux within ``CARD_CPU_RTOL`` of a tensor's largest magnitude.
    The planted fault, ties broken toward the higher index, must change the
    padded group's mask."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.models import blocks as MB

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p = {k: v.float() for k, v in params.items() if k.startswith("blocks/0/")}
    B, T = prompts.shape
    with torch.inference_mode():
        emb = F.embedding(prompts, params["embed"]).float()
        emb_next = F.embedding(prompts[:, -1:], params["embed"]).float()
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        pd = {k: v.to(d) for k, v in p.items()}
        card = runs.get("card")
        with torch.inference_mode():
            with dispatch_seen(card and [s["probs"] for s in card["seen"]]) as seen:
                h, aux, entry = MB.moe_block_prefill(pd, cfg32, emb.to(d),
                                                     torch.arange(T, device=d), "blocks/0/")
            cache = {k: torch.zeros((B, T + 1, v.shape[-1]), device=d) for k, v in entry.items()}
            for k, v in entry.items():
                cache[k][:, :T] = v
            with dispatch_seen(card and [s["probs"] for s in card["dseen"]]) as dseen:
                hd, cache = MB.moe_block_decode(pd, cfg32, emb_next.to(d), T, cache, "blocks/0/")
        runs[name] = {"seen": seen, "dseen": dseen, "out": {
            "h": h, "aux": aux[None], "decode_h": hd,
            **{f"prefill_{k}": v for k, v in entry.items()},
            **{f"decoded_{k}": v for k, v in cache.items()}}}
        del pd
    card, cpu = runs["card"], runs["cpu"]
    res = {}
    for phase in ("seen", "dseen"):
        same = [torch.equal(a["disp"].cpu(), b["disp"]) for a, b in zip(card[phase], cpu[phase])]
        if len(card[phase]) != len(cpu[phase]) or not all(same):
            raise AssertionError(f"moe block: the {phase} dispatch masks differ card vs CPU "
                                 f"({same})")
        res[phase] = {"groups": len(same), **routing_flips(
            [s["probs"] for s in card[phase]], [s["probs"] for s in cpu[phase]], cfg.moe.top_k),
            **drops_of(card[phase])}
    res["card_vs_cpu"] = card_vs_cpu("moe block (V2-Lite layer 0, fp32)", card["out"], cpu["out"])
    res["fault_elements_off"] = dispatch_fault(card["seen"], [s["disp"] for s in cpu["seen"]])
    if res["fault_elements_off"][-1] == 0:
        raise AssertionError("moe block: ties broken toward the higher index leave the padded "
                             "group's dispatch mask as it was")
    print(f"moe block check (deepseek-v2-lite-16b layer 0 at full width, fp32, {B} x {T} tokens, "
          f"{res['seen']['groups']} groups, the last padded): dispatch masks bitwise equal card "
          f"vs CPU in the prefill and in one decode step at batch {B} (capacity 1); router "
          f"probabilities within {res['seen']['max_prob_diff']:.3e} / "
          f"{res['dseen']['max_prob_diff']:.3e} (bound {MOE_PROB_ATOL}), tokens whose own top-k "
          f"differs card vs CPU {res['seen']['tokens_differing']} / "
          f"{res['dseen']['tokens_differing']} (each at a near tie); output, caches and aux within"
          f" {res['card_vs_cpu']:.3e} of a tensor's largest magnitude (bound {CARD_CPU_RTOL}); "
          f"choices dropped {res['seen']['assignments_dropped']} of "
          f"{res['seen']['assignments']} (pads included) / {res['dseen']['assignments_dropped']} "
          f"of {res['dseen']['assignments']}; ties toward the higher index: elements off by group "
          f"{res['fault_elements_off']}", flush=True)
    return res


def check_moe_router(dev, cfg, params: dict, prompts) -> dict:
    """DeepSeek-V3's first layer on the same kind of prompt: the MoE's input
    on the card (bf16: the embeddings, ln1, MLA, the residual, ln2), in its
    groups; the fp32 router's probabilities on the card and on the CPU from
    that input (:func:`routing_flips`), each group's dispatch bitwise equal
    card vs CPU from the card's probabilities, and the tie-order fault
    changing the padded group's mask.  V3's experts are not run on the
    host: in fp32 they would take 46 GB of its memory."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import blocks as MB
    from repro_torch.models import moe
    from repro_torch.models.attention import MLA_KEYS, mla_forward
    from repro_torch.models.layers import rmsnorm

    T = prompts.shape[1]
    with torch.inference_mode():
        h = F.embedding(prompts, params["embed"])
        a, _ = mla_forward(MB._sub(params, "blocks/0/attn/", MLA_KEYS), cfg,
                           rmsnorm(params["blocks/0/ln1/scale"], h, cfg.norm_eps),
                           torch.arange(T, device=dev))
        x = rmsnorm(params["blocks/0/ln2/scale"], h + a, cfg.norm_eps)
        xg, cap = moe.token_groups(cfg, x)
        router = params["blocks/0/moe/router"]
        pc = moe.router_probs(router, xg)
        pg = moe.router_probs(router.cpu(), xg.cpu())
        k = cfg.moe.top_k
        card = [{"probs": pc[i], "disp": moe._dispatch_group(pc[i], k, cap)[0], "k": k,
                 "cap": cap} for i in range(xg.shape[0])]
        host = [moe._dispatch_group(pc[i].cpu(), k, cap)[0] for i in range(xg.shape[0])]
    same = [torch.equal(c["disp"].cpu(), hd) for c, hd in zip(card, host)]
    if not all(same):
        raise AssertionError(f"moe router (V3 layer 0): dispatch masks differ card vs CPU ({same})")
    res = {"groups": len(card), "router_dtype": str(router.dtype), **routing_flips(
        [c["probs"] for c in card], list(pg), k), **drops_of(card),
           "fault_elements_off": dispatch_fault(card, host)}
    if router.dtype != torch.float32 or res["fault_elements_off"][-1] == 0:
        raise AssertionError(f"moe router (V3 layer 0): router {router.dtype}, the tie-order "
                             f"fault {res['fault_elements_off']}")
    print(f"moe router check (deepseek-v3-671b layer 0, bf16 model, fp32 router, "
          f"{prompts.shape[0]} x {T} tokens, {len(card)} groups, capacity {cap}): dispatch masks "
          f"bitwise equal card vs CPU; router probabilities within {res['max_prob_diff']:.3e} "
          f"(bound {MOE_PROB_ATOL}); tokens whose own top-k differs {res['tokens_differing']} "
          f"(each at a near tie); choices dropped {res['assignments_dropped']} of "
          f"{res['assignments']} (pads included); ties toward the higher index: elements off by "
          f"group {res['fault_elements_off']}", flush=True)
    return res


def moe_anchor(model, params: dict, prompts) -> dict:
    """V2-Lite's bf16 prefill logits at ``MOE_ANCHOR_DEPTH`` layers (the
    first layers' weights) against the same prefill in fp32 on the
    bf16-valued weights: the relative error of the norm and the share of
    equal argmax tokens, reported only."""
    import dataclasses

    import torch

    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(model.cfg, n_layers=MOE_ANCHOR_DEPTH)
    p = {n: t for n, t in params.items()
         if not n.startswith("blocks/") or int(n.split("/")[1]) < MOE_ANCHOR_DEPTH}
    batch, T = {"tokens": prompts}, prompts.shape[1]
    with torch.inference_mode():
        lb = build_model(cfg).prefill(p, batch, T)[0][:, -1].float()
        lf = build_model(dataclasses.replace(cfg, dtype="float32")).prefill(
            {k: v.float() for k, v in p.items()}, batch, T)[0][:, -1]
    res = {"layers": MOE_ANCHOR_DEPTH, "rel_err": _rel_norm(lb, lf),
           "argmax_equal": float((lb.argmax(-1) == lf.argmax(-1)).float().mean())}
    print(f"moe anchor (reported, not a limit): deepseek-v2-lite-16b's bf16 prefill logits at "
          f"{MOE_ANCHOR_DEPTH} layers against fp32 on the same weights: relative error of the "
          f"norm {res['rel_err']:.3e}, argmax equal in {res['argmax_equal']:.2f} of the rows",
          flush=True)
    return res


def serve_moe_path(dev, arch: str) -> dict:
    """Main path 16 (a), (b): a DeepSeek arch at full width (depth cut by
    ``MOE_DEPTH``, built with mtp=False; bf16, random weights from seed 0
    drawn on the card) serves batch 4 x 2,048-token prompts (numpy seed 1)
    for 32 greedy tokens through ``generate`` (:func:`timed_generate`): no
    kernel of the port in the prefill or in decode.  One prefill and one
    decode step traced; the decode step's weight-read bound (every weight
    but the embedding table); the choices the capacity dropped in a prefill
    and in one decode step, counted from the dispatch.  Then V2-Lite's
    block check (:func:`check_moe_block`) and bf16-vs-fp32 report
    (:func:`moe_anchor`), or V3's router check (:func:`check_moe_router`),
    on the first ``MOE_CHECK_PROMPT`` tokens of the prompts; the tiny
    config served on the card against the CPU."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import build_model

    full = get_arch(arch)
    L = MOE_DEPTH.get(arch, full.n_layers)
    cfg = dataclasses.replace(full, n_layers=L, mtp=False)
    cut = (f", depth cut from {full.n_layers} to {L} layers, the MTP block left out"
           if L != full.n_layers else "")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, dev)
    n_params = sum(v.numel() for v in params.values())
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    cache_len = SERVE_PROMPT + SERVE_STEPS + 1
    wrappers = kernel_wrappers()
    run = timed_generate(model, params, prompts, cache_len, wrappers[4:])
    st = run["stats"]
    if any(c[0] for c in run["total"]):
        raise AssertionError(f"moe {arch}: the port's kernels launched {run['total']}")
    m = cfg.mla
    res = {"arch": arch, "layers": L, "full_layers": full.n_layers, "params": n_params,
           "dtype": cfg.dtype, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
           "steps": SERVE_STEPS, **st}
    print(f"moe path: {arch} at full width ({cfg.d_model}, MLA {cfg.n_heads} heads, q/k "
          f"{m.qk_nope_dim}+{m.qk_rope_dim}, v {m.v_head_dim}, kv_lora {m.kv_lora}, q_lora "
          f"{m.q_lora}; {cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
          f"{cfg.moe.num_shared} shared of {cfg.moe.expert_ff}){cut}: {n_params} params "
          f"({cfg.dtype}), batch {SERVE_BATCH} x {SERVE_PROMPT}-token prompts, {SERVE_STEPS} "
          f"greedy tokens: prefill {st['prefill_ms']:.2f} ms, decode "
          f"{st['decode_ms_per_step']:.2f} ms a step ({st['decode_tok_per_s']:.1f} tokens/s), "
          f"{st['e2e_tok_per_s']:.1f} tokens/s end to end, peak device memory "
          f"{st['peak_gib']:.3f} GiB; launches of the port's kernels: 0 in the prefill, 0 in "
          f"decode", flush=True)
    del run
    res.update(traced_serve(f"moe {arch}", model, params, {"tokens": prompts}, cache_len,
                            ("nvjet", "elementwise", "reduce", "Sort"), top=8))
    for phase, wall in (("prefill", st["prefill_ms"]), ("decode", st["decode_ms_per_step"])):
        res[f"{phase}_trace"]["busy_share"] = res[f"{phase}_trace"]["device_ms"] / wall
    print(f"moe {arch}: device busy share (traced device ms over the untimed wall): prefill "
          f"{res['prefill_trace']['busy_share']:.3f}, decode "
          f"{res['decode_trace']['busy_share']:.3f}", flush=True)
    res.update(decode_bound(f"moe {arch}", {k: v for k, v in params.items() if k != "embed"},
                            L * SERVE_BATCH * cache_len * (m.kv_lora + m.qk_rope_dim) * 2, st))
    with torch.inference_mode():
        with dispatch_seen() as seen:
            lg, cache = model.prefill(params, {"tokens": prompts}, cache_len)
        res["prefill_drops"] = drops_of(seen)
        with dispatch_seen() as seen:
            model.decode_step(params, torch.argmax(lg[:, -1], dim=-1, keepdim=True), cache)
        res["decode_drops"] = drops_of(seen)
    del lg, cache, seen
    print(f"moe {arch} capacity drops (choices dropped of made, tokens losing a choice): prefill "
          f"{res['prefill_drops']['assignments_dropped']} of {res['prefill_drops']['assignments']},"
          f" {res['prefill_drops']['tokens_losing_a_choice']} of "
          f"{res['prefill_drops']['tokens']} token-layers; one decode step "
          f"{res['decode_drops']['assignments_dropped']} of {res['decode_drops']['assignments']}, "
          f"{res['decode_drops']['tokens_losing_a_choice']} of {res['decode_drops']['tokens']}",
          flush=True)
    torch.cuda.empty_cache()
    check = prompts[:, :MOE_CHECK_PROMPT]
    if arch == "deepseek-v2-lite-16b":
        res["block_check"] = check_moe_block(dev, cfg, params, check)
        res["anchor"] = moe_anchor(model, params, prompts)
    else:
        res["router_check"] = check_moe_router(dev, cfg, params, check)
    del params
    torch.cuda.empty_cache()
    res["tiny_card_vs_cpu_err"] = check_serve_tiny(dev, arch)
    print(f"moe {arch}-tiny served on the card vs the port on the CPU: equal tokens, logits max "
          f"abs diff {res['tiny_card_vs_cpu_err']:.3e}", flush=True)
    return res


def moe_train_paths(dev) -> dict:
    """Main path 16 (d): the smoke run (``launch/train.py:run_smoke``: the
    reduced config, 6 clients, 3 a round, 32-token samples) of both DeepSeek
    archs (V3 with its MTP block), ``ZOO_TRAIN_ROUNDS`` rounds in each
    cohort mode on the card, each held to the same run of the port on the
    CPU (:func:`card_vs_cpu`), both from the weights seed 0 draws on the
    CPU; the final params' ``ce``, ``aux`` and ``mtp_ce`` on a fixed batch
    printed."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import run_smoke
    from repro_torch.models.model import Model, build_model

    init = Model.init

    def cpu_drawn(self, seed, device):
        return {k: v.to(device) for k, v in init(self, seed, "cpu").items()}

    res = {}
    for arch in MOE_SERVE:
        model = build_model(get_arch(arch).reduced())
        toks = torch.as_tensor(np.random.default_rng(4).integers(0, model.cfg.vocab, (2, 33)),
                               device=dev)
        for mode in ("vmapped", "sequential"):
            with swapped({(Model, "init"): cpu_drawn}):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                card = run_smoke(arch, ZOO_TRAIN_ROUNDS, device=dev, cohort_mode=mode)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                cpu = run_smoke(arch, ZOO_TRAIN_ROUNDS, device="cpu", cohort_mode=mode)
            with torch.no_grad():
                _, mets = model.loss(card.state.params, {"tokens": toks})
            row = {"wall_s": wall, "local_loss": [r["local_loss"] for r in card.metrics.rows],
                   **{k: float(v) for k, v in mets.items()},
                   "card_vs_cpu": card_vs_cpu(f"{arch} {mode} smoke", card.state.params,
                                              cpu.state.params)}
            if not all(math.isfinite(v) for v in row["local_loss"] + [row["ce"], row["aux"]]) \
                    or ("mtp_ce" in row) != model.cfg.mtp:
                raise AssertionError(f"moe train {arch} {mode}: {row}")
            res[f"{arch} {mode}"] = row
            print(f"moe train {arch} {mode}: {ZOO_TRAIN_ROUNDS} rounds on the card in {wall:.2f} "
                  f"s, local_loss {row['local_loss']}; after them on a fixed batch ce "
                  f"{row['ce']:.5f}, aux {row['aux']:.5f}"
                  + (f", mtp_ce {row['mtp_ce']:.5f}" if "mtp_ce" in row else "")
                  + f"; max share of a leaf's largest magnitude off the CPU "
                    f"{row['card_vs_cpu']:.3e} (bound {CARD_CPU_RTOL})", flush=True)
    return res


def moe_paths(dev, rows: list) -> dict:
    """Main path 16, MLA and the moe family: (a) DeepSeek-V2-Lite-16B and (b)
    DeepSeek-V3-671B (2 of 61 layers) served (:func:`serve_moe_path`, each
    with its checks (c), each model freed before the next), (d) both
    archs' smoke runs (:func:`moe_train_paths`).  Every kernel wrapper's
    launch count is set to 0 just before and read just after: the path
    runs no kernel of the port (the JAX package's MLA and MoE reach no
    Pallas kernel either), which each row of ``rows`` records."""
    t0 = time.perf_counter()
    wrappers = kernel_wrappers()
    zero_counts(*wrappers)
    res = {arch: serve_moe_path(dev, arch) for arch in MOE_SERVE}
    res["train"] = moe_train_paths(dev)
    launched = {w.__name__: w.launches for w in wrappers}
    if any(launched.values()):
        raise AssertionError(f"moe paths: the port's kernels launched {launched}")
    for row in rows:
        row["launches_path_16"] = 0
    res["seconds"] = time.perf_counter() - t0
    print(f"moe paths: launches of the port's kernels {launched}; {res['seconds']:.1f} s",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# main path 17: remat, banded attention, the one-hot cross entropy
# ---------------------------------------------------------------------------

REMAT_ROUNDS = 3               # (a)'s rounds: the wall is the mean of the rounds after the first
REMAT_ARCH = "qwen2-72b"
REMAT_DEPTHS = (2, 4)           # Qwen2-72B's layers (of 80) for the peak's growth a layer
REMAT_BAND = dict(T=4096, H=25, KV=5, hd=64, window=1024)   # Hymba-1.5B's attention


def shifted_recompute():
    """A planted fault: a ``remat`` whose backward pass recomputes each
    layer at positions shifted by one (every integer input of the body)."""
    from repro_torch.models import remat

    class ShiftedRecompute(remat._Checkpoint):
        @staticmethod
        def backward(ctx, *cts):
            xs = tuple(x if x.is_floating_point() else x + 1 for x in ctx.saved_tensors)
            return (None, *remat.recompute_vjp(ctx.body, xs, cts))

    return swapped({(remat, "_Checkpoint"): ShiftedRecompute})


def timed_grad(model, params: dict, batch: dict) -> tuple:
    """``core/local.py:value_and_grad`` of ``model.loss`` -> (loss, grads,
    wall ms to a synchronize, peak bytes after a reset)."""
    import torch

    from repro_torch.core.local import value_and_grad

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = value_and_grad(model.loss, params, batch)
    torch.cuda.synchronize()
    return loss, grads, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated()


def grads_differ(got: dict, want: dict) -> list:
    """The leaves of ``got`` not bitwise those of ``want`` (on the host or
    the card), compared a leaf at a time on ``got``'s device."""
    import torch

    return [k for k, w in want.items() if not torch.equal(got[k], w.to(got[k].device))]


def remat_e2e_path(dev) -> dict:
    """Main path 17 (a): the e2e CharLM-100M run in the vmapped padded mode
    (``run_charlm_e2e``, the cohort engine with ``rr_backend="device"``),
    ``REMAT_ROUNDS`` rounds with ``remat="none"`` and with ``"full"``: the
    parameters after them bitwise equal; each run's round wall and peak;
    then one round of each traced (:func:`round_kernels`): its device
    kernels and device ms, the recompute's cost without the host's."""
    import torch

    res, kept = {}, None
    for remat in ("none", "full"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = run_main_path(dev, "device", REMAT_ROUNDS, remat=remat, **VMAPPED)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        wall = report_rounds(f"remat path (a), vmapped dense, remat={remat!r}", run,
                             time.perf_counter() - t0, peak, REMAT_ROUNDS)
        res[remat] = {"round_ms": wall, "peak_gib": peak / 2**30}
        if kept is None:      # held on the host: the next run's peak is its own
            kept = {k: v.cpu() for k, v in run.state.params.items()}
        else:
            differ = grads_differ(run.state.params, kept)
            if differ:
                raise AssertionError(f"remat path (a): params with remat differ in {differ}")
        del run
    for remat in ("none", "full"):
        res[remat]["kernels"], res[remat]["device_ms"] = round_kernels(dev, remat=remat,
                                                                       **VMAPPED)
    print(f"remat path (a), CharLM-100M vmapped dense, {REMAT_ROUNDS} rounds: params with "
          f"remat='full' bitwise those without; round wall {res['full']['round_ms']:.1f} vs "
          f"{res['none']['round_ms']:.1f} ms, peak {res['full']['peak_gib']:.3f} vs "
          f"{res['none']['peak_gib']:.3f} GiB; one traced round: "
          f"{res['full']['device_ms']:.1f} vs {res['none']['device_ms']:.1f} ms of device "
          f"time in {res['full']['kernels']} vs {res['none']['kernels']} device kernels and "
          f"copies", flush=True)
    return res


def remat_step_path(dev) -> dict:
    """Main path 17 (b): one sequential-mode client step of CharLM-100M
    (``value_and_grad`` of the loss over a ``local_batch`` of 4 x 128
    tokens, numpy seed 2) with ``remat="none"`` and ``"full"``, each after a
    warm-up: loss and gradients bitwise equal; then the planted fault
    (:func:`shifted_recompute`), whose gradients the same comparison must
    find different."""
    import dataclasses

    import torch

    from repro_torch.launch.train import charlm_e2e_config
    from repro_torch.models.model import build_model

    cfg, fl = charlm_e2e_config()
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (fl.local_batch, 129)), device=dev)
    params = build_model(cfg).init(0, dev)
    res, got = {}, {}
    for remat in ("none", "full"):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        timed_grad(model, params, {"tokens": toks})
        loss, grads, ms, peak = timed_grad(model, params, {"tokens": toks})
        # held on the host: the next step's peak is its own
        got[remat] = (loss, {k: g.cpu() for k, g in grads.items()})
        del grads
        res[remat] = {"ms": ms, "peak_gib": peak / 2**30}
    (l0, g0), (l1, g1) = got["none"], got["full"]
    differ = grads_differ(g1, g0)
    if not torch.equal(l0, l1) or differ:
        raise AssertionError(f"remat path (b): loss equal {torch.equal(l0, l1)}, grads differ "
                             f"in {differ}")
    with shifted_recompute():
        f_loss, f_grads = timed_grad(model, params, {"tokens": toks})[:2]
    caught = grads_differ(f_grads, g0)
    if not torch.equal(f_loss, l0) or not caught:
        raise AssertionError("remat path (b): the recompute at shifted positions was not caught")
    res["fault_leaves_off"] = len(caught)
    print(f"remat path (b), CharLM-100M one sequential client step: loss and {len(g0)} "
          f"gradients with remat='full' bitwise those without; {res['full']['ms']:.1f} vs "
          f"{res['none']['ms']:.1f} ms, peak {res['full']['peak_gib']:.3f} vs "
          f"{res['none']['peak_gib']:.3f} GiB; the planted fault (a recompute at positions "
          f"shifted by one) caught: {len(caught)} of {len(g0)} gradients differ", flush=True)
    return res


def remat_qwen_path(dev) -> dict:
    """Main path 17 (c): Qwen2-72B at full width, bf16, random weights from
    seed 0, depth cut to ``REMAT_DEPTHS`` layers of 80: one ``value_and_grad``
    of the loss over batch 1 x ``train_4k``'s 4,096 tokens (+1 for the
    labels, numpy seed 2) with ``remat="none"`` and ``"full"`` at each depth,
    the deeper first (after one warm-up step), each depth's step with its
    own layers alone allocated (the deeper ones freed before it): each
    step's peak and wall; at the larger depth the loss and every gradient
    bitwise equal (the first run's held on the host); the peak's growth a
    layer between the depths, and from it the deepest depth whose step fits
    the card's memory."""
    import dataclasses

    import torch

    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import build_model

    full = get_arch(REMAT_ARCH)
    lo, hi = REMAT_DEPTHS
    cfg = dataclasses.replace(full, n_layers=hi)
    T = INPUT_SHAPES["train_4k"].seq_len
    torch.cuda.empty_cache()
    params = build_model(cfg).init(0, dev)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, T + 1)), device=dev)}
    total = torch.cuda.get_device_properties(0).total_memory

    def model(L, remat):
        return build_model(dataclasses.replace(cfg, n_layers=L, remat=remat))

    timed_grad(model(hi, "none"), params, batch)      # warm-up
    res, kept = {"layers": list(REMAT_DEPTHS), "full_layers": full.n_layers, "tokens": T,
                 "card_bytes": total}, None
    for L in (hi, lo):
        for k in [k for k in params if k.startswith("blocks/") and int(k.split("/")[1]) >= L]:
            del params[k]
        for remat in ("none", "full"):
            loss, grads, ms, peak = timed_grad(model(L, remat), params, batch)
            if not torch.isfinite(loss) or not all(torch.isfinite(g).all()
                                                   for g in grads.values()):
                raise AssertionError(f"remat path (c): {L} layers, {remat}: non-finite")
            res[f"{remat}_{L}"] = {"ms": ms, "peak_gib": peak / 2**30, "loss": float(loss)}
            print(f"remat path (c), {REMAT_ARCH} at full width, {L} of {full.n_layers} layers, "
                  f"{cfg.dtype}, 1 x {T} tokens, remat={remat!r}: loss {float(loss):.5f}, "
                  f"value_and_grad {ms:.1f} ms, peak {peak / 2**30:.3f} GiB", flush=True)
            if L == hi and kept is None:
                kept = (loss, {k: g.cpu() for k, g in grads.items()})
            elif L == hi:
                differ = grads_differ(grads, kept[1])
                if not torch.equal(loss, kept[0]) or differ:
                    raise AssertionError(f"remat path (c): loss equal "
                                         f"{torch.equal(loss, kept[0])}, grads differ in "
                                         f"{differ}")
            del grads
    del kept, params
    torch.cuda.empty_cache()
    for remat in ("none", "full"):
        p_lo = res[f"{remat}_{lo}"]["peak_gib"] * 2**30
        p_hi = res[f"{remat}_{hi}"]["peak_gib"] * 2**30
        growth = (p_hi - p_lo) / (hi - lo)
        if growth <= 0:
            raise AssertionError(f"remat path (c), {remat}: the peak at {hi} layers is not above "
                                 f"the peak at {lo}")
        res[f"{remat}_growth_gib_a_layer"] = growth / 2**30
        res[f"{remat}_deepest"] = hi + int((total - p_hi) // growth)
    print(f"remat path (c): loss and gradients at {hi} layers with remat='full' bitwise those "
          f"without; the peak grows {res['none_growth_gib_a_layer']:.3f} GiB a layer without "
          f"remat and {res['full_growth_gib_a_layer']:.3f} with it, so the deepest "
          f"{REMAT_ARCH} step that fits the card's {total / 2**30:.2f} GiB is reckoned at "
          f"{res['none_deepest']} layers without remat and {res['full_deepest']} with it",
          flush=True)
    return res


def remat_attention_xent_path(dev) -> dict:
    """Main path 17 (d) and (e): ``attend(banded=True)`` against the
    unbanded ``attend`` at Hymba-1.5B's attention (q [1, 4096, 25, 64],
    k/v [1, 4096, 5, 64], window 1,024), bf16 within ``FLASH_TOL``'s 2e-2
    and fp32 within its 2e-5, both timed; the one-hot cross entropy at
    Qwen2-72B's vocab ([4096, 152064] fp32 logits) against the gather,
    bitwise (one value times 1 plus exact zeros), both timed."""
    import torch

    from repro_torch.models.attention import attend
    from repro_torch.models.layers import softmax_xent

    b = REMAT_BAND
    gen = torch.Generator(device=dev).manual_seed(3)
    res = {}
    for dt in ("bfloat16", "float32"):
        q, k, v = (torch.randn(1, b["T"], h, b["hd"], generator=gen, device=dev,
                               dtype=getattr(torch, dt)) for h in (b["H"], b["KV"], b["KV"]))
        banded = attend(q, k, v, window=b["window"], banded=True)
        plain = attend(q, k, v, window=b["window"])
        err = _allclose(banded, plain, FLASH_TOL[dt], FLASH_TOL[dt], f"banded attend, {dt}")
        ms = time_ms(lambda: attend(q, k, v, window=b["window"], banded=True), 10)[0]
        plain_ms = time_ms(lambda: attend(q, k, v, window=b["window"]), 10)[0]
        res[f"band_{dt}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"remat path (d), banded attention at Hymba's [1, {b['T']}, {b['H']}/{b['KV']}, "
              f"{b['hd']}], window {b['window']}, {dt}: max abs diff from unbanded {err:.3e} "
              f"(bound {FLASH_TOL[dt]}); {ms:.3f} vs {plain_ms:.3f} ms", flush=True)
        del q, k, v, banded, plain
    from repro_torch.configs.registry import get_arch

    V = get_arch(REMAT_ARCH).vocab
    logits = torch.randn(4096, V, generator=gen, device=dev) * 4
    labels = torch.randint(0, V, (4096,), generator=gen, device=dev)
    onehot, gather = softmax_xent(logits, labels, onehot=True), softmax_xent(logits, labels)
    if not torch.equal(onehot, gather):
        raise AssertionError(f"remat path (e): the one-hot cross entropy differs from the "
                             f"gather's by {float((onehot - gather).abs().max()):.3e}")
    ms = time_ms(lambda: softmax_xent(logits, labels, onehot=True), 10)[0]
    gather_ms = time_ms(lambda: softmax_xent(logits, labels), 10)[0]
    res["onehot_xent"] = {"ms": ms, "gather_ms": gather_ms}
    print(f"remat path (e), the one-hot cross entropy at [4096, {V}] fp32: bitwise the "
          f"gather's; {ms:.3f} vs {gather_ms:.3f} ms", flush=True)
    return res


def remat_paths(dev, rows: list) -> dict:
    """Main path 17: (a) :func:`remat_e2e_path`, (b) :func:`remat_step_path`
    with the planted fault, (c) :func:`remat_qwen_path`, (d, e)
    :func:`remat_attention_xent_path`.  Every kernel wrapper's launch count
    is set to 0 just before and read just after: rr_perm launches once a
    round of (a), its traced rounds included, and no other kernel of the port runs (the train loss
    reaches none, nor does the JAX package's), which each row of ``rows``
    (the kernels line's, rr_perm's first) records."""
    t0 = time.perf_counter()
    wrappers = kernel_wrappers()
    zero_counts(*wrappers)
    res = {"e2e": remat_e2e_path(dev), "step": remat_step_path(dev),
           "qwen": remat_qwen_path(dev), "attention_xent": remat_attention_xent_path(dev)}
    launched = [w.launches for w in wrappers]
    want = [2 * REMAT_ROUNDS + 2] + [0] * (len(wrappers) - 1)
    if launched != want:
        raise AssertionError(f"remat paths: the port's kernels launched {launched}, want {want}")
    for row, n in zip(rows, launched):
        row["launches_path_17"] = n
    res["seconds"] = time.perf_counter() - t0
    print(f"remat paths: launches of the port's kernels "
          f"{ {w.__name__: w.launches for w in wrappers} }; {res['seconds']:.1f} s", flush=True)
    return res


# -- main path 18: the launch tools, Hymba-1.5B at the four assigned shapes --

LAUNCH_ARCH = "hymba-1.5b"
LAUNCH_RING_ARCH = "qwen1.5-0.5b"      # a dense arch: long_500k through the serve_window_long ring
# (a) prefill_32k: one sequence of 32,768 tokens; the plain flash version is
# held on the last LAUNCH_CHECK_ROWS query rows of each launch (over all keys)
LAUNCH_CHECK_ROWS = 128
# (d) train_4k: one client x 1 x 4,096 tokens.  Without remat or a banded
# window a layer keeps ~2.5 GB of fp32 scores and bf16 probabilities for its
# backward (25 heads x 4,096 x 4,096), so 32 layers do not fit a card: the
# baseline runs 16 of them (recorded in its setup's ``reduced``)
LAUNCH_TRAIN_DEPTH = {"baseline": 16}
LAUNCH_COUNTS_DIR = ROOT / "build" / "dryrun" / "launch_paths"
# (b) decode_32k: the largest batch, up to the shape's 128, whose weights and
# cache take at most this much of the card's 80 GB
LAUNCH_DECODE_BUDGET = 60 * 2**30
# path 18's outputs held for main path 19 (the same steps through a mesh)
MESHLESS_TWINS: dict = {}


def launch_decode_batch() -> int:
    """decode_32k's batch for one card: the largest up to the shape's global
    batch whose weights and cache (``Model.cache_spec``) fit
    ``LAUNCH_DECODE_BUDGET``, counted on the meta device."""
    import torch

    from repro_torch.configs.registry import get_arch, get_shape
    from repro_torch.launch.specs import decode_cache_len
    from repro_torch.models.model import build_model

    cfg, shape = get_arch(LAUNCH_ARCH), get_shape("decode_32k")
    model = build_model(cfg)
    weights = sum(v.numel() * v.element_size() for v in model.init(0, "meta").values())
    cache = sum(math.prod(s) * torch.empty((), dtype=d).element_size()
                for s, d in model.cache_spec(1, decode_cache_len(cfg, shape.seq_len)[1]).values())
    return min(shape.global_batch, int((LAUNCH_DECODE_BUDGET - weights) // cache))


def launch_shares() -> list[dict]:
    """Path 18's setups: (label, arch, shape, setup keywords, hillclimb
    overrides), one card's share of each assigned shape."""
    from repro_torch.launch.hillclimb import PAIRS

    arch, shape, iters = PAIRS["hymba"]
    shares = [dict(label="prefill_32k", arch=LAUNCH_ARCH, shape="prefill_32k", kw=dict(batch=1)),
              dict(label="decode_32k", arch=LAUNCH_ARCH, shape="decode_32k",
                   kw=dict(batch=launch_decode_batch())),
              dict(label="long_500k", arch=LAUNCH_ARCH, shape="long_500k", kw={}),
              dict(label="long_500k_ring", arch=LAUNCH_RING_ARCH, shape="long_500k", kw={})]
    for tag, overrides, _ in [("baseline", {}, "")] + iters:
        name = tag.split("-")[-1]
        shares.append(dict(label=f"train_4k_{name}", arch=arch, shape=shape, overrides=overrides,
                           kw=dict(dp=1, batch=1, n_layers=LAUNCH_TRAIN_DEPTH.get(name))))
    return shares


def launch_counts(out_dir: Path) -> None:
    """Count each share of :func:`launch_shares` on the meta device
    (``launch/dryrun.py:run_one``) into ``out_dir``: run in a child process
    while the earlier paths hold the card, since the counts take a minute of
    one host core."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.hillclimb import _resolve

    torch.set_num_threads(1)
    for s in launch_shares():
        rec = dryrun.run_one(s["arch"], s["shape"], out_dir=str(out_dir), tag=s["label"],
                             cfg=_resolve(s["arch"], s.get("overrides", {})), **s["kw"])
        if not rec["ok"]:
            raise SystemExit(f"count of {s['label']} failed: {rec['error']}")


def read_launch_counts(proc, out_dir: Path) -> dict:
    """Wait for the child of :func:`launch_counts` and read its records:
    label -> the record, with its bound (ms) and what bounds it."""
    from repro_torch.launch.mesh import BF16_FLOP_PER_S, HBM_BYTES_PER_S

    if proc.wait(timeout=900) != 0:
        raise RuntimeError(f"the launch counts' process exited {proc.returncode}")
    out = {}
    for s in launch_shares():
        path = out_dir / f"{s['arch']}_{s['shape']}_1xH100_{s['label']}.json"
        rec = json.loads(path.read_text())
        c = rec["cost"]
        terms = {"operations": c["flops_kernel"] / BF16_FLOP_PER_S * 1e3,
                 "bytes": c["bytes_min"] / HBM_BYTES_PER_S * 1e3}
        rec["bound_ms"], rec["bound_by"] = max(terms.values()), max(terms, key=terms.get)
        out[s["label"]] = rec
    return out


def launch_step(label: str, run, count: dict, *, grad: bool = False,
                peak: int | None = None) -> dict:
    """Run ``run()`` (a setup's step) on the card: once to warm up (its peak
    memory; with ``peak``, the caller's plain run of the step was both),
    once timed on the host's clock, once traced (its device kernels' time);
    print the step's count, bound, wall, device time and peak, and fail if
    the device time falls under the bound (the count would be wrong)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step():
        with (contextlib.nullcontext() if grad else torch.inference_mode()):
            out = run()
        torch.cuda.synchronize()
        return out

    if peak is None:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = step()
        peak = torch.cuda.max_memory_allocated()
        del out
    t0 = time.perf_counter()
    step()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
    kernels, device = count_device(prof)
    c = count["cost"]
    res = {"reduced": count["reduced"], "flops": c["flops"], "flops_kernel": c["flops_kernel"],
           "bytes_min": c["bytes_min"], "bound_ms": count["bound_ms"],
           "bound_by": count["bound_by"], "wall_ms": wall, "device_ms": device,
           "device_kernels": kernels, "peak_gib": peak / 2**30}
    print(f"launch {label} ({', '.join(count['reduced']) or 'no cut'}): counted "
          f"{c['flops']:.6e} flops, {c['flops_kernel']:.6e} flops_kernel, {c['bytes_min']:.6e} "
          f"bytes_min; bound {count['bound_ms']:.3f} ms ({count['bound_by']}); wall "
          f"{wall:.2f} ms, device {device:.2f} ms in {kernels} kernels; peak "
          f"{peak / 2**30:.3f} GiB", flush=True)
    if device < count["bound_ms"]:
        raise AssertionError(f"launch {label}: device time {device:.3f} ms under the bound "
                             f"{count['bound_ms']:.3f} ms: the count is wrong")
    return res


def launch_prefill_path(dev, counts: dict) -> dict:
    """(a) prefill_32k, batch 1: 32 flash and 32 SSD launches at T = 32,768,
    each flash launch held to the plain version on its last
    ``LAUNCH_CHECK_ROWS`` query rows over all keys and each SSD launch to the
    plain version whole, at the serving path's tolerances; then timed."""
    import torch

    import repro_torch.kernels.flash_attention.ops as fops
    import repro_torch.kernels.ssd.ops as sops
    from repro_torch.configs.registry import get_arch, get_shape
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import _rows, flash_attention_torch
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_kernel
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_torch
    from repro_torch.launch.specs import make_setup

    setup = make_setup(get_arch(LAUNCH_ARCH), get_shape("prefill_32k"), device=dev, batch=1)
    err = {"flash_attention": 0.0, "ssd_intra_chunk": 0.0}
    seen = {"flash_T": set(), "ssd_chunks": set()}
    last = {}

    def flash(q, k, v, *, causal=True, window=0):
        got = flash_attention_kernel(q, k, v, causal=causal, window=window)
        T, r0 = q.shape[2], q.shape[2] - LAUNCH_CHECK_ROWS
        want = _rows(q[:, :, r0:], k, v, r0, causal=causal, window=window)
        err["flash_attention"] = max(err["flash_attention"], _allclose(
            got[:, :, r0:], want, FLASH_MAIN_BF16_ATOL, FLASH_MAIN_BF16_RTOL,
            f"prefill_32k flash, the last {LAUNCH_CHECK_ROWS} rows"))
        seen["flash_T"].add(T)
        last["flash"] = (q, k, v, causal, window)
        return got

    def ssd(*args):
        out = ssd_intra_chunk_kernel(*args)
        for got, want in zip(out, ssd_intra_chunk_torch(*args)):
            err["ssd_intra_chunk"] = max(err["ssd_intra_chunk"], _allclose(
                got, want, SSD_ATOL, SSD_RTOL, "prefill_32k ssd"))
        seen["ssd_chunks"].add(args[0].shape[1])
        last["ssd"] = args
        return out

    kernels = (flash_attention_kernel, ssd_intra_chunk_kernel)
    zero_counts(*kernels)
    with swapped({(fops, "flash_attention_kernel"): flash, (sops, "ssd_intra_chunk_kernel"): ssd}):
        with torch.inference_mode():
            logits, cache = setup.fn(*setup.args)
    (nf, flash_routes, _), (ns, ssd_routes, _) = read_counts(*kernels)
    L = get_arch(LAUNCH_ARCH).n_layers
    if (nf, ns) != (L, L) or flash_routes["mma"] != L or ssd_routes["mma"] != L or \
            seen != {"flash_T": {32768}, "ssd_chunks": {256}}:
        raise AssertionError(f"prefill_32k launches: flash {nf} {flash_routes}, ssd {ns} "
                             f"{ssd_routes}, shapes {seen}")
    if logits.shape != (1, 1, get_arch(LAUNCH_ARCH).vocab) or not torch.isfinite(logits).all():
        raise AssertionError("prefill_32k: bad logits")
    print(f"launch prefill_32k: {L} flash_attention launches at T = 32768 (mma), each within "
          f"{FLASH_MAIN_BF16_ATOL} + 2^-7 |ref| of the plain version on its last "
          f"{LAUNCH_CHECK_ROWS} query rows (max abs diff {err['flash_attention']:.3e}); {L} "
          f"ssd_intra_chunk launches over 256 chunks (mma), within atol {SSD_ATOL} / rtol "
          f"{SSD_RTOL} of the plain version (max abs diff {err['ssd_intra_chunk']:.3e})",
          flush=True)
    MESHLESS_TWINS["prefill_32k"] = (logits, cache)     # main path 19's twin
    del logits, cache
    # one launch of each at T = 32,768, the last layer's inputs
    q, k, v, causal, window = last.pop("flash")
    T, H, hd = q.shape[2], q.shape[1], q.shape[3]
    flash_ms = time_ms(lambda: flash_attention_kernel(q, k, v, causal=causal, window=window),
                       20)[0]
    flash_bound = 4 * H * hd * band_pairs(0, T, 0, T, window=window) / BF16_FLOP_PER_S * 1e3
    flash_plain = time_ms(lambda: flash_attention_torch(q, k, v, causal=causal, window=window),
                          2, behind_sleep=False)[0]
    sdpa_ms, sdpa_err = sdpa_band_ms(q, k, v, window, flash_attention_kernel(
        q, k, v, causal=causal, window=window))
    args = last.pop("ssd")
    ssd_ms = time_ms(lambda: ssd_intra_chunk_kernel(*args), 20)[0]
    ssd_plain = time_ms(lambda: ssd_intra_chunk_torch(*args), 2, behind_sleep=False)[0]
    ssd_bytes = sum(t.numel() * t.element_size() for t in (*args, *ssd_intra_chunk_kernel(*args)))
    ssd_bound = ssd_bytes / HBM_BYTES_PER_S * 1e3
    print(f"launch prefill_32k: a flash_attention launch at [1, {T}, {H}/{k.shape[1]}, {hd}], "
          f"window {window}: {flash_ms:.4f} ms against its operations bound {flash_bound:.4f} "
          f"ms (the plain version {flash_plain:.2f} ms); an ssd_intra_chunk launch over "
          f"{args[0].shape[1]} chunks: {ssd_ms:.4f} ms against its byte bound {ssd_bound:.4f} "
          f"ms ({ssd_bytes} B; the plain version {ssd_plain:.2f} ms); SDPA on the "
          f"memory-efficient backend with a bool band mask [1, 1, {T}, {T}], k/v expanded to "
          f"{H} heads outside the timed call: {sdpa_ms:.4f} ms (the kernel "
          f"{flash_ms / sdpa_ms:.2f}x its time; max abs diff {sdpa_err:.3e} from the kernel)",
          flush=True)
    del q, k, v, args
    zero_counts(*kernels)
    res = launch_step("prefill_32k", lambda: setup.fn(*setup.args), counts["prefill_32k"])
    # the warm-up, timed and traced prefills: L launches of each
    res["launches"] = {"flash_attention": flash_attention_kernel.launches,
                       "ssd_intra_chunk": ssd_intra_chunk_kernel.launches}
    if res["launches"] != {"flash_attention": 3 * L, "ssd_intra_chunk": 3 * L}:
        raise AssertionError(f"prefill_32k: {res['launches']} launches in 3 prefills")
    res["layer_max_abs_err"] = err
    res["T32768"] = {"flash_attention": {"ms": flash_ms, "bound_ms": flash_bound,
                                         "plain_ms": flash_plain, "library_ms": sdpa_ms,
                                         "library_max_abs_err": sdpa_err},
                     "ssd_intra_chunk": {"ms": ssd_ms, "bound_ms": ssd_bound,
                                         "plain_ms": ssd_plain}}
    del setup
    return res


def sdpa_band_ms(q, k, v, window: int, got) -> tuple[float, float]:
    """(ms, max abs diff from ``got``) of ``F.scaled_dot_product_attention``
    on the memory-efficient backend computing a causal windowed flash
    launch's function: q [1, H, T, hd], k/v [1, KV, T, hd] expanded to H
    heads and a bool band mask [1, 1, T, T] (1 GiB at T = 32,768) made
    outside the timed call (the math backend's fp32 scores, H x T^2, do not
    fit the card)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    T, g = q.shape[2], q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(g, dim=1) for t in (k, v))
    i = torch.arange(T, device=q.device)
    diff = i[:, None] - i[None, :]
    mask = ((diff >= 0) & (diff < window) if window else diff >= 0)[None, None]
    del diff
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        def call():
            return F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
        out = call()
        err = float((out.float() - got.float()).abs().max())
        del out
        ms = time_ms(call, 5)[0]
    del ke, ve, mask
    torch.cuda.empty_cache()
    return ms, err


def captured_attend(checks: list):
    """A stand-in for ``models.attention.attend`` that holds each decode
    step's attention (``kv_valid`` given) within ``FLASH_TOL["bfloat16"]``
    of an fp64 softmax over every valid key of the cache: ``checks`` gains
    (the largest difference, the valid keys) a call."""
    import torch

    from repro_torch.models import attention

    plain = attention.attend

    def attend(q, k, v, q_pos=None, kv_pos=None, **kw):
        out = plain(q, k, v, q_pos, kv_pos, **kw)
        valid = kw.get("kv_valid")
        if valid is not None:
            B, Tq, H, hd = q.shape
            KV = k.shape[2]
            qg = q.double().reshape(B, Tq, KV, H // KV, hd)
            s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.double()) / hd ** 0.5
            s = s.masked_fill(~valid[:, None, None, None, :], -torch.inf)
            want = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1), v.double())
            checks.append((_allclose(out, want.reshape(out.shape), FLASH_TOL["bfloat16"],
                                     FLASH_TOL["bfloat16"], "a decode step's attention"),
                           int(valid.sum())))
        return out

    return attend


def launch_decode_path(dev, label: str, arch: str, shape: str, kw: dict, counts: dict) -> dict:
    """(b), (c) one decode step against a random full cache at pos =
    seq_len - 1: each layer's attention held to an fp64 softmax over the
    cache's keys, the new key written at slot pos % S and no other; then
    timed."""
    import torch

    from repro_torch.configs.registry import get_arch, get_shape
    from repro_torch.launch.specs import make_setup
    from repro_torch.models import attention

    cfg = get_arch(arch)
    setup = make_setup(cfg, get_shape(shape), device=dev, **kw)
    params, token, cache = setup.args
    pos, S = cache["pos"], cache["layers"]["k"].shape[2]
    before = cache["layers"]["k"][0].clone()
    checks = []
    with swapped({(attention, "attend"): captured_attend(checks)}), torch.inference_mode():
        logits, _ = setup.fn(params, token, cache)
    slot = pos % S
    written = torch.nonzero((cache["layers"]["k"][0] != before).flatten(2).any(-1).any(0))
    worst = max(e for e, _ in checks)
    if written.flatten().tolist() != [slot] or len(checks) != cfg.n_layers or \
            {n for _, n in checks} != {S * token.shape[0]} or \
            not torch.isfinite(logits).all() or cache["pos"] != pos + 1:
        raise AssertionError(f"launch {label}: slots written {written.flatten()[:4].tolist()} "
                             f"(want [{slot}]), {len(checks)} attention checks, valid keys "
                             f"{ {n for _, n in checks} }, pos {cache['pos']}")
    print(f"launch {label}: batch {token.shape[0]} (the largest that fits "
          f"{LAUNCH_DECODE_BUDGET / 2**30:.0f} GiB, at most the shape's), one token at pos {pos} "
          f"against {S} cache "
          f"slots (a ring); the key written at slot {slot} alone; each of {cfg.n_layers} "
          f"layers' attention within {FLASH_TOL['bfloat16']} of an fp64 softmax over all {S} "
          f"keys (max abs diff {worst:.3e})", flush=True)
    del before, checks, logits

    def step():
        cache["pos"] = pos      # each timed step decodes the same position
        return setup.fn(params, token, cache)

    res = launch_step(label, step, counts[label])
    res.update(batch=token.shape[0], pos=pos, slots=S, slot=slot, attention_max_abs_err=worst)
    del setup, params, cache
    return res


def launch_train_path(dev, counts: dict) -> dict:
    """(d) train_4k: the hillclimb hymba pair's four configs (baseline,
    banded, remat, one-hot xent), one FedShuffle round of one client x 1 x
    4,096 tokens each, at ``LAUNCH_TRAIN_DEPTH`` where the whole model does
    not fit; each round's loss and params finite, and the params moved."""
    import torch

    from repro_torch.configs.registry import get_shape
    from repro_torch.launch.hillclimb import _resolve
    from repro_torch.launch.specs import make_setup

    res = {}
    for s in launch_shares():
        if not s["label"].startswith("train_4k"):
            continue
        cfg = _resolve(s["arch"], s.get("overrides", {}))
        setup = make_setup(cfg, get_shape("train_4k"), device=dev, **s["kw"])
        state = setup.args[0]
        # this checked round is launch_step's warm-up and gives its peak
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        new, mets = setup.fn(*setup.args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        # a bf16 leaf whose step is under half its ulp (a norm scale at 1.0)
        # stays where it was
        moved = sum(not torch.equal(new.params[k], state.params[k]) for k in state.params)
        if not torch.isfinite(mets["local_loss"]) or not moved or \
                not all(torch.isfinite(v).all() for v in new.params.values()):
            raise AssertionError(f"launch {s['label']}: loss {float(mets['local_loss'])}, "
                                 f"{moved} of {len(state.params)} leaves moved")
        if s["label"] == "train_4k_baseline":       # main path 19's twin
            MESHLESS_TWINS["train_4k_baseline"] = {k: v.cpu() for k, v in new.params.items()}
        del new, mets
        res[s["label"]] = launch_step(s["label"], lambda st=setup: st.fn(*st.args),
                                      counts[s["label"]], grad=True, peak=peak)
        del setup, state
    return res


# the objective inconsistency example's rounds on the card (its default 600):
# every arm the check reads stands at its fixed point from round 200 on (on
# the CPU its distances agree to 6 places at 200, 300 and 600 rounds)
OBJECTIVE_ROUNDS = 200


def launch_examples(dev) -> dict:
    """``examples/torch_objective_inconsistency.py`` (``OBJECTIVE_ROUNDS``) and
    ``examples/torch_serve_moe.py`` on the card, each through its ``main``:
    the paper's claim (FedAvg at its biased point, FedShuffle and FedNova
    and SCAFFOLD at the optimum, as the CPU tests hold them) and the
    reduced DeepSeek-V2-Lite's tokens, sampled and greedy, the greedy ones
    equal to the CPU's at the same weights."""
    import importlib.util

    import torch

    def load(name):
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tasks import DuplicatedQuadraticTask
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    xs = load("torch_objective_inconsistency").main(dev, rounds=OBJECTIVE_ROUNDS)
    task = DuplicatedQuadraticTask(copies=(1, 2, 3))
    dist = {k: (float(np.linalg.norm(x - task.optimum())),
                float(np.linalg.norm(x - task.fedavg_biased_point()))) for k, x in xs.items()}
    if not (dist["fedavg"][1] < 0.03 < dist["fedavg"][0] and dist["fedshuffle"][0] < 0.01
            and dist["fednova"][0] < 0.03 and dist["partial/fedavg+scaffold"][0] < 1e-3):
        raise AssertionError(f"objective inconsistency on the card: |x - x*|, |x - x~| {dist}")
    objective_s = time.perf_counter() - t0
    serve = load("torch_serve_moe")
    sampled = serve.main(dev)
    cfg = get_arch("deepseek-v2-lite-16b").reduced()
    params = build_model(cfg).init(0, "cpu")
    prompts = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (4, 16)))
    cpu = serve.main("cpu", params=params, prompts=prompts, temperature=0.0)
    card = serve.main(dev, params={k: v.to(dev) for k, v in params.items()}, prompts=prompts,
                      temperature=0.0)
    if sampled.shape != (4, 16) or int(sampled.max()) >= cfg.vocab or \
            not torch.equal(card.cpu(), cpu):
        raise AssertionError("serve_moe on the card: bad sampled tokens, or greedy tokens "
                             "other than the CPU's")
    print(f"examples on the card: objective inconsistency {objective_s:.1f} s, |x - x*| / "
          f"|x - x~| {dist}; serve_moe greedy tokens equal to the CPU's", flush=True)
    return {"objective_dist": dist, "objective_s": objective_s}


def launch_paths(dev, rows: list, counts_proc) -> dict:
    """Main path 18: the launch tools (``launch/specs.py`` setups, their
    ``launch/dryrun.py`` counts, made by ``counts_proc`` meanwhile) with
    Hymba-1.5B at full width, bf16, on the ``kernel`` backend, at one card's
    share of each assigned shape: (a) prefill_32k, (b) decode_32k, (c)
    long_500k natively and Qwen1.5-0.5B's through its ring, (d) train_4k in
    the hillclimb pair's four configs; then two examples.  ``rows`` are the
    kernels line's, rr_perm's first: the flash and SSD rows gain the
    launches of (a), the others none."""
    import torch

    t0 = time.perf_counter()
    counts = read_launch_counts(counts_proc, LAUNCH_COUNTS_DIR)
    print(f"launch counts (meta device, a child process): waited "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    wrappers = kernel_wrappers()
    zero_counts(*wrappers)
    res = {"prefill_32k": launch_prefill_path(dev, counts)}
    launched = [w.launches for w in wrappers]
    torch.cuda.empty_cache()
    for s in launch_shares():
        if s["shape"] in ("decode_32k", "long_500k"):
            res[s["label"]] = launch_decode_path(dev, s["label"], s["arch"], s["shape"], s["kw"],
                                                 counts)
            torch.cuda.empty_cache()
    res.update(launch_train_path(dev, counts))
    torch.cuda.empty_cache()
    res["examples"] = launch_examples(dev)
    L = res["prefill_32k"]["launches"]
    if [w.launches for w in wrappers] != launched:
        raise AssertionError("launch paths: a kernel launched outside the prefill")
    for row, n in zip(rows, launched):
        row["launches_path_18"] = n
    for row, name in ((rows[4], "flash_attention"), (rows[5], "ssd_intra_chunk")):
        row["path_18_T32768"] = {"launches": L[name],
                                 "max_abs_err": res["prefill_32k"]["layer_max_abs_err"][name],
                                 **res["prefill_32k"]["T32768"][name]}
    res["seconds"] = time.perf_counter() - t0
    print(f"launch paths: launches of the port's kernels "
          f"{ {w.__name__: w.launches for w in wrappers} }; {res['seconds']:.1f} s", flush=True)
    return res


def timed_twice(run, ctx) -> tuple[float, float]:
    """(wall ms, device ms) of ``run()`` under the context ``ctx()``, which
    has run once already (the warm-up): once timed on the host's clock,
    once traced (its device kernels' time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step():
        with ctx():
            out = run()
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    out = step()
    wall = (time.perf_counter() - t0) * 1e3
    del out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = step()
    del out
    return wall, count_device(prof)[1]


def mesh_paths(dev, rows: list, launch_res: dict) -> dict:
    """Main path 19: the mesh layer (``dist/sharding.py``, ``launch/mesh.py``,
    ``launch/specs.py`` with ``mesh=``) on the card: a single-rank NCCL
    group over a ``HashStore`` (no socket), ``make_host_mesh(1, 1)``, and
    path 18's steps laid out on it as DTensors: (a) Hymba-1.5B's
    prefill_32k at batch 1, bf16, full width, its 32 flash and 32 SSD
    launches through ``local_map`` on the local shards, logits and cache
    bitwise equal to path 18 (a)'s; (b) the train_4k baseline (one client x
    1 x 4,096, 16 of 32 layers), its round's new params bitwise equal to
    path 18 (d)'s.  Each step's wall and device time beside path 18's: what
    DTensor's dispatch costs the host.  ``rows``: the flash and SSD rows
    gain (a)'s launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch, get_shape
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_kernel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import make_setup

    t0 = time.perf_counter()
    card = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=card)
    try:
        mesh = make_host_mesh(1, 1)
        cfg = get_arch(LAUNCH_ARCH)
        res = {"mesh": str(mesh)}

        # (a) the prefill: counts to 0 just before, read just after
        # no_grad, not inference_mode: DTensor makes views of its inputs,
        # which an inference-mode step may not version
        setup = make_setup(cfg, get_shape("prefill_32k"), mesh=mesh, device=dev, batch=1)
        wrappers = kernel_wrappers()
        zero_counts(*wrappers)
        with torch.no_grad():
            logits, cache = setup.fn(*setup.args)
        torch.cuda.synchronize()
        launched = [w.launches for w in wrappers]
        (nf, flash_routes, _), (ns, ssd_routes, _) = read_counts(flash_attention_kernel,
                                                                 ssd_intra_chunk_kernel)
        L = cfg.n_layers
        if (nf, ns) != (L, L) or flash_routes["mma"] != L or ssd_routes["mma"] != L or \
                sum(launched) != 2 * L:
            raise AssertionError(f"mesh prefill_32k launches: flash {nf} {flash_routes}, ssd "
                                 f"{ns} {ssd_routes}, all {launched}")
        twin_logits, twin_cache = MESHLESS_TWINS.pop("prefill_32k")
        got = {"logits": logits.full_tensor(),
               **{k: v.full_tensor() for k, v in cache["layers"].items()}}
        want = {"logits": twin_logits, **twin_cache["layers"]}
        differ = [k for k in want if got[k].shape != want[k].shape or
                  not torch.equal(got[k], want[k])]
        if differ or set(got) != set(want) or cache["pos"] != twin_cache["pos"]:
            raise AssertionError(f"mesh prefill_32k: {differ} differ from path 18 (a)'s")
        cache_keys = sorted(twin_cache["layers"])
        del logits, cache, got, want, twin_logits, twin_cache
        wall, device = timed_twice(lambda: setup.fn(*setup.args), torch.no_grad)
        a18 = launch_res["prefill_32k"]
        res["prefill_32k"] = {"launches": {"flash_attention": nf, "ssd_intra_chunk": ns},
                              "wall_ms": wall, "device_ms": device,
                              "path_18_wall_ms": a18["wall_ms"],
                              "path_18_device_ms": a18["device_ms"]}
        print(f"mesh prefill_32k on {mesh}: {nf} flash_attention and {ns} ssd_intra_chunk "
              f"launches (mma) through local_map; logits and the cache's {len(cache_keys)} "
              f"entries bitwise equal to path 18 (a)'s; wall {wall:.2f} ms, device "
              f"{device:.2f} ms (path 18: {a18['wall_ms']:.2f}, {a18['device_ms']:.2f})",
              flush=True)
        for row, n in zip(rows, launched):
            row["launches_path_19"] = n
        del setup
        torch.cuda.empty_cache()

        # (b) the train_4k baseline round
        setup = make_setup(cfg, get_shape("train_4k"), mesh=mesh, device=dev, batch=1,
                           n_layers=LAUNCH_TRAIN_DEPTH["baseline"])
        zero_counts(*wrappers)
        new, mets = setup.fn(*setup.args)
        torch.cuda.synchronize()
        if any(w.launches for w in wrappers):
            raise AssertionError("mesh train_4k: a kernel launched in the train round")
        twin = MESHLESS_TWINS.pop("train_4k_baseline")
        differ = [k for k in twin if not torch.equal(new.params[k].full_tensor().cpu(), twin[k])]
        if differ or set(twin) != set(new.params):
            raise AssertionError(f"mesh train_4k: the round's params differ from path 18 (d)'s "
                                 f"in {differ[:8]} ({len(differ)} leaves)")
        loss = float(mets["local_loss"].full_tensor() if hasattr(mets["local_loss"],
                                                                  "full_tensor")
                     else mets["local_loss"])
        del new, mets, twin
        wall, device = timed_twice(lambda: setup.fn(*setup.args), contextlib.nullcontext)
        d18 = launch_res["train_4k_baseline"]
        res["train_4k_baseline"] = {"reduced": setup.reduced, "local_loss": loss,
                                    "wall_ms": wall, "device_ms": device,
                                    "path_18_wall_ms": d18["wall_ms"],
                                    "path_18_device_ms": d18["device_ms"]}
        print(f"mesh train_4k baseline on {mesh} ({', '.join(setup.reduced)}): the round's "
              f"params bitwise equal to path 18 (d)'s, loss {loss:.4f}; wall {wall:.2f} ms, "
              f"device {device:.2f} ms (path 18: {d18['wall_ms']:.2f}, "
              f"{d18['device_ms']:.2f})", flush=True)
        del setup
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    print(f"mesh paths: {res['seconds']:.1f} s", flush=True)
    return res


def profile_serve(dev, out_dir: Path) -> None:
    """The serving main path's prefill (4 x 2,048 tokens) and one decode
    step of full-width Hymba-1.5B under torch.profiler, after a warm-up:
    the device's busy share of each one's wall time and the kernel-time
    tables, written to ``out_dir/profile_serve_{prefill,decode}.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import build_model

    cfg = get_arch("hymba-1.5b")
    model = build_model(cfg)
    params = model.init(0, dev)
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    cache_len = SERVE_PROMPT + SERVE_STEPS + 1
    out_dir.mkdir(parents=True, exist_ok=True)
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": prompts}, cache_len)    # warm-up
        tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
        model.decode_step(params, tok, cache)
        phases = {"prefill": lambda: model.prefill(params, {"tokens": prompts}, cache_len),
                  "decode": lambda: model.decode_step(params, tok, cache)}
        for label, fn in phases.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            ka = prof.key_averages()
            dev_events, field = device_events(ka)
            busy_s = sum(getattr(e, field) for e in dev_events) / 1e6
            n = sum(e.count for e in dev_events)
            mine = {k: sum(getattr(e, field) for e in dev_events if k in e.key) / 1e3
                    for k in ("flash_fwd", "ssd_intra_chunk")}
            summary = (f"serve {label}: unprofiled wall {wall * 1e3:.2f} ms; profiled: device "
                       f"time {busy_s * 1e3:.2f} ms = {100 * busy_s / wall:.1f} % of that wall, "
                       f"{n} device kernels/copies ({wall / max(n, 1) * 1e6:.1f} us of wall "
                       f"each); flash_fwd {mine['flash_fwd']:.2f} ms, ssd_intra_chunk "
                       f"{mine['ssd_intra_chunk']:.2f} ms")
            path = out_dir / f"profile_serve_{label}.txt"
            path.write_text(summary + "\n" + ka.table(sort_by=field, row_limit=30) + "\n")
            print(f"profile {summary} -> {path}", flush=True)
    del params, cache
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", type=Path, default=None)
    ap.add_argument("--launch-counts", type=Path, default=None,
                    help="only count main path 18's setups on the meta device into this "
                         "directory (the script runs this in a child process)")
    args = ap.parse_args()
    if args.launch_counts is not None:
        launch_counts(args.launch_counts)
        return 0
    start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # main path 18's counts take a minute of one host core: a child makes
    # them while the other paths run
    counts_proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                    "--launch-counts", str(LAUNCH_COUNTS_DIR)],
                                   env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        return run_paths(args, start, counts_proc)
    finally:
        if counts_proc.poll() is None:
            counts_proc.kill()
            counts_proc.wait()


def run_paths(args, start: float, counts_proc) -> int:
    """Every main path in turn, then the kernels line and the result line."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.quantize.kernel import quantize_pack_kernel, unpack_dequantize_kernel
    from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel
    from repro_torch.kernels.server_update.kernel import server_update_kernel
    from repro_torch.launch.train import charlm_e2e_config

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
    with ThreadPoolExecutor(len(KERNELS)) as pool:     # one nvcc a source, all at once
        list(pool.map(build.load, KERNELS))
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in build.LOGS.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    rr = check_rr_perm(dev)
    rr_latency_bound(rr, charlm_e2e_config()[1].rr_rounds)
    quant, dequant = check_quantize(dev)
    print(f"rr_perm at the main path's {rr['shape']}: {rr['ms']:.5f} ms a launch; an empty "
          f"kernel from the same library: {rr['empty_kernel_ms']:.5f} ms on the device, "
          f"{rr['empty_kernel_call_ms']:.5f} ms a call on the host", flush=True)
    upd = check_server_update(dev)
    flash = check_flash(dev)
    ssd = check_ssd(dev)
    torch.cuda.synchronize()
    print(f"kernel checks and timings: {time.perf_counter() - t0:.2f} s", flush=True)

    # main path 1, a dense wire: counts to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    rr_indices_kernel.launches = 0
    t0 = time.perf_counter()
    res = run_main_path(dev, "device", SEQ_CUT_ROUNDS)
    torch.cuda.synchronize()
    rr["launches"] = rr_indices_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    seq = {"dense": (report_rounds("main path", res, time.perf_counter() - t0, peak,
                                   SEQ_CUT_ROUNDS), peak)}
    if rr["launches"] != SEQ_CUT_ROUNDS:
        raise AssertionError(f"rr_perm launched {rr['launches']} times in {SEQ_CUT_ROUNDS} "
                             f"rounds")
    ref = run_main_path(dev, "device_ref", SEQ_CUT_ROUNDS).state.params
    differ = [k for k in ref if not torch.equal(res.state.params[k], ref[k])]
    if differ:
        raise AssertionError(f"device vs device_ref params differ in {differ}")
    print("main path with the plain rr version (device_ref): parameters bitwise equal",
          flush=True)
    # held against the vmapped and bucketed paths below, on the host: each
    # path's peak device memory is its own
    seq_params = {k: v.cpu() for k, v in res.state.params.items()}
    del res, ref
    t0 = time.perf_counter()
    seq["dense"] += round_kernels(dev)
    print(f"main path: one round {seq['dense'][2]} device kernels and copies, "
          f"{seq['dense'][3]:.1f} ms of device time (traced in {time.perf_counter() - t0:.1f} s)",
          flush=True)

    # main path 2, qsgd both ways: 12 wire leaves a direction, one launch
    # of each quantize kernel a leaf and direction
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rr_indices_kernel, quantize_pack_kernel, unpack_dequantize_kernel)
    t0 = time.perf_counter()
    res = run_main_path(dev, "device", SEQ_ONE_ROUND, **COMM)
    torch.cuda.synchronize()
    quant["launches"] = quantize_pack_kernel.launches
    dequant["launches"] = unpack_dequantize_kernel.launches
    quant["route_launches"] = dict(quantize_pack_kernel.route_launches)
    dequant["route_launches"] = dict(unpack_dequantize_kernel.route_launches)
    comm_rr = rr_indices_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    seq["qsgd"] = (report_rounds("comm path (qsgd up and down)", res, time.perf_counter() - t0,
                                 peak, SEQ_ONE_ROUND), peak)
    want = 2 * len(e2e_wire_leaves()) * SEQ_ONE_ROUND
    if (quant["launches"], dequant["launches"], comm_rr) != (want, want, SEQ_ONE_ROUND):
        raise AssertionError(f"comm path launches: quantize {quant['launches']}, unpack "
                             f"{dequant['launches']} (want {want}), rr_perm {comm_rr}")
    all_warp = {"warp": want, "block": 0}
    if (quant["route_launches"], dequant["route_launches"]) != (all_warp, all_warp):
        raise AssertionError(f"comm path routes: quantize {quant['route_launches']}, unpack "
                             f"{dequant['route_launches']} (want all {want} warp)")
    print(f"comm path launches: quantize_pack {want}, unpack_dequantize {want} (all on the "
          f"warp route), rr_perm {comm_rr} in {SEQ_ONE_ROUND} rounds, as predicted", flush=True)
    check_comm_metrics(res.metrics.rows, charlm_e2e_config(**COMM)[1])
    params = res.state.params
    del res
    torch.cuda.empty_cache()
    ref = run_main_path(dev, "device", SEQ_ONE_ROUND, uplink_backend="ref",
                        **COMM).state.params
    differ = [k for k in ref if not torch.equal(params[k], ref[k])]
    if differ:
        raise AssertionError(f"comm path: kernel vs plain quantize params differ in {differ}")
    print("comm path with the plain quantize version (uplink_backend='ref'): parameters "
          "bitwise equal", flush=True)
    del params, ref
    torch.cuda.empty_cache()

    # main path 3, FedShuffleMVR with the App. F server step: one launch of
    # the server_update kernel a round over all parameter tensors
    torch.cuda.reset_peak_memory_stats()
    rr_indices_kernel.launches = server_update_kernel.launches = 0
    t0 = time.perf_counter()
    res = run_main_path(dev, "device", SEQ_CUT_ROUNDS, **MVR)
    torch.cuda.synchronize()
    upd["launches"] = server_update_kernel.launches
    mvr_rr = rr_indices_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    seq["mvr"] = (report_rounds("mvr path (App. F)", res, time.perf_counter() - t0, peak,
                                SEQ_CUT_ROUNDS), peak)
    if (upd["launches"], mvr_rr) != (SEQ_CUT_ROUNDS, SEQ_CUT_ROUNDS):
        raise AssertionError(f"mvr path launches: server_update {upd['launches']}, rr_perm "
                             f"{mvr_rr} (want {SEQ_CUT_ROUNDS} each)")
    if not all(torch.isfinite(v).all() for v in res.state.opt["m"].values()):
        raise AssertionError("mvr path: non-finite gradient estimate")
    print(f"mvr path launches: server_update {SEQ_CUT_ROUNDS}, rr_perm {mvr_rr} in "
          f"{SEQ_CUT_ROUNDS} rounds, as predicted", flush=True)
    del res
    torch.cuda.empty_cache()

    # main path 4, FedShuffleMVR with the exact eq. 14 step (torch, no kernel)
    torch.cuda.reset_peak_memory_stats()
    rr_indices_kernel.launches = server_update_kernel.launches = 0
    t0 = time.perf_counter()
    res = run_main_path(dev, "device", MVR_EXACT_ROUNDS, mvr_exact=True, **MVR)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    seq["mvr_exact"] = (report_rounds("mvr path (exact eq. 14)", res, time.perf_counter() - t0,
                                      peak, MVR_EXACT_ROUNDS), peak)
    exact_launches = (server_update_kernel.launches, rr_indices_kernel.launches)
    if exact_launches != (0, MVR_EXACT_ROUNDS):
        raise AssertionError(f"exact mvr path launches (server_update, rr_perm): "
                             f"{exact_launches}, want (0, {MVR_EXACT_ROUNDS})")
    if not all(torch.isfinite(v).all() for v in res.state.opt["m"].values()):
        raise AssertionError("exact mvr path: non-finite gradient estimate")
    print(f"exact mvr path launches: server_update 0, rr_perm {MVR_EXACT_ROUNDS}, as predicted",
          flush=True)
    del res
    torch.cuda.empty_cache()

    # main path 6, the four training paths in the vmapped cohort mode
    rows = {"rr_perm": rr, "quantize_pack": quant, "unpack_dequantize": dequant,
            "server_update": upd}
    t0 = time.perf_counter()
    vm_params, vm = vmapped_main_paths(dev, seq, seq_params, rows)
    print(f"vmapped main paths: {time.perf_counter() - t0:.1f} s", flush=True)

    # main path 8, the bucketed layout, held to the padded runs above
    t0 = time.perf_counter()
    bk_params, bk = bucketed_main_paths(dev, seq, seq_params, vm, vm_params, rows)
    del seq_params
    torch.cuda.empty_cache()
    print(f"bucketed main paths: {time.perf_counter() - t0:.1f} s", flush=True)

    # main path 12, FedShuffle + SCAFFOLD at full width in three forms, the
    # other client chains and adam, and SCAFFOLD's claim on the quadratic
    t0 = time.perf_counter()
    scaffold = scaffold_main_paths(dev, rows)
    print(json.dumps({"scaffold": scaffold}), flush=True)
    print(f"scaffold and chain paths: {time.perf_counter() - t0:.1f} s", flush=True)

    # main path 13, the fleet plane (sync faults, the buffered FedBuff
    # server) and the robust plane (attacks, aggregators, guards)
    fleet_robust = fleet_robust_paths(dev, rows)
    print(json.dumps({"fleet_robust": fleet_robust}), flush=True)
    print(f"fleet and robust paths: {fleet_robust['seconds']:.1f} s", flush=True)

    # main path 14, the privacy plane (DP clip and noise, the RDP accountant,
    # pairwise secure aggregation) and the obs plane (spans, the metric
    # registry, in-round histograms)
    privacy_obs = privacy_obs_paths(dev, vm_params, rows)
    print(json.dumps({"privacy_obs": privacy_obs}), flush=True)
    print(f"privacy and obs paths: {privacy_obs['seconds']:.1f} s", flush=True)

    # main path 9, the host side of train(): prefetch, resume through a
    # server-state file, the params file served, a resume with both banks
    t0 = time.perf_counter()
    loop = train_loop_paths(dev, vm_params, vm, bk_params, bk, rows, flash)
    del vm_params, bk_params
    torch.cuda.empty_cache()
    print(json.dumps({"train_loop": loop}), flush=True)
    print(f"train loop paths: {time.perf_counter() - t0:.1f} s", flush=True)

    # main path 5, serving Hymba-1.5B: one flash_attention and one
    # ssd_intra_chunk launch a layer in the prefill, none in decode
    serve = serve_main_path(dev, flash, ssd)
    serve["fp32_max_abs_err"] = check_serve_fp32(dev)
    serve["tiny_card_vs_cpu_err"] = check_serve_tiny(dev)
    print(f"Hymba-tiny served on the card vs the port on the CPU: equal tokens, logits max abs "
          f"diff {serve['tiny_card_vs_cpu_err']:.3e}", flush=True)
    print(json.dumps({"serve": serve}), flush=True)

    # main path 7, serving SeamlessM4T-medium: 12 non-causal encoder, 12
    # causal self-attention and 12 non-causal cross-attention flash launches
    # a prefill, none in decode
    t0 = time.perf_counter()
    audio = serve_audio_path(dev, flash)
    audio["tiny_card_vs_cpu_err"] = check_serve_tiny(dev, "seamless-m4t-medium")
    print(f"SeamlessM4T-tiny served on the card vs the port on the CPU: equal tokens, logits max "
          f"abs diff {audio['tiny_card_vs_cpu_err']:.3e}", flush=True)
    print(json.dumps({"serve_audio": audio}), flush=True)
    print(f"audio serve path: {time.perf_counter() - t0:.1f} s", flush=True)

    # main path 10, the paper's vision task: five methods 30 rounds each
    # (2 flash launches an eval, on simt), then FedShuffle on the cohort
    # engine (one rr_perm launch a round)
    t0 = time.perf_counter()
    vision = vision_path(dev, rr, flash)
    print(json.dumps({"vision": vision}), flush=True)
    print(f"vision path: {time.perf_counter() - t0:.1f} s", flush=True)

    # main path 11, serving LLaVA-NeXT-Mistral-7B: 32 causal flash launches
    # a prefill on mma at hd 128, none in decode
    t0 = time.perf_counter()
    llava = serve_llava_path(dev, flash)
    print(json.dumps({"serve_llava": llava}), flush=True)
    print(f"llava serve path: {time.perf_counter() - t0:.1f} s", flush=True)

    # main path 15, the rest of the zoo: mamba2-1.3b (48 SSD launches a
    # prefill on mma), MiniCPM-2B, ChatGLM3-6B and Qwen2-72B (depth cut; 40,
    # 28 and 20 causal flash launches a prefill on mma), none in decode; the
    # train losses of the ssm, hybrid and audio families on the card
    zoo = zoo_paths(dev, flash, ssd)
    print(json.dumps({"zoo": zoo}), flush=True)
    print(f"zoo paths: {zoo['seconds']:.1f} s", flush=True)

    # main path 16, MLA and the moe family: DeepSeek-V2-Lite-16B and
    # DeepSeek-V3-671B (2 of 61 layers) served, no kernel of the port; their
    # checks; the moe train loss (V3 with MTP) on the card in both modes
    moe_res = moe_paths(dev, [rr, quant, dequant, upd, flash, ssd])
    print(json.dumps({"moe": moe_res}), flush=True)

    # main path 17, remat: the vmapped CharLM-100M round and a sequential
    # client step with and without it, bitwise; Qwen2-72B at full width (4
    # of 80 layers) over 4,096 tokens, peaks and the deepest depth that
    # fits; banded attention and the one-hot cross entropy
    remat_res = remat_paths(dev, [rr, quant, dequant, upd, flash, ssd])
    print(json.dumps({"remat": remat_res}), flush=True)

    # main path 18, the launch tools: Hymba-1.5B at one card's share of the
    # four assigned shapes (32 flash and 32 SSD launches at T = 32,768 in the
    # prefill, none elsewhere), each step's count and bound beside its times;
    # Qwen1.5-0.5B's long context through its ring; two examples
    launch_res = launch_paths(dev, [rr, quant, dequant, upd, flash, ssd], counts_proc)
    print(json.dumps({"launch": launch_res}), flush=True)

    # main path 19, the mesh layer: path 18's prefill_32k (32 flash and 32
    # SSD launches through local_map) and train_4k baseline as DTensors on a
    # one-rank NCCL mesh, bitwise equal to path 18's
    mesh_res = mesh_paths(dev, [rr, quant, dequant, upd, flash, ssd], launch_res)
    print(json.dumps({"mesh": mesh_res}), flush=True)

    for comm in ({}, dict(uplink="ef_qsgd", downlink="qsgd"), MVR,
                 dict(mvr_exact=True, **MVR), VMAPPED, VMAPPED | MVR,
                 dict(mvr_exact=True, **MVR, **VMAPPED)):
        t0 = time.perf_counter()
        worst, flips = check_small_reference(dev, **comm)
        print(f"CharLM-tiny {comm or 'dense'} on the card vs the port on the CPU: max "
              f"relative diff {worst:.3e}, {flips} level flips ({time.perf_counter() - t0:.1f} "
              f"s)", flush=True)
    if args.profile is not None:
        profile_round(dev, args.profile, "vmapped", **VMAPPED)
        for label, comm in (("qsgd", COMM), ("mvr", MVR),
                            ("mvr_exact", dict(mvr_exact=True, **MVR))):
            profile_round(dev, args.profile, label, **comm)
            profile_round(dev, args.profile, f"vmapped_{label}", **comm, **VMAPPED)
        profile_serve(dev, args.profile)

    print(f"chip_smoke: {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": [rr, quant, dequant, upd, flash, ssd]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
