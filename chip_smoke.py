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
   chunks and misaligned rows; flash: ``flash_fwd_mma``, bf16 on the
   tensor cores, or ``flash_fwd``; SSD: ``ssd_intra_chunk_mma``, bf16 on
   the tensor cores at Hymba's and mamba2-1.3b's tiles, or
   ``ssd_intra_chunk``); both quantize routes and both SSD routes are
   timed in turns at a main-path shape, and at the serving shape the
   flash tensor-core kernel is timed beside ``flash_fwd`` on the same
   inputs and ``F.scaled_dot_product_attention`` with the same band mask,
   a yardstick the port never calls;
3. drives five main paths through the user entry point, each with every
   launch count set to 0 just before and read just after: FedShuffle
   training of full-width CharLM-100M (12 x 768, d_ff 3072) for 4 rounds
   through the cohort engine with the CUDA index kernel
   (``rr_backend="device"``), first with a dense wire, then with the qsgd
   codec both ways (``uplink="qsgd", downlink="qsgd"``: the CUDA quantize
   kernels, 12 launches of each a direction a round, all on the ``warp``
   route); then FedShuffleMVR (``server_opt="mvr"``) for 4 rounds with the
   App. F server step (the CUDA server_update kernel, one launch a round
   over all 111 parameter tensors) and for 2 rounds with the exact eq. 14
   step (torch, no kernel); then the same four training paths in the
   vmapped cohort mode (``cohort_mode="vmapped"``, the JAX package's
   default: every client's local steps batched over the cohort), with the
   same launch counts, each path's round wall and peak memory printed
   beside the sequential path's, and the device kernels in a dense round
   in both modes (``--profile`` traces the other paths' rounds);
   then serving full-width Hymba-1.5B (32 x 1600, bf16, random weights from
   seed 0) through ``launch/serve.py:generate``: batch 4, 2,048-token
   prompts, 32 greedy tokens (one flash attention launch a layer in the
   prefill, all on ``flash_fwd_mma``, and one SSD launch, all on
   ``ssd_intra_chunk_mma``; none in decode);
4. checks the results: finite losses and parameters, the predicted launch
   counts, the same runs with the plain versions of the kernels
   (``rr_backend="device_ref"``, ``uplink_backend="ref"``) giving
   bitwise-identical parameters, the comm metrics equal to the wire's
   arithmetic, the vmapped dense parameters within ``VMAPPED_SEQ_RTOL`` of
   the sequential run's, CharLM-tiny runs on the card (dense, ``ef_qsgd`` /
   ``qsgd``, mvr App. F and exact, each sequential and vmapped, and dense
   vmapped) agreeing with the port on the CPU;
   for serving, finite logits, each layer's flash and SSD launch against
   its plain version on the path's own inputs (flash within one bf16 step),
   the bf16 run no further from the plain versions in fp32 than 1.5x the
   plain bf16 run, a planted one-tile window fault failing both checks, the
   fp32 prefill elementwise at full width, a full-width fp32 prefill ->
   decode consistency check, and Hymba-tiny served on the card agreeing
   with the port on the CPU;
5. prints one ``{"kernels": [...]}`` JSON line and, last, the result line.

Any failed check raises, so the script exits non-zero and prints no result.
With ``--profile DIR`` it also traces one more round of the vmapped dense
main path and of the qsgd and the two mvr main paths in both modes, and one
prefill and one decode step of the serving path, with ``torch.profiler``
and writes the kernel-time tables to ``DIR``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ROUNDS = 4
MVR_EXACT_ROUNDS = 2
KERNELS = ("rr_perm", "quantize", "server_update", "flash_attention", "ssd")
# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 3.35 TB/s;
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz = 16.7e12 integer ops/s; the
# 67 TFLOP/s fp32 rate counts an FMA as two, so 33.4e12 fp32 instructions/s,
# which is also the most instructions of any mix the SMs issue (4 schedulers
# x 32 lanes a clock).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
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
                    (int_ops + fp_ops) * values / ISSUE_OPS_PER_S) * 1e3
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
    values, a tensor misaligned for 16-byte loads); then the kernel's one
    launch over the f32 leaf set timed behind a GPU sleep and the plain
    version as it runs."""
    import torch

    from repro_torch.kernels.server_update.kernel import server_update_kernel
    from repro_torch.kernels.server_update.ref import server_update_torch

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
    eta_l = torch.tensor(0.05, device=dev)
    invs = {"1/(0.05*1.0)": torch.reciprocal(eta_l * torch.tensor(1.0, device=dev)),
            "1/(0.05*3.7)": torch.reciprocal(eta_l * torch.tensor(3.7, device=dev))}
    checked, max_err = 0, 0.0
    for label, inv in invs.items():
        for dtype in (torch.float32, torch.bfloat16):
            for x_set, d_set, m_set in ((xs, ds, ms), (ragged, r_ds, r_ms)):
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
          f"on the card (the {len(xs)}-tensor e2e leaf set and a ragged table; f32 and bf16 "
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
    t_ops = SERVER_UPDATE_OPS * n_values / ISSUE_OPS_PER_S * 1e3
    return {"name": "server_update", "route": "cuda",
            "source": "src/repro_torch/csrc/server_update.cu",
            "replaces": "src/repro/kernels/server_update/kernel.py:38",
            "launches": None, "max_abs_err": max_err, "ms": ms_, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": None, "library_note": "no single PyTorch call computes it",
            "call_ms": call_ms, "plain_call_ms": plain_call_ms, "tensors": len(xs),
            "values": n_values, "gbytes": nbytes / 1e9}


def run_main_path(dev, rr_backend: str, rounds: int = ROUNDS, server_opt: str = "sgd", **kw):
    from repro_torch.launch.train import run_charlm_e2e

    return run_charlm_e2e(rounds, "fedshuffle", server_opt, device=dev, engine="cohort",
                          rr_backend=rr_backend, prefetch=0, **kw)


def report_rounds(label: str, res, wall: float, peak: int, rounds: int = ROUNDS) -> float:
    """Print a main-path run's rounds and fail on non-finite losses or
    parameters; returns the mean wall time (ms) of the rounds after the
    first."""
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
    scale / L), and such flips must stay under 0.1 % of the elements."""
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
# SSD intra-chunk: the JAX test's atol 3e-5 / rtol 3e-4 (fp32 throughout)
SSD_ATOL, SSD_RTOL = 3e-5, 3e-4
# the serving main path: Hymba-1.5B at full width, batch 4, 2,048-token
# prompts (past the 1,024 window, 16 SSD chunks), 32 greedy tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 32
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


def band_pairs(T: int, window: int) -> int:
    """Unmasked (query, key) pairs of causal attention over T positions with
    a sliding window (0: none)."""
    w = np.minimum(np.arange(T) + 1, window or T)
    return int(w.sum())


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
    at the main path's bf16 shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel, route
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
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    band = (lambda d: (d >= 0) & (d < W))(torch.arange(T, device=dev)[:, None]
                                          - torch.arange(T, device=dev)[None, :])

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)

    _allclose(sdpa().transpose(1, 2), flash_attend(q, k, v, window=W, backend="ref"),
              FLASH_TOL["bfloat16"], FLASH_TOL["bfloat16"], "SDPA yardstick")
    if route(qt, kt, vt) != "mma":
        raise AssertionError("flash: the main path's bf16 shape did not route to mma")
    ms, call_ms = time_ms(lambda: flash_attention_kernel(qt, kt, vt, window=W), 20)
    simt_ms, _ = time_ms(lambda: flash_attention_kernel(qt, kt, vt, window=W, kernel="simt"), 20)
    plain_ms, plain_call_ms = time_ms(lambda: flash_attend(q, k, v, window=W, backend="ref"), 3,
                                      behind_sleep=False)
    lib_ms, _ = time_ms(sdpa, 20)
    pairs = band_pairs(T, W) * B * H
    flops = 4 * hd * pairs                       # q.k and p.v: 2 hd multiply-adds a pair
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    print(f"flash_attention at bf16 {[B, T, H, KV, hd]}, window {W}: flash_fwd_mma {ms:.4f} ms, "
          f"flash_fwd {simt_ms:.4f} ms, SDPA {lib_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{max(t_ops, t_bytes):.4f} ms", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
            "kernel_route": "mma", "design": "flash_fwd_mma: FA2-style mma.sync m16n8k16 bf16, "
            "4 warps x 16 query rows, 64-key K/V tiles double-buffered by cp.async, online "
            "softmax in registers, P = P_hi + P_lo in two P.V products",
            "simt_ms": simt_ms,
            "launches": None, "max_abs_err": max(err.values()), "max_abs_err_f32": err["float32"],
            "max_abs_err_bf16": err["bfloat16"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": lib_ms, "library": "F.scaled_dot_product_attention(attn_mask=band, "
            "enable_gqa=True)", "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "shape": [B, T, H, KV, hd], "window": W, "dtype": "bfloat16", "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6}


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


def serve_main_path(dev, flash_row: dict, ssd_row: dict) -> dict:
    """Full-width Hymba-1.5B (bf16, random weights from seed 0) serves batch
    4 x 2,048-token prompts (numpy seed 1) for 32 greedy tokens through
    ``generate``, the launch counts zeroed just before and read after the
    prefill and at the end; then the checks of the serving path: finite
    logits, and the run's prefill logits, caches and decode logits no
    further from the plain versions in fp32 than ``SERVE_ANCHOR_RATIO``
    times the plain versions' own bf16 run (a planted fault must fail it)."""
    import dataclasses

    import torch

    import repro_torch.kernels.flash_attention.ops as fops
    import repro_torch.kernels.ssd.ops as sops
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_kernel
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_torch
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model

    cfg = get_arch("hymba-1.5b")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, dev)
    n_params = sum(v.numel() for v in params.values())
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    cache_len = SERVE_PROMPT + SERVE_STEPS + 1
    generate(model, params, prompts, steps=2, cache_len=cache_len)      # warm-up
    seen, marks = [], {}

    def on_logits(i, lg):
        seen.append(lg.float().clone())
        if i == 0:
            torch.cuda.synchronize()
            marks["t"] = time.perf_counter()
            marks["launches"] = (flash_attention_kernel.launches, ssd_intra_chunk_kernel.launches)
            marks["routes"] = dict(flash_attention_kernel.route_launches)
            marks["ssd_routes"] = dict(ssd_intra_chunk_kernel.route_launches)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = ssd_intra_chunk_kernel.launches = 0
    flash_attention_kernel.route_launches = dict.fromkeys(flash_attention_kernel.route_launches, 0)
    ssd_intra_chunk_kernel.route_launches = dict.fromkeys(ssd_intra_chunk_kernel.route_launches, 0)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, steps=SERVE_STEPS, cache_len=cache_len,
                   on_logits=on_logits)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    total = (flash_attention_kernel.launches, ssd_intra_chunk_kernel.launches)
    prefill = marks["launches"]
    decode = (total[0] - prefill[0], total[1] - prefill[1])
    flash_row["launches"], ssd_row["launches"] = total
    routes, ssd_routes = marks["routes"], marks["ssd_routes"]
    ssd_row["route_launches"] = dict(ssd_intra_chunk_kernel.route_launches)
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = (marks["t"] - t0) * 1e3
    decode_ms = (t1 - marks["t"]) * 1e3 / (SERVE_STEPS - 1)
    res = {"arch": cfg.name, "params": n_params, "dtype": cfg.dtype, "batch": SERVE_BATCH,
           "prompt": SERVE_PROMPT, "steps": SERVE_STEPS, "prefill_ms": prefill_ms,
           "decode_ms_per_step": decode_ms, "decode_tok_per_s": SERVE_BATCH * 1e3 / decode_ms,
           "e2e_tok_per_s": SERVE_BATCH * SERVE_STEPS / (t1 - t0), "peak_gib": peak / 2**30,
           "prefill_launches": {"flash_attention": prefill[0], "ssd_intra_chunk": prefill[1],
                                "flash_attention_by_route": routes,
                                "ssd_intra_chunk_by_route": ssd_routes},
           "decode_launches": {"flash_attention": decode[0], "ssd_intra_chunk": decode[1]}}
    print(f"serve path: {cfg.name} {n_params} params ({cfg.dtype}), batch {SERVE_BATCH} x "
          f"{SERVE_PROMPT}-token prompts, {SERVE_STEPS} greedy tokens: prefill "
          f"{prefill_ms:.2f} ms, decode {decode_ms:.2f} ms a step ({res['decode_tok_per_s']:.1f} "
          f"tokens/s), {res['e2e_tok_per_s']:.1f} tokens/s end to end, peak device memory "
          f"{peak / 2**30:.3f} GiB; launches in the prefill: flash_attention {prefill[0]} "
          f"({routes}), ssd_intra_chunk {prefill[1]} ({ssd_routes}); in decode: {decode[0]}, "
          f"{decode[1]}",
          flush=True)
    if prefill != (cfg.n_layers, cfg.n_layers) or decode != (0, 0):
        raise AssertionError(f"serve launches: prefill {prefill}, decode {decode}, want "
                             f"({cfg.n_layers}, {cfg.n_layers}) and (0, 0)")
    if routes != {"mma": cfg.n_layers, "simt": 0} or ssd_routes != routes:
        raise AssertionError(f"serve: the prefill's flash launches took {routes} and its SSD "
                             f"launches {ssd_routes}, want all {cfg.n_layers} of each on mma")
    if len(seen) != SERVE_STEPS or not all(torch.isfinite(x).all() for x in seen):
        raise AssertionError("serve path: non-finite logits")
    if out.shape != (SERVE_BATCH, SERVE_STEPS) or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"serve path: bad tokens {tuple(out.shape)}")

    # the twin runs, each teacher-forced with the kernel run's tokens: the
    # plain versions in bf16, and the anchor, the plain versions in fp32 on
    # the same (bf16-valued) weights
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
    layer_err = {"flash_attention": 0.0, "ssd_intra_chunk": 0.0}
    last = {}

    def flash_checked(q, k, v, *, window):
        got = flash_attention_kernel(q, k, v, window=window)
        want = flash_attention_torch(q, k, v, window=window)
        layer_err["flash_attention"] = max(layer_err["flash_attention"], _allclose(
            got, want, FLASH_MAIN_BF16_ATOL, FLASH_MAIN_BF16_RTOL, "flash on the path's inputs"))
        last["flash"] = (q, k, v, window, want)
        return got

    def ssd_checked(*args):
        out = ssd_intra_chunk_kernel(*args)
        for got, want in zip(out, ssd_intra_chunk_torch(*args)):
            layer_err["ssd_intra_chunk"] = max(layer_err["ssd_intra_chunk"], _allclose(
                got, want, SSD_ATOL, SSD_RTOL, "ssd on the path's inputs"))
        return out

    with torch.inference_mode():
        fops.flash_attention_kernel, sops.ssd_intra_chunk_kernel = flash_checked, ssd_checked
        try:
            kernel = twin(model, params, decode=False)
        finally:
            fops.flash_attention_kernel = flash_attention_kernel
            sops.ssd_intra_chunk_kernel = ssd_intra_chunk_kernel
        # the planted fault: the last layer's attention with the window one
        # key tile (64) short must leave the bound
        q, k, v, window, want = last.pop("flash")
        q_numel = q.numel()
        d = (flash_attention_kernel(q, k, v, window=window - 64).float() - want.float()).abs()
        fault_off = int((d > FLASH_MAIN_BF16_ATOL + FLASH_MAIN_BF16_RTOL * want.float().abs()).sum())
        fault_diff = float(d.max())
        del q, k, v, want, d
        kernel["logits"], kernel["decode_logits"] = seen[0], torch.stack(seen[1:])
        ref = twin(build_model(cfg, backend="ref"), params)
        anchor = twin(build_model(dataclasses.replace(cfg, dtype="float32"), backend="ref"),
                      {k: v.float() for k, v in params.items()})
        # the planted fault: the window one key tile (64) short
        fault_cfg = dataclasses.replace(cfg, sliding_window=cfg.sliding_window - 64)
        fault = twin(build_model(fault_cfg), params, decode=False)["logits"]
    res["layer_max_abs_err"] = layer_err
    res["layer_fault"] = {"elements_off": fault_off, "max_abs_diff": fault_diff}
    print(f"serve path's kernel inputs, {cfg.n_layers} layers: flash_attention within "
          f"{FLASH_MAIN_BF16_ATOL} + 2^-7 |ref| of its plain version (max abs diff "
          f"{layer_err['flash_attention']:.3e}), ssd_intra_chunk within atol {SSD_ATOL} / rtol "
          f"{SSD_RTOL} (max abs diff {layer_err['ssd_intra_chunk']:.3e}); the window one tile "
          f"short: {fault_off} of {q_numel} elements off, max abs diff {fault_diff:.3e}",
          flush=True)
    if fault_off == 0:
        raise AssertionError("serve: the layer check passed a window one tile short")
    errs = {n: (_rel_norm(kernel[n], anchor[n]), _rel_norm(ref[n], anchor[n])) for n in anchor}
    errs["fault_logits"] = (_rel_norm(fault, anchor["logits"]), errs["logits"][1])
    res["vs_fp32_rel_err"] = {n: {"kernel": k, "ref": r, "ratio": k / r} for n, (k, r) in
                              errs.items()}
    print(f"serve bf16 vs the plain versions in fp32, relative error of the norm, kernel run / "
          f"plain run (bound {SERVE_ANCHOR_RATIO}x): " + ", ".join(
              f"{n} {k:.3e} / {r:.3e} = {k / r:.3f}x" for n, (k, r) in errs.items()), flush=True)
    off = [n for n, (k, r) in errs.items() if n != "fault_logits" and k > SERVE_ANCHOR_RATIO * r]
    if off:
        raise AssertionError(f"serve bf16: the kernel run strays more than "
                             f"{SERVE_ANCHOR_RATIO}x as far from fp32 as the plain run in {off}")
    k, r = errs["fault_logits"]
    if k <= SERVE_ANCHOR_RATIO * r:
        raise AssertionError(f"serve bf16: the check passed a window one tile short "
                             f"({k / r:.3f}x)")
    del params, seen, kernel, ref, anchor
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


def check_serve_tiny(dev) -> float:
    """Hymba-tiny (the reduced config: 2 layers, window 64, SSD chunk 32,
    fp32) serves the same prompts on the card (the kernels) and on the CPU
    (the plain versions): equal greedy tokens, logits within 2e-4 + 2e-3 |cpu|."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model

    cfg = get_arch("hymba-1.5b").reduced()
    model = build_model(cfg)
    params = model.init(0, "cpu")
    prompts = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (2, 100)))
    out, logits = {}, {}
    for d in ("cpu", dev):
        seen = []
        out[str(d)] = generate(model, {k: v.to(d) for k, v in params.items()}, prompts.to(d),
                               steps=8, cache_len=110,
                               on_logits=lambda i, lg, seen=seen: seen.append(lg.cpu()))
        logits[str(d)] = torch.stack(seen)
    if not torch.equal(out["cpu"], out[str(dev)].cpu()):
        raise AssertionError("Hymba-tiny: card and CPU tokens differ")
    return _allclose(logits[str(dev)], logits["cpu"], 2e-4, 2e-3, "Hymba-tiny card vs CPU")


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


def vmapped_main_paths(dev, seq: dict, seq_params: dict, rows: dict) -> None:
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
    round, their device ms; the last two for the dense path alone))."""
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
    for label, kw, rounds, want in paths:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels.values():
            kern.launches = 0
            if hasattr(kern, "route_launches"):
                kern.route_launches = dict.fromkeys(kern.route_launches, 0)
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
        del res
        if label == "dense":
            worst = max(float((params[k] - v).abs().max() / v.abs().max())
                        for k, v in seq_params.items())
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
        del params
        s_wall, s_peak, *s_kernels = seq[label]
        traced = ""
        if label == "dense":
            t0 = time.perf_counter()
            n, busy_ms = round_kernels(dev, **kw, **VMAPPED)
            traced = (f"; device kernels and copies in a round {n} vs {s_kernels[0]}, their "
                      f"device time {busy_ms:.1f} vs {s_kernels[1]:.1f} ms (traced in "
                      f"{time.perf_counter() - t0:.1f} s)")
        print(f"vmapped vs sequential, {label}: round wall {wall:.1f} vs {s_wall:.1f} ms "
              f"({s_wall / wall:.2f}x); peak {peak / 2**30:.3f} vs {s_peak / 2**30:.3f} "
              f"GiB{traced}", flush=True)
    torch.cuda.empty_cache()


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
    args = ap.parse_args()
    start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
    res = run_main_path(dev, "device")
    torch.cuda.synchronize()
    rr["launches"] = rr_indices_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    seq = {"dense": (report_rounds("main path", res, time.perf_counter() - t0, peak), peak)}
    if rr["launches"] != ROUNDS:
        raise AssertionError(f"rr_perm launched {rr['launches']} times in {ROUNDS} rounds")
    ref = run_main_path(dev, "device_ref").state.params
    differ = [k for k in ref if not torch.equal(res.state.params[k], ref[k])]
    if differ:
        raise AssertionError(f"device vs device_ref params differ in {differ}")
    print("main path with the plain rr version (device_ref): parameters bitwise equal",
          flush=True)
    seq_params = res.state.params     # held against the vmapped dense path below
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
    rr_indices_kernel.launches = 0
    quantize_pack_kernel.launches = unpack_dequantize_kernel.launches = 0
    for kern in (quantize_pack_kernel, unpack_dequantize_kernel):
        kern.route_launches = dict.fromkeys(kern.route_launches, 0)
    t0 = time.perf_counter()
    res = run_main_path(dev, "device", **COMM)
    torch.cuda.synchronize()
    quant["launches"] = quantize_pack_kernel.launches
    dequant["launches"] = unpack_dequantize_kernel.launches
    quant["route_launches"] = dict(quantize_pack_kernel.route_launches)
    dequant["route_launches"] = dict(unpack_dequantize_kernel.route_launches)
    comm_rr = rr_indices_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    seq["qsgd"] = (report_rounds("comm path (qsgd up and down)", res, time.perf_counter() - t0,
                                 peak), peak)
    want = 2 * len(e2e_wire_leaves()) * ROUNDS
    if (quant["launches"], dequant["launches"], comm_rr) != (want, want, ROUNDS):
        raise AssertionError(f"comm path launches: quantize {quant['launches']}, unpack "
                             f"{dequant['launches']} (want {want}), rr_perm {comm_rr}")
    all_warp = {"warp": want, "block": 0}
    if (quant["route_launches"], dequant["route_launches"]) != (all_warp, all_warp):
        raise AssertionError(f"comm path routes: quantize {quant['route_launches']}, unpack "
                             f"{dequant['route_launches']} (want all {want} warp)")
    print(f"comm path launches: quantize_pack {want}, unpack_dequantize {want} (all on the "
          f"warp route), rr_perm {comm_rr} in {ROUNDS} rounds, as predicted", flush=True)
    check_comm_metrics(res.metrics.rows, charlm_e2e_config(**COMM)[1])
    params = res.state.params
    del res
    torch.cuda.empty_cache()
    ref = run_main_path(dev, "device", uplink_backend="ref", **COMM).state.params
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
    res = run_main_path(dev, "device", **MVR)
    torch.cuda.synchronize()
    upd["launches"] = server_update_kernel.launches
    mvr_rr = rr_indices_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    seq["mvr"] = (report_rounds("mvr path (App. F)", res, time.perf_counter() - t0, peak),
                  peak)
    if (upd["launches"], mvr_rr) != (ROUNDS, ROUNDS):
        raise AssertionError(f"mvr path launches: server_update {upd['launches']}, rr_perm "
                             f"{mvr_rr} (want {ROUNDS} each)")
    if not all(torch.isfinite(v).all() for v in res.state.opt["m"].values()):
        raise AssertionError("mvr path: non-finite gradient estimate")
    print(f"mvr path launches: server_update {ROUNDS}, rr_perm {mvr_rr} in {ROUNDS} rounds, "
          f"as predicted", flush=True)
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
    t0 = time.perf_counter()
    vmapped_main_paths(dev, seq, seq_params,
                       {"rr_perm": rr, "quantize_pack": quant, "unpack_dequantize": dequant,
                        "server_update": upd})
    del seq_params
    print(f"vmapped main paths: {time.perf_counter() - t0:.1f} s", flush=True)

    # main path 5, serving Hymba-1.5B: one flash_attention and one
    # ssd_intra_chunk launch a layer in the prefill, none in decode
    serve = serve_main_path(dev, flash, ssd)
    serve["fp32_max_abs_err"] = check_serve_fp32(dev)
    serve["tiny_card_vs_cpu_err"] = check_serve_tiny(dev)
    print(f"Hymba-tiny served on the card vs the port on the CPU: equal tokens, logits max abs "
          f"diff {serve['tiny_card_vs_cpu_err']:.3e}", flush=True)
    print(json.dumps({"serve": serve}), flush=True)

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
