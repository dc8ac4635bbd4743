"""Per-(arch x input-shape) setups: a step fn and its inputs (the port of
``repro.launch.specs``).  ``dryrun.py`` counts these on the meta device;
``chip_smoke.py`` runs them on the card.

The assigned input shapes map onto the FL system as in the JAX package:

* ``train_4k``    -> one federated ROUND (``build_round_step``): the cohort
  covers the global batch.  vmapped mode: C = ``dp`` clients at once, each
  with a local batch of global_batch / C; sequential mode (the archs of
  ``SEQUENTIAL_ARCHS``): C = 4 clients one after another, each with a local
  batch of global_batch / 4.  K = 1 local step.
* ``prefill_32k`` -> ``Model.prefill`` of the global model.
* ``decode_32k``  -> ``Model.decode_step``: ONE token against a 32k cache.
* ``long_500k``   -> ``Model.decode_step`` with a 524,288-token context; the
  quadratic (dense, vlm, moe, audio) archs serve it through the ring cache
  of ``cfg.serve_window_long`` slots, the ssm and hybrid archs natively.

The inputs are tensors on ``device``: on ``"meta"`` they have the shapes and
dtypes alone and nothing is allocated (the JAX package's ``jax.eval_shape``);
elsewhere the weights are random from ``seed`` and the tokens from a
``torch.Generator`` seeded with ``seed + 1``, and a decode cache is random
and full, at ``pos`` = seq_len - 1.

One card's share.  Without a mesh, ``dp`` stands for the client count the
JAX package takes from its mesh's data axes (``launch/mesh.py:dp_size``;
the dry run passes the production mesh's 16, or 32 with two pods).  ``batch`` (the local
batch of a train setup, the global batch of a serving one) and
``n_layers`` cut a setup to what a card holds; every cut from the assigned
shape and the config is listed in ``Setup.reduced``.  One card has nothing
to shard: ``in_shardings`` is None, and a lever that acts on a mesh alone
(the prefill's ``seq_over_model``, the config's ``opt_seq_shard``) is kept
in ``Setup.inert``, where it changes nothing.

On a mesh (``mesh=``, a ``DeviceMesh`` of ``launch/mesh.py``) a setup is
the JAX package's layout: the vmapped mode runs C = ``dp_size(mesh)``
clients, the sequential one 4 with FSDP over the data axes
(``fsdp_override="auto"``); the params, the optimizer state, the batch, the
cohort's meta and a decode cache are DTensors under ``dist/sharding.py``'s
rules, and ``in_shardings`` holds their specs (``dist.sharding.P``) leaf for
leaf in the JAX package's tree.  A cache's ``pos`` stays a plain int.  The
step runs under DTensor's ``implicit_replication``: a tensor the step makes
itself (positions, masks, zeros) is the same on every rank.
``seq_over_model`` shards the prefill's sequence dim over ``"model"``, and
the config's ``opt_seq_shard`` the residual stream between blocks
(``models/model.py``); neither is inert there.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig, FLConfig, ShapeConfig
from ..data.federated import ClientMeta, RoundBatch
from ..dist.sharding import (P, batch_specs, cache_specs, distribute, params_specs,
                             seq_batch_specs, shardings)
from ..fed.losses import make_loss
from ..fed.rounds import build_round_step
from ..fed.strategy import bind_strategy, strategy_for
from ..models.model import build_model
from ..utils.device import resolve_device
from .mesh import dp_axes, dp_size

SEQUENTIAL_ARCHS = {"qwen2-72b", "deepseek-v3-671b"}  # one replica needs the mesh
LONG_CONTEXT = 100_000       # decode contexts above this go through the ring (quadratic archs)
RING_FAMILIES = ("dense", "vlm", "moe", "audio")


@dataclass
class Setup:
    name: str
    fn: Callable
    args: tuple                   # tensors (or trees of them) on the setup's device
    in_shardings: Any = None      # the args' specs on a mesh; one card: nothing to shard
    out_shardings: Any = None
    static_kwargs: dict | None = None
    reduced: list = field(default_factory=list)   # each cut from the shape and the config
    inert: list = field(default_factory=list)     # levers that act on a mesh alone
    cfg: ArchConfig | None = None                 # the config as cut (``n_layers``)
    shape: ShapeConfig | None = None


def _cut(cfg: ArchConfig, n_layers: int | None, reduced: list) -> ArchConfig:
    if n_layers is None or n_layers == cfg.n_layers:
        return cfg
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(f"{cfg.name}: n_layers {n_layers} outside 1..{cfg.n_layers}")
    reduced.append(f"n_layers {n_layers} of {cfg.n_layers}")
    return dataclasses.replace(cfg, n_layers=n_layers)


def _inert(cfg: ArchConfig, mesh=None, **levers) -> list:
    if mesh is not None:
        return []
    out = [k for k, on in levers.items() if on]
    return out + (["opt_seq_shard"] if cfg.opt_seq_shard else [])


def on_mesh(fn: Callable) -> Callable:
    """``fn`` under DTensor's ``implicit_replication``: the plain tensors a
    step makes itself are the same on every rank, so they count as
    replicated beside its DTensor inputs."""
    def run(*args, **kwargs):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return fn(*args, **kwargs)

    return run


def _gen(device: torch.device, seed: int):
    return None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)


def _tokens(shape, vocab: int, device, gen) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=torch.int32, device=device)
    return torch.randint(0, vocab, shape, dtype=torch.int32, device=device, generator=gen)


def _embeds(shape, dtype, device, gen) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, dtype=torch.float32, device=device, generator=gen).to(dtype)


def _meta(C: int, N: int, K: int, B: int, device) -> ClientMeta:
    """The cohort's per-slot scalars: C sampled clients of N, K steps of B."""
    def full(v):
        return torch.full((C,), float(v), dtype=torch.float32, device=device)

    return ClientMeta(weight=full(1.0 / N), prob=full(C / N), num_samples=full(K * B),
                      epochs=full(1), num_steps=full(K), num_steps_planned=full(K),
                      valid=full(1), client_id=torch.arange(C, dtype=torch.int32, device=device),
                      staleness=full(0), arrive_time=full(0), dropped=full(0))


def _train_data(cfg: ArchConfig, C: int, K: int, B: int, seq: int, device, gen) -> dict:
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        s_text = seq - cfg.num_patches
        return {"tokens": _tokens((C, K, B, s_text + 1), cfg.vocab, device, gen),
                "patches": _embeds((C, K, B, cfg.num_patches, cfg.d_model), dt, device, gen)}
    if cfg.family == "audio":
        return {"tokens": _tokens((C, K, B, seq + 1), cfg.vocab, device, gen),
                "frames": _embeds((C, K, B, cfg.src_frames, cfg.d_model), dt, device, gen)}
    return {"tokens": _tokens((C, K, B, seq + 1), cfg.vocab, device, gen)}


def _serve_batch(cfg: ArchConfig, B: int, S: int, device, gen) -> dict:
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        return {"tokens": _tokens((B, S - cfg.num_patches), cfg.vocab, device, gen),
                "patches": _embeds((B, cfg.num_patches, cfg.d_model), dt, device, gen)}
    if cfg.family == "audio":
        return {"tokens": _tokens((B, S), cfg.vocab, device, gen),
                "frames": _embeds((B, cfg.src_frames, cfg.d_model), dt, device, gen)}
    return {"tokens": _tokens((B, S), cfg.vocab, device, gen)}


def _batch(shape: ShapeConfig, batch: int | None, reduced: list) -> int:
    if batch is None:
        return shape.global_batch
    if batch < shape.global_batch:
        reduced.append(f"batch {batch} of {shape.global_batch}")
    return batch


def train_setup(cfg: ArchConfig, shape: ShapeConfig, *, dp: int = 1, batch: int | None = None,
                n_layers: int | None = None, device=None, seed: int = 0, k_steps: int = 1,
                cohort_mode: str | None = None, algorithm: str = "fedshuffle",
                server_opt: str = "sgd", accum_dtype: str = "float32",
                backend: str = "kernel", mesh=None, fsdp_override: str | None = "auto") -> Setup:
    """One FedShuffle round over ``shape``: C clients (``dp``, or the mesh's
    ``dp_size``, in the vmapped mode, 4 in the sequential one), each
    ``k_steps`` local steps of a local batch of global_batch / C (``batch``
    cuts it).  On a mesh, ``fsdp_override`` "auto" shards the sequential
    mode's weights over the data axes too (an axis tuple names them, None
    turns FSDP off)."""
    device = resolve_device(device)
    reduced: list = []
    cfg = _cut(cfg, n_layers, reduced)
    mode = cohort_mode or ("sequential" if cfg.name in SEQUENTIAL_ARCHS else "vmapped")
    C = dp_size(dp if mesh is None else mesh) if mode == "vmapped" else 4
    B = max(1, shape.global_batch // C)
    if batch is not None and batch != B:
        if batch > B:
            raise ValueError(f"batch {batch} over the shape's local batch {B}")
        B = batch
    if C * B < shape.global_batch:
        reduced.append(f"batch {C} x {B} of {shape.global_batch}")
    fl = FLConfig(num_clients=max(64, C), cohort_size=C, sampling="uniform",
                  algorithm=algorithm, local_lr=1e-2, server_lr=1.0, server_opt=server_opt,
                  cohort_mode=mode, local_batch=B, k_max=k_steps, accum_dtype=accum_dtype)
    model = build_model(cfg, backend)
    loss_fn = make_loss(model)
    strategy = bind_strategy(strategy_for(fl), fl, loss_fn, num_clients=fl.num_clients)
    state = strategy.init(model.init(seed, device))
    gen = _gen(device, seed + 1)
    rb = RoundBatch(data=_train_data(cfg, C, k_steps, B, shape.seq_len, device, gen),
                    step_mask=torch.ones((C, k_steps), dtype=torch.float32, device=device),
                    meta=_meta(C, fl.num_clients, k_steps, B, device))
    lr = torch.ones((), dtype=torch.float32, device=device)
    step = build_round_step(loss_fn, strategy, fl, num_clients=fl.num_clients, device=device)
    args, specs = (state, rb, lr), None
    if mesh is not None:
        dpx = dp_axes(mesh)
        fsdp = (dpx if mode == "sequential" else None) if fsdp_override == "auto" \
            else fsdp_override
        p_specs = params_specs(state.params, mesh, fsdp=fsdp)
        meta_spec = P(dpx) if mode == "vmapped" and C % dp_size(mesh) == 0 else P()
        specs = (state._replace(params=p_specs, opt={k: p_specs for k in state.opt}, rnd=P()),
                 RoundBatch(data=(batch_specs(rb.data, mesh, client_axis=dpx) if mode == "vmapped"
                                  else seq_batch_specs(rb.data, mesh, dp_axis=dpx)),
                            step_mask=(batch_specs(rb.step_mask, mesh, client_axis=dpx)
                                       if mode == "vmapped" else P()),
                            meta=ClientMeta(*(meta_spec,) * len(rb.meta))),
                 P())
        args, step = distribute(args, shardings(specs, mesh)), on_mesh(step)
    return Setup(name=f"{cfg.name}/{shape.name}", fn=step, args=args, in_shardings=specs,
                 reduced=reduced, inert=_inert(cfg, mesh), cfg=cfg, shape=shape)


def prefill_setup(cfg: ArchConfig, shape: ShapeConfig, *, batch: int | None = None,
                  n_layers: int | None = None, device=None, seed: int = 0,
                  seq_over_model: bool = False, backend: str = "kernel", mesh=None) -> Setup:
    """``Model.prefill`` over ``batch`` (the shape's global batch unless
    cut) prompts of seq_len positions, a vlm model's patches among them.
    On a mesh the prompts' batch dim goes over the data axes, and with
    ``seq_over_model`` their sequence dim over ``"model"``."""
    device = resolve_device(device)
    reduced: list = []
    cfg = _cut(cfg, n_layers, reduced)
    model = build_model(cfg, backend)
    B, S = _batch(shape, batch, reduced), shape.seq_len
    params = model.init(seed, device)
    data = _serve_batch(cfg, B, S, device, _gen(device, seed + 1))
    fn, args, specs = partial(model.prefill, cache_len=S), (params, data), None
    if mesh is not None:
        dpx, dpn, tp = dp_axes(mesh), dp_size(mesh), mesh.shape[mesh.mesh_dim_names.index("model")]

        def bspec(t):
            spec = [dpx if t.shape[0] % dpn == 0 else None] + [None] * (t.ndim - 1)
            if seq_over_model and t.ndim >= 2 and t.shape[1] % tp == 0:
                spec[1] = "model"       # sequence-sharded inputs (the hillclimb's lever)
            return P(*spec)

        specs = (params_specs(params, mesh), {k: bspec(v) for k, v in data.items()})
        args, fn = distribute(args, shardings(specs, mesh)), on_mesh(fn)
    return Setup(name=f"{cfg.name}/{shape.name}", fn=fn, args=args, in_shardings=specs,
                 reduced=reduced, inert=_inert(cfg, mesh, seq_over_model=seq_over_model),
                 cfg=cfg, shape=shape)


def decode_cache_len(cfg: ArchConfig, seq_len: int) -> tuple[bool, int]:
    """(ring, cache slots) of a decode at context ``seq_len``: the JAX
    package's rule, a ring of ``serve_window_long`` slots for the quadratic
    families above ``LONG_CONTEXT``, else a linear cache of seq_len."""
    ring = seq_len > LONG_CONTEXT and cfg.family in RING_FAMILIES
    return ring, (min(seq_len, cfg.serve_window_long) if ring else seq_len)


def decode_setup(cfg: ArchConfig, shape: ShapeConfig, *, batch: int | None = None,
                 n_layers: int | None = None, device=None, seed: int = 0,
                 backend: str = "kernel", mesh=None, **_ignored) -> Setup:
    """``Model.decode_step``: one token against a cache of seq_len positions
    (a ring of ``serve_window_long`` slots for a quadratic arch at a long
    context), at ``pos`` = seq_len - 1.  On a mesh the token's and the
    cache's batch dim go over the data axes, and at batch 1 the cache's
    sequence (or SSD head) dim over ``"model"``."""
    device = resolve_device(device)
    reduced: list = []
    cfg = _cut(cfg, n_layers, reduced)
    model = build_model(cfg, backend)
    B, S = _batch(shape, batch, reduced), shape.seq_len
    ring, cache_len = decode_cache_len(cfg, S)
    params = model.init(seed, device)
    cache = model.init_cache(B, cache_len, device)
    gen = _gen(device, seed + 1)
    if gen is not None:
        for t in cache["layers"].values():
            t.copy_(torch.randn(t.shape, dtype=torch.float32, device=device, generator=gen))
    cache["pos"] = S - 1
    token = _tokens((B, 1), cfg.vocab, device, gen)
    fn, args, specs = partial(model.decode_step, ring=ring), (params, token, cache), None
    if mesh is not None:
        dpx = dp_axes(mesh)
        specs = (params_specs(params, mesh),
                 P(dpx if B % dp_size(mesh) == 0 else None, None),
                 {"layers": cache_specs(cache["layers"], mesh, dp_axis=dpx, shard_seq=B == 1),
                  "pos": P()})
        args, fn = distribute(args, shardings(specs, mesh)), on_mesh(fn)
    return Setup(name=f"{cfg.name}/{shape.name}", fn=fn, args=args, in_shardings=specs,
                 reduced=reduced, inert=_inert(cfg, mesh), cfg=cfg, shape=shape)


def make_setup(cfg: ArchConfig, shape: ShapeConfig, mesh=None, **kw) -> Setup:
    """The setup of ``cfg`` at ``shape``: one card's share, or with ``mesh``
    the JAX package's layout on it."""
    kw["mesh"] = mesh
    if shape.kind == "train":
        return train_setup(cfg, shape, **kw)
    if shape.kind == "prefill":
        return prefill_setup(cfg, shape, **{k: v for k, v in kw.items() if k != "dp"})
    return decode_setup(cfg, shape, **{k: v for k, v in kw.items() if k != "dp"})
