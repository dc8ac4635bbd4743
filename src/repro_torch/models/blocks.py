"""Transformer blocks: init, the train forward, the prefill and the decode
step, for the dense family, the moe family (MLA attention + a routed MoE
FFN), the ssm (Mamba2: the mixer alone) family, the hybrid (Hymba:
parallel attention + SSD branches) family and the audio encoder-decoder.

A block's parameters are the flat-dict entries under its prefix
(``blocks/{i}/ln1/scale``, ``blocks/{i}/attn/wq``, …, ``blocks/{i}/mlp/down``;
the hybrid block adds ``blocks/{i}/mixer/...`` and ``blocks/{i}/branch_scale``;
an ssm block is ``blocks/{i}/ln1/scale`` and ``blocks/{i}/mixer/...`` alone;
a moe block has MLA's ``attn/wdkv``, ``attn/kv_norm/scale``, … and
``moe/router``, ``moe/experts/{gate,up,down}`` [E, ...], ``moe/shared/...``
in place of ``attn/wq``, … and ``mlp/``;
an encoder block is a dense one under ``enc_blocks/{i}/``; a decoder block
has ``self/``, ``ln_x/`` and ``cross/`` in place of ``attn/``).
A prefill returns the layer's cache entry in the structure its decode step
takes (``{"k", "v"}``, ``{"c_kv", "k_rope"}`` for the moe block,
``{"state", "conv"}`` for the ssm block, both for
the hybrid block, and ``{"k", "v", "xk", "xv"}``, the encoder memory's K/V
added, for the decoder block).  The train forwards (``*_block_forward``)
run under autograd and ``torch.func.vmap`` (the vmapped cohort mode): the
plain attention and the plain SSD scan (``backend="ref"``: the kernels have
no backward pass, and the JAX package's loss runs its plain ``ssd_chunked``
too), no in-place write.  The port's counterpart of
``repro.models.blocks`` for these families.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .attention import (MLA_KEYS, _proj, gqa_decode, gqa_forward, gqa_init, gqa_prefill,
                        mla_decode, mla_forward, mla_init)
from .layers import dense_init, rmsnorm, swiglu
from .mamba2 import mamba2_decode, mamba2_forward, mamba2_init
from .moe import EXPERT_KEYS, SHARED_KEYS, moe_forward, moe_init

ATTN_KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
MIXER_KEYS = ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D", "gate_norm/scale",
              "out_proj")


def _sub(params: dict, prefix: str, keys: tuple) -> dict:
    """The entries ``prefix + k`` of ``params`` for each of ``keys`` it
    holds, under their short names ``k``."""
    return {k: params[f"{prefix}{k}"] for k in keys if f"{prefix}{k}" in params}


def _attn(params: dict, prefix: str, name: str = "attn") -> dict:
    return _sub(params, f"{prefix}{name}/", ATTN_KEYS)


def _mixer(params: dict, prefix: str) -> dict:
    return _sub(params, f"{prefix}mixer/", MIXER_KEYS)


def _mlp(params: dict, cfg: ArchConfig, h: torch.Tensor, prefix: str) -> torch.Tensor:
    x = rmsnorm(params[f"{prefix}ln2/scale"], h, cfg.norm_eps)
    return h + swiglu(params[f"{prefix}mlp/gate"], params[f"{prefix}mlp/up"],
                      params[f"{prefix}mlp/down"], x)


# -- dense ------------------------------------------------------------------


def _attn_init(gen: torch.Generator, cfg: ArchConfig, dtype, device, prefix: str,
               pairs=(("ln1", "attn"),)) -> dict:
    """Each (norm, attention) pair of ``pairs``, then ln2 and the MLP."""
    D = cfg.d_model
    p = {}
    for ln, attn in pairs:
        p[f"{prefix}{ln}/scale"] = torch.ones((D,), dtype=dtype, device=device)
        p.update({f"{prefix}{attn}/{k}": v for k, v in gqa_init(gen, cfg, dtype, device).items()})
    p[f"{prefix}ln2/scale"] = torch.ones((D,), dtype=dtype, device=device)
    for name, (i, o) in (("gate", (D, cfg.d_ff)), ("up", (D, cfg.d_ff)), ("down", (cfg.d_ff, D))):
        p[f"{prefix}mlp/{name}"] = dense_init(gen, i, o, dtype, device)
    return p


def dense_block_init(gen: torch.Generator, cfg: ArchConfig, dtype, device, prefix: str) -> dict:
    return _attn_init(gen, cfg, dtype, device, prefix)


def dense_block_forward(params: dict, cfg: ArchConfig, h: torch.Tensor,
                        positions: torch.Tensor, prefix: str, *, window: int = 0) -> torch.Tensor:
    h = h + gqa_forward(_attn(params, prefix), cfg,
                        rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps), positions,
                        window=window)
    return _mlp(params, cfg, h, prefix)


def dense_block_prefill(params: dict, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor,
                        prefix: str, *, window: int = 0, backend: str = "kernel"):
    """Causal attention, sliding-window when ``window``.
    -> (h, {"k", "v"} over the prompt)."""
    a, (k, v) = gqa_prefill(_attn(params, prefix), cfg,
                            rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps), positions,
                            window=window, backend=backend)
    return _mlp(params, cfg, h + a, prefix), {"k": k, "v": v}


def dense_block_decode(params: dict, cfg: ArchConfig, h: torch.Tensor, pos: int, cache: dict,
                       prefix: str, *, ring: bool = False):
    """One token over the linear cache, or with ``ring`` over a ring cache
    (slot ``pos % S``), as the JAX package's ``dense_block_decode``: the
    cache's size is the only window the decode step applies."""
    a, cache = gqa_decode(_attn(params, prefix), cfg,
                          rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps), pos, cache,
                          ring=ring)
    return _mlp(params, cfg, h + a, prefix), cache


# -- moe (MLA attention + MoE FFN) -------------------------------------------

MOE_KEYS = ("router",) + EXPERT_KEYS + SHARED_KEYS


def moe_block_init(gen: torch.Generator, cfg: ArchConfig, dtype, device, prefix: str) -> dict:
    D = cfg.d_model
    p = {f"{prefix}ln1/scale": torch.ones((D,), dtype=dtype, device=device)}
    p.update({f"{prefix}attn/{k}": v for k, v in mla_init(gen, cfg, dtype, device).items()})
    p[f"{prefix}ln2/scale"] = torch.ones((D,), dtype=dtype, device=device)
    p.update({f"{prefix}moe/{k}": v for k, v in moe_init(gen, cfg, dtype, device).items()})
    return p


def moe_block_prefill(params: dict, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor,
                      prefix: str, *, window: int = 0):
    """MLA (the plain attention, naive form), then the MoE FFN.
    -> (h, aux, {"c_kv", "k_rope"} over the prompt)."""
    a, (c_kv, k_rope) = mla_forward(_sub(params, f"{prefix}attn/", MLA_KEYS), cfg,
                                    rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps),
                                    positions, window=window)
    h = h + a
    y, aux = moe_forward(_sub(params, f"{prefix}moe/", MOE_KEYS), cfg,
                         rmsnorm(params[f"{prefix}ln2/scale"], h, cfg.norm_eps))
    return h + y, aux, {"c_kv": c_kv, "k_rope": k_rope}


def moe_block_forward(params: dict, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor,
                      prefix: str, *, window: int = 0):
    """The train forward: the prefill's arithmetic, no cache kept.
    -> (h, aux)."""
    h, aux, _ = moe_block_prefill(params, cfg, h, positions, prefix, window=window)
    return h, aux


def moe_block_decode(params: dict, cfg: ArchConfig, h: torch.Tensor, pos: int, cache: dict,
                     prefix: str, *, ring: bool = False):
    """One token: absorbed MLA over the latent cache ``{"c_kv", "k_rope"}``
    (written in place; a ring with ``ring``), then the MoE FFN over the
    batch's one group (its aux discarded)."""
    a, cache = mla_decode(_sub(params, f"{prefix}attn/", MLA_KEYS), cfg,
                          rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps), pos, cache,
                          ring=ring)
    h = h + a
    y, _ = moe_forward(_sub(params, f"{prefix}moe/", MOE_KEYS), cfg,
                       rmsnorm(params[f"{prefix}ln2/scale"], h, cfg.norm_eps))
    return h + y, cache


# -- ssm (Mamba2: mixer only, no separate MLP) --------------------------------


def ssm_block_init(gen: torch.Generator, cfg: ArchConfig, dtype, device, prefix: str) -> dict:
    p = {f"{prefix}ln1/scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    p.update({f"{prefix}mixer/{k}": v for k, v in mamba2_init(gen, cfg, dtype, device).items()})
    return p


def ssm_block_prefill(params: dict, cfg: ArchConfig, h: torch.Tensor, prefix: str, *,
                      backend: str = "kernel"):
    """ln1, the mixer (the SSD kernel), the residual.
    -> (h, {"state", "conv"})."""
    y, mcache = mamba2_forward(_mixer(params, prefix), cfg,
                               rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps),
                               backend=backend)
    return h + y, mcache


def ssm_block_forward(params: dict, cfg: ArchConfig, h: torch.Tensor, prefix: str) -> torch.Tensor:
    """The train forward: the prefill's arithmetic on the plain SSD scan."""
    return ssm_block_prefill(params, cfg, h, prefix, backend="ref")[0]


def ssm_block_decode(params: dict, cfg: ArchConfig, h: torch.Tensor, cache: dict, prefix: str):
    """One token of the recurrence; ``cache`` {"state", "conv"} written in
    place."""
    y, cache = mamba2_decode(_mixer(params, prefix), cfg,
                             rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps), cache)
    return h + y, cache


# -- hybrid (Hymba: parallel attention + SSM branches) ------------------------


def hybrid_block_init(gen: torch.Generator, cfg: ArchConfig, dtype, device, prefix: str) -> dict:
    p = dense_block_init(gen, cfg, dtype, device, prefix)
    p.update({f"{prefix}mixer/{k}": v for k, v in mamba2_init(gen, cfg, dtype, device).items()})
    p[f"{prefix}branch_scale"] = torch.full((2,), 0.5, dtype=torch.float32, device=device)
    return p


def hybrid_block_forward(params: dict, cfg: ArchConfig, h: torch.Tensor,
                         positions: torch.Tensor, prefix: str) -> torch.Tensor:
    """The train forward: both branches on the same normalised input (the
    attention's window ``cfg.sliding_window``, the mixer's plain SSD scan),
    summed with the layer's branch scales, then the MLP."""
    x = rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps)
    a = gqa_forward(_attn(params, prefix), cfg, x, positions, window=cfg.sliding_window)
    m, _ = mamba2_forward(_mixer(params, prefix), cfg, x, backend="ref")
    s = params[f"{prefix}branch_scale"].to(h.dtype)
    return _mlp(params, cfg, h + s[0] * a + s[1] * m, prefix)


def hybrid_block_prefill(params: dict, cfg: ArchConfig, h: torch.Tensor,
                         positions: torch.Tensor, prefix: str, *, backend: str = "kernel"):
    """Both branches on the same normalised input, summed with the layer's
    branch scales.  -> (h, {"k", "v", "state", "conv"})."""
    x = rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps)
    a, (k, v) = gqa_prefill(_attn(params, prefix), cfg, x, positions,
                            window=cfg.sliding_window, backend=backend)
    m, mcache = mamba2_forward(_mixer(params, prefix), cfg, x, backend=backend)
    s = params[f"{prefix}branch_scale"].to(h.dtype)
    h = h + s[0] * a + s[1] * m
    return _mlp(params, cfg, h, prefix), {"k": k, "v": v, **mcache}


def hybrid_block_decode(params: dict, cfg: ArchConfig, h: torch.Tensor, pos: int, cache: dict,
                        prefix: str):
    """Decode always uses the ring cache (its size is the window)."""
    x = rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps)
    a, _ = gqa_decode(_attn(params, prefix), cfg, x, pos, cache, ring=True)
    m, _ = mamba2_decode(_mixer(params, prefix), cfg, x, cache)
    s = params[f"{prefix}branch_scale"].to(h.dtype)
    h = h + s[0] * a + s[1] * m
    return _mlp(params, cfg, h, prefix), cache


# -- encoder/decoder blocks (audio enc-dec) -----------------------------------


enc_block_init = dense_block_init


def enc_block_forward(params: dict, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor,
                      prefix: str) -> torch.Tensor:
    """The train forward: self-attention over every frame (plain), then the
    MLP."""
    a = gqa_forward(_attn(params, prefix), cfg,
                    rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps), positions,
                    causal=False)
    return _mlp(params, cfg, h + a, prefix)


def enc_block_prefill(params: dict, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor,
                      prefix: str, *, backend: str = "kernel") -> torch.Tensor:
    """Self-attention over every frame (non-causal flash), then the MLP."""
    a, _ = gqa_prefill(_attn(params, prefix), cfg,
                       rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps), positions,
                       causal=False, backend=backend)
    return _mlp(params, cfg, h + a, prefix)


def dec_block_init(gen: torch.Generator, cfg: ArchConfig, dtype, device, prefix: str) -> dict:
    return _attn_init(gen, cfg, dtype, device, prefix, (("ln1", "self"), ("ln_x", "cross")))


def cross_kv(params: dict, cfg: ArchConfig, enc_out: torch.Tensor, prefix: str, *,
             v_memory: torch.Tensor | None = None):
    """The encoder memory's K/V [B, S, KV, hd] for one decoder layer's
    cross-attention (computed once a prefill, kept in the cache); V from
    ``v_memory`` when given (the same memory as a second input: the
    checkpointed train loss's)."""
    p = _attn(params, prefix, "cross")
    v_in = enc_out if v_memory is None else v_memory
    return _proj(p, cfg, enc_out, "k", cfg.n_kv_heads), _proj(p, cfg, v_in, "v", cfg.n_kv_heads)


def dec_block_forward(params: dict, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor,
                      xkv: tuple, prefix: str) -> torch.Tensor:
    """The train forward: causal self-attention, then cross-attention over
    the encoder memory ``xkv = (xk, xv)``, both plain, then the MLP."""
    h = h + gqa_forward(_attn(params, prefix, "self"), cfg,
                        rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps), positions)
    c = gqa_forward(_attn(params, prefix, "cross"), cfg,
                    rmsnorm(params[f"{prefix}ln_x/scale"], h, cfg.norm_eps), positions,
                    causal=False, kv_override=xkv)
    return _mlp(params, cfg, h + c, prefix)


def dec_block_prefill(params: dict, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor,
                      xkv: tuple, prefix: str, *, backend: str = "kernel"):
    """Causal self-attention, then non-causal cross-attention over the
    encoder memory ``xkv = (xk, xv)``, both through flash, then the MLP.
    -> (h, {"k", "v"} over the prompt)."""
    a, (k, v) = gqa_prefill(_attn(params, prefix, "self"), cfg,
                            rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps), positions,
                            backend=backend)
    h = h + a
    c, _ = gqa_prefill(_attn(params, prefix, "cross"), cfg,
                       rmsnorm(params[f"{prefix}ln_x/scale"], h, cfg.norm_eps), positions,
                       causal=False, kv_override=xkv, backend=backend)
    return _mlp(params, cfg, h + c, prefix), {"k": k, "v": v}


def dec_block_decode(params: dict, cfg: ArchConfig, h: torch.Tensor, pos: int, cache: dict,
                     prefix: str, *, ring: bool = False):
    """One token: self-attention over the linear cache ``{"k", "v"}`` (a
    ring with ``ring``; written in place), cross-attention over ``{"xk",
    "xv"}``."""
    a, _ = gqa_decode(_attn(params, prefix, "self"), cfg,
                      rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps), pos, cache,
                      ring=ring)
    h = h + a
    c, _ = gqa_decode(_attn(params, prefix, "cross"), cfg,
                      rmsnorm(params[f"{prefix}ln_x/scale"], h, cfg.norm_eps), pos, None,
                      cross_kv=(cache["xk"], cache["xv"]))
    return _mlp(params, cfg, h + c, prefix), cache
