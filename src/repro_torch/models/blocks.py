"""Transformer blocks (dense family): init and the train forward.

A block's parameters are the flat-dict entries under its prefix
(``blocks/{i}/ln1/scale``, ``blocks/{i}/attn/wq``, …, ``blocks/{i}/mlp/down``).
The port's counterpart of ``repro.models.blocks`` for the dense family.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .attention import gqa_forward, gqa_init
from .layers import dense_init, rmsnorm, swiglu


def dense_block_init(gen: torch.Generator, cfg: ArchConfig, dtype, device, prefix: str) -> dict:
    D = cfg.d_model
    p = {f"{prefix}ln1/scale": torch.ones((D,), dtype=dtype, device=device)}
    p.update({f"{prefix}attn/{k}": v for k, v in gqa_init(gen, cfg, dtype, device).items()})
    p[f"{prefix}ln2/scale"] = torch.ones((D,), dtype=dtype, device=device)
    for name, (i, o) in (("gate", (D, cfg.d_ff)), ("up", (D, cfg.d_ff)), ("down", (cfg.d_ff, D))):
        p[f"{prefix}mlp/{name}"] = dense_init(gen, i, o, dtype, device)
    return p


def dense_block_forward(params: dict, cfg: ArchConfig, h: torch.Tensor,
                        positions: torch.Tensor, prefix: str) -> torch.Tensor:
    attn = {k: params[f"{prefix}attn/{k}"] for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
            if f"{prefix}attn/{k}" in params}
    h = h + gqa_forward(attn, cfg, rmsnorm(params[f"{prefix}ln1/scale"], h, cfg.norm_eps),
                        positions)
    x = rmsnorm(params[f"{prefix}ln2/scale"], h, cfg.norm_eps)
    return h + swiglu(params[f"{prefix}mlp/gate"], params[f"{prefix}mlp/up"],
                      params[f"{prefix}mlp/down"], x)
