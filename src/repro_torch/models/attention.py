"""Attention: GQA (llama/qwen-style, optional QKV bias), train path.

Layouts (the JAX package's): activations [B, T, D]; heads [B, T, H, hd].
Scores are taken in fp32, masked with -1e30 before an fp32 softmax, as in
``repro.models.attention``.  The port's counterpart of its full-sequence
train path; MLA, the query-chunked long-sequence path and the decode caches
are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from .layers import apply_rope, dense_init

NEG_INF = -1e30


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True):
    """q [B,T,H,hd], k/v [B,T,KV,hd] -> [B,T,H,hd] (GQA: kv head = h // (H/KV))."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    qg = q.reshape(B, T, KV, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    if causal:
        pos = torch.arange(T, device=q.device)
        mask = pos[:, None] >= pos[None, :]                          # [Tq, Tk]
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, T, H, hd)


def gqa_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    hd = cfg.hd()
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    p = {
        "wq": dense_init(gen, D, H * hd, dtype, device),
        "wk": dense_init(gen, D, KV * hd, dtype, device),
        "wv": dense_init(gen, D, KV * hd, dtype, device),
        "wo": dense_init(gen, H * hd, D, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
    return p


def gqa_forward(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """Causal self-attention of one layer; ``p`` holds its wq/wk/wv/wo."""
    B, T, _ = x.shape
    hd = cfg.hd()
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, T, cfg.n_heads, hd), positions, cfg.rope_theta, cfg.rope_kind)
    k = apply_rope(k.reshape(B, T, cfg.n_kv_heads, hd), positions, cfg.rope_theta, cfg.rope_kind)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    return attend(q, k, v).reshape(B, T, -1) @ p["wo"]
