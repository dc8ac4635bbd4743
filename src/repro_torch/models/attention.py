"""Attention: GQA (llama/qwen-style, optional QKV bias), sliding window,
cross-attention over an encoder memory, and the decode caches (linear and
ring).

Layouts (the JAX package's): activations [B, T, D]; heads [B, T, H, hd];
caches [B, S, KV, hd].  :func:`attend` is the port of
``repro.models.attention.attend``: scores in fp32, masked with -1e30 before
an fp32 softmax, probabilities cast to v's dtype before ``p @ v``, query
chunking above ``CHUNK_THRESHOLD``; causal unless ``causal=False`` (the
audio encoder's self-attention and the decoder's cross-attention).  The
train loss (:func:`gqa_forward`, under autograd) and the decode step
(:func:`gqa_decode`) use it; the prefill (:func:`gqa_prefill`) goes through
the flash attention kernel (``kernels/flash_attention``), which has no
backward pass.  Both take a sliding window, the non-causal mode and
cross-attention.  MLA is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attend
from .layers import apply_rope, dense_init

CHUNK_THRESHOLD = 2048
Q_CHUNK = 1024

NEG_INF = -1e30


def band_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int = 0,
              causal: bool = True) -> torch.Tensor:
    """bool [Tq, Tk]; window=0 => unbounded lookback."""
    diff = q_pos[:, None] - kv_pos[None, :]
    m = diff >= 0 if causal else torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if window:
        m = m & (diff < window)
    return m


def _attend_block(q, k, v, mask, scale: float):
    """q [B,Tq,H,hd], k/v [B,Tk,KV,hd], mask broadcastable to [B,KV,g,Tq,Tk]."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Tq, KV, H // KV, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Tq, H, v.shape[-1])


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor | None = None,
           kv_pos: torch.Tensor | None = None, *, causal: bool = True, window: int = 0,
           kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Causal attention, or over every key with ``causal=False``: q
    [B,Tq,H,hd], k/v [B,Tk,KV,hd] -> [B,Tq,H,hd] (GQA: kv head = h // (H/KV)).

    q_pos [Tq] and kv_pos [Tk] are absolute positions (default 0..T-1);
    kv_valid optional bool [B,Tk] (decode cache validity).  Above
    ``CHUNK_THRESHOLD`` queries go ``Q_CHUNK`` at a time, which bounds the
    fp32 score tensor and changes no result."""
    B, Tq, H, hd = q.shape
    dev = q.device
    q_pos = torch.arange(Tq, device=dev) if q_pos is None else q_pos
    kv_pos = torch.arange(k.shape[1], device=dev) if kv_pos is None else kv_pos
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))

    def mask_for(qp):
        m = band_mask(qp, kv_pos, window=window, causal=causal)      # [tq, Tk]
        if kv_valid is not None:
            m = m[None, None, None] & kv_valid[:, None, None, None, :]
        return m

    if Tq <= CHUNK_THRESHOLD:
        return _attend_block(q, k, v, mask_for(q_pos), scale)
    return torch.cat([_attend_block(q[:, q0:q0 + Q_CHUNK], k, v,
                                    mask_for(q_pos[q0:q0 + Q_CHUNK]), scale)
                      for q0 in range(0, Tq, Q_CHUNK)], dim=1)


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


def _proj(p: dict, cfg: ArchConfig, x: torch.Tensor, name: str, heads: int) -> torch.Tensor:
    """x @ w{name} (+ b{name}) as [B, T, heads, hd]."""
    y = x @ p[f"w{name}"]
    if cfg.qkv_bias:
        y = y + p[f"b{name}"]
    return y.reshape(*x.shape[:2], heads, cfg.hd())


def _qkv(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """The roped q [B,T,H,hd] and k [B,T,KV,hd], and v [B,T,KV,hd]."""
    q = apply_rope(_proj(p, cfg, x, "q", cfg.n_heads), positions, cfg.rope_theta, cfg.rope_kind)
    k = apply_rope(_proj(p, cfg, x, "k", cfg.n_kv_heads), positions, cfg.rope_theta,
                   cfg.rope_kind)
    return q, k, _proj(p, cfg, x, "v", cfg.n_kv_heads)


def gqa_forward(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
                window: int = 0, causal: bool = True, kv_override=None):
    """One attention layer of the train loss (under autograd, through the
    plain :func:`attend`); ``p`` holds its wq/wk/wv/wo.  Causal
    self-attention over ``positions`` (sliding-window when ``window``), or
    over every key with ``causal=False``; ``kv_override=(k, v)`` [B, S, KV,
    hd] is cross-attention: the encoder memory as K/V, and no RoPE on q."""
    B, T, _ = x.shape
    if kv_override is None:
        q, k, v = _qkv(p, cfg, x, positions)
        kv_pos = positions
    else:
        q, (k, v) = _proj(p, cfg, x, "q", cfg.n_heads), kv_override
        kv_pos = None
    out = attend(q, k, v, positions, kv_pos, causal=causal, window=window)
    return out.reshape(B, T, -1) @ p["wo"]


def gqa_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
                causal: bool = True, window: int = 0, kv_override=None, backend: str = "kernel"):
    """The prefill form of :func:`gqa_forward`: attention through the flash
    attention kernel over prompt positions 0..T-1, causal (sliding-window
    when ``window``) or, with ``causal=False``, over every key.
    ``kv_override=(k, v)`` [B, S, KV, hd] is cross-attention: the encoder
    memory as K/V, and no RoPE on q.  Returns (out, (k, v)) so the caller
    builds the cache."""
    B, T, _ = x.shape
    if kv_override is None:
        q, k, v = _qkv(p, cfg, x, positions)
    else:
        q, (k, v) = _proj(p, cfg, x, "q", cfg.n_heads), kv_override
    out = flash_attend(q, k, v, causal=causal, window=window, backend=backend)
    return out.reshape(B, T, -1) @ p["wo"], (k, v)


def gqa_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, pos: int, cache: dict | None, *,
               ring: bool = False, cross_kv=None):
    """One-token decode.  x [B,1,D]; pos the absolute position (an int).

    cache: {"k": [B,S,KV,hd], "v": ...}, written in place at slot ``pos``
    (``pos % S`` with ``ring``: a ring cache holds exactly the window, so
    the window needs no mask of its own).  ``cross_kv=(k, v)`` [B,S,KV,hd]
    bypasses the cache: cross-attention over the whole encoder memory, no
    RoPE, nothing written.  Returns (out [B,1,D], cache)."""
    B = x.shape[0]
    if cross_kv is not None:
        out = attend(_proj(p, cfg, x, "q", cfg.n_heads), *cross_kv, causal=False)
        return out.reshape(B, 1, -1) @ p["wo"], cache
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    k, v = cache["k"], cache["v"]
    S = k.shape[1]
    slot = pos % S if ring else pos
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    slots = torch.arange(S, device=x.device)
    valid = torch.ones_like(slots, dtype=torch.bool) if ring and pos + 1 >= S else slots <= pos
    # positions are baked into the rotated keys: a validity-only mask
    out = attend(q, k, v, torch.full((1,), S + 1, device=x.device), torch.zeros_like(slots),
                 kv_valid=valid[None, :].expand(B, S))
    return out.reshape(B, 1, -1) @ p["wo"], cache
