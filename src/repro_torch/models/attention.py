"""Attention: GQA (llama/qwen-style, optional QKV bias), sliding window,
cross-attention over an encoder memory, DeepSeek's multi-head latent
attention (MLA), and the decode caches (linear and ring).

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
cross-attention.  MLA (:func:`mla_forward`, :func:`mla_decode`) runs the
plain :func:`attend` in the train loss and the prefill alike, as the JAX
package does: its q and k are ``qk_nope_dim + qk_rope_dim`` wide (192 in
DeepSeek) and its v ``v_head_dim`` (128), which the flash kernel's one
head dim does not take.  It caches the compressed ``(c_kv, k_rope)``
[B, S, kv_lora] / [B, S, qk_rope_dim], and decodes in the latent space.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..dist.tensor import is_sharded, merged, settle, splittable
from ..kernels.flash_attention.ops import flash_attend
from .layers import apply_rope, dense_init, rmsnorm

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
    qg = splittable(q, 2, KV).reshape(B, Tq, KV, H // KV, hd)
    if (is_sharded(q, 2) or is_sharded(k, 2)) and not (is_sharded(q, 0) or is_sharded(k, 0)):
        return merged(_attend_block_kv_major(qg, k, v, mask, scale), 2, KV)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return merged(out.reshape(B, Tq, H, v.shape[-1]), 2, KV)


def _attend_block_kv_major(qg, k, v, mask, scale: float):
    """:func:`_attend_block`'s products with the KV heads leading, for
    DTensor inputs whose heads (q's or k's) are sharded and whose batch is
    not: the
    products fold their batch dims together, and DTensor folds a sharded
    dim after an unsharded one into a strided shard that it cannot fold
    again under the vmapped cohort's client dim (sharded over the data
    axes); with the sharded heads first it can.  qg [B,Tq,KV,g,hd] ->
    [B,Tq,H,dv]."""
    B, Tq, KV, g, _ = qg.shape
    scores = torch.einsum("kbgqd,kbsd->kbgqs", qg.permute(2, 0, 3, 1, 4),
                          k.permute(2, 0, 1, 3)).float() * scale
    scores = torch.where(mask.transpose(0, 1) if mask.dim() == 5 else mask,
                         scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("kbgqs,kbsd->kbgqd", probs, v.permute(2, 0, 1, 3))
    return out.permute(1, 3, 0, 2, 4).reshape(B, Tq, KV * g, v.shape[-1])


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor | None = None,
           kv_pos: torch.Tensor | None = None, *, causal: bool = True, window: int = 0,
           kv_valid: torch.Tensor | None = None, banded: bool = False) -> torch.Tensor:
    """Causal attention, or over every key with ``causal=False``: q
    [B,Tq,H,hd], k/v [B,Tk,KV,hd] -> [B,Tq,H,hd] (GQA: kv head = h // (H/KV)).

    q_pos [Tq] and kv_pos [Tk] are absolute positions (default 0..T-1);
    kv_valid optional bool [B,Tk] (decode cache validity).  Above
    ``CHUNK_THRESHOLD`` queries go ``Q_CHUNK`` at a time, which bounds the
    fp32 score tensor and changes no result.  ``banded`` (the JAX
    package's ``cfg.opt_banded_window``): chunked, causal, with a window,
    no ``kv_valid`` and ``Tk > Q_CHUNK + window``, query chunk i scores
    only the ``Q_CHUNK + window`` keys from ``clip(i * Q_CHUNK - window +
    1, 0, Tk - band)``, the only ones its window reaches when query and
    key positions run together; the keys it drops are the masked ones,
    so only the softmax's sums change their order."""
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
    Tk = k.shape[1]
    band = Q_CHUNK + window
    if banded and window and causal and kv_valid is None and Tk > band:
        starts = [min(max(q0 - window + 1, 0), Tk - band) for q0 in range(0, Tq, Q_CHUNK)]
        return torch.cat([_attend_block(q[:, q0:q0 + Q_CHUNK], k[:, s:s + band],
                                        v[:, s:s + band],
                                        band_mask(q_pos[q0:q0 + Q_CHUNK], kv_pos[s:s + band],
                                                  window=window), scale)
                          for q0, s in zip(range(0, Tq, Q_CHUNK), starts)], dim=1)
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
    return splittable(y, -1, heads).reshape(*x.shape[:2], heads, cfg.hd())


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
    out = attend(q, k, v, positions, kv_pos, causal=causal, window=window,
                 banded=cfg.opt_banded_window)
    return settle(merged(out.reshape(B, T, -1), -1, out.shape[2]) @ p["wo"])


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
    return settle(out.reshape(B, T, -1) @ p["wo"]), (k, v)


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
        return _out_proj(out, p["wo"]), cache
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
    return _out_proj(out, p["wo"]), cache


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """One token's output projection, out [B, 1, H, hd] -> [B, 1, D], as
    a [B, H hd] x [H hd, D] product.  The [B, 1, H hd] product folds into
    the same GEMM on a plain tensor; a DTensor's reshape strides its unit
    dim so that ``matmul`` does not fold, and runs it as a batched product
    of B rows, which rounds otherwise."""
    return settle(out.reshape(out.shape[0], -1) @ wo)[:, None]


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

MLA_KEYS = ("wdkv", "wkr", "kv_norm/scale", "wuk", "wuv", "wo", "wq", "wdq", "q_norm/scale",
            "wuq")


def mla_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    """The latent down-projections ``wdkv`` [D, kv_lora] (then ``kv_norm``)
    and ``wkr`` [D, rope], the up-projections ``wuk`` / ``wuv``, ``wo``, and
    the query's ``wq`` [D, H*qk], or with ``q_lora`` ``wdq``, ``q_norm`` and
    ``wuq``."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    p = {
        "wdkv": dense_init(gen, D, m.kv_lora, dtype, device),
        "wkr": dense_init(gen, D, m.qk_rope_dim, dtype, device),
        "kv_norm/scale": torch.ones((m.kv_lora,), dtype=dtype, device=device),
        "wuk": dense_init(gen, m.kv_lora, H * m.qk_nope_dim, dtype, device),
        "wuv": dense_init(gen, m.kv_lora, H * m.v_head_dim, dtype, device),
        "wo": dense_init(gen, H * m.v_head_dim, D, dtype, device),
    }
    if m.q_lora:
        p["wdq"] = dense_init(gen, D, m.q_lora, dtype, device)
        p["q_norm/scale"] = torch.ones((m.q_lora,), dtype=dtype, device=device)
        p["wuq"] = dense_init(gen, m.q_lora, H * qk, dtype, device)
    else:
        p["wq"] = dense_init(gen, D, H * qk, dtype, device)
    return p


def _mla_q(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """(q_nope [B,T,H,nope], q_rope [B,T,H,rope]), RoPE not applied yet."""
    m = cfg.mla
    B, T, _ = x.shape
    if m.q_lora:
        q = rmsnorm(p["q_norm/scale"], x @ p["wdq"], cfg.norm_eps) @ p["wuq"]
    else:
        q = x @ p["wq"]
    q = splittable(q, -1, cfg.n_heads).reshape(B, T, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    return q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]


def _mla_ckv(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """The cache entries: c_kv [B,T,kv_lora] after ``kv_norm``, and k_rope
    [B,T,rope] after RoPE (one rope key shared by every head)."""
    c_kv = rmsnorm(p["kv_norm/scale"], x @ p["wdkv"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["wkr"])[:, :, None, :], positions, cfg.rope_theta, "full")
    return c_kv, k_rope[:, :, 0]


def mla_forward(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
                window: int = 0):
    """Train loss and prefill: c_kv expanded into per-head K/V (the "naive"
    form) through the plain :func:`attend` (scale ``1/sqrt(qk_nope +
    qk_rope)``).  -> (out [B,T,D], (c_kv, k_rope)), the compressed cache
    entries."""
    m = cfg.mla
    B, T, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(p, cfg, x)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta, "full")
    c_kv, k_rope = _mla_ckv(p, cfg, x, positions)
    k_nope = splittable(c_kv @ p["wuk"], -1, H).reshape(B, T, H, m.qk_nope_dim)
    v = splittable(c_kv @ p["wuv"], -1, H).reshape(B, T, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, m.qk_rope_dim)], dim=-1)
    out = attend(q, k, v, positions, positions, causal=True, window=window,
                 banded=cfg.opt_banded_window)
    return settle(merged(out.reshape(B, T, -1), -1, H) @ p["wo"]), (c_kv, k_rope)


def mla_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, pos: int, cache: dict, *,
               ring: bool = False):
    """Absorbed decode: scores and values in the kv_lora latent space (W_uk
    folded into q, W_uv applied to the latent context), so a token costs
    O(S * kv_lora) and the cache is (kv_lora + rope) wide.  x [B,1,D]; pos
    the absolute position (an int); cache {"c_kv": [B,S,kv_lora],
    "k_rope": [B,S,rope]} written in place at slot ``pos`` (``pos % S``
    with ``ring``).  -> (out [B,1,D], cache)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x)                                  # [B,1,H,*]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta, "full")
    c_new, kr_new = _mla_ckv(p, cfg, x, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    S = c_kv.shape[1]
    slot = pos % S if ring else pos
    c_kv[:, slot] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, slot] = kr_new[:, 0].to(k_rope.dtype)
    slots = torch.arange(S, device=x.device)
    valid = torch.ones_like(slots, dtype=torch.bool) if ring and pos + 1 >= S else slots <= pos

    wuk = splittable(p["wuk"], -1, H).reshape(m.kv_lora, H, m.qk_nope_dim)
    q_c = torch.einsum("bqhn,lhn->bqhl", q_nope, wuk)                   # absorb W_uk
    scores = torch.einsum("bqhl,bsl->bhqs", q_c, c_kv)
    scores = scores + torch.einsum("bqhr,bsr->bhqs", q_rope, k_rope)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(m.qk_nope_dim + m.qk_rope_dim)))
    scores = scores.float() * scale
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    ctx = torch.einsum("bhqs,bsl->bqhl", probs, c_kv)                   # latent context
    wuv = splittable(p["wuv"], -1, H).reshape(m.kv_lora, H, m.v_head_dim)
    out = torch.einsum("bqhl,lhv->bqhv", ctx, wuv)                      # absorb W_uv
    return settle(out.reshape(B, 1, -1) @ p["wo"]), cache
