"""Mamba2 SSD mixer (state-space duality, arXiv:2405.21060): prefill and
decode, the port of ``repro.models.mamba2``.

The prefill runs the chunked SSD scan (``kernels/ssd/ops.ssd_scan``: the
intra-chunk kernel plus the cross-chunk recurrence); decode is the pure
recurrence, O(1) per token.  The casts follow the JAX package: the mixer's
activations in the model dtype, ``dt`` and the decays in fp32, ``xdt`` in
the model dtype, the state in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..dist.tensor import merged, settle, splittable
from ..kernels.ssd.ops import ssd_scan
from .layers import dense_init, rmsnorm


def dims(cfg: ArchConfig):
    """(d_inner, heads H, head dim P, state dim N)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = s.num_heads or d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.state_dim


def mamba2_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    s = cfg.ssm
    d_inner, H, P, N = dims(cfg)
    conv_ch = d_inner + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((s.conv_width, conv_ch), generator=gen, device=device) * 0.2
    return {
        "in_proj": dense_init(gen, cfg.d_model, 2 * d_inner + 2 * N + H, dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), **f32),               # A = -exp(A_log) = -1
        "dt_bias": torch.full((H,), -2.0, **f32),        # softplus(-2) ~ 0.13
        "D": torch.ones((H,), **f32),
        "gate_norm/scale": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, dtype, device),
    }


def _split_proj(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """x @ in_proj split into (z, xc, B, C, dt)."""
    d_inner, H, P, N = dims(cfg)
    return torch.split(x @ p["in_proj"], [d_inner, d_inner, N, N, H], dim=-1)


def _causal_conv(p: dict, cfg: ArchConfig, u: torch.Tensor, conv_cache=None):
    """u [B,T,C]; depthwise causal conv of width w, then silu.  With a cache
    (decode, T=1) it uses the [B, w-1, C] history and returns the new one."""
    w = cfg.ssm.conv_width
    T = u.shape[1]
    if conv_cache is None:
        ext = torch.cat([u.new_zeros(u.shape[:1] + (w - 1,) + u.shape[2:]), u], dim=1)
    else:
        ext = torch.cat([conv_cache, u], dim=1)                  # [B, w, C]
    out = sum(ext[:, i:i + T] * p["conv_w"][i] for i in range(w))
    return F.silu(out + p["conv_b"]), (None if conv_cache is None else ext[:, 1:])


def _gate_out(p: dict, cfg: ArchConfig, y: torch.Tensor, z: torch.Tensor):
    y = rmsnorm(p["gate_norm/scale"], y * F.silu(z), cfg.norm_eps)
    return settle(y @ p["out_proj"])


def mamba2_forward(p: dict, cfg: ArchConfig, x: torch.Tensor, state0=None, *,
                   backend: str = "kernel"):
    """Prefill. x [B,T,D] -> (y [B,T,D], cache {"state", "conv"}): the
    final SSD state [B,H,P,N] (fp32) and the last w-1 raw conv inputs, so a
    prefill hands off to :func:`mamba2_decode` directly.  ``backend`` picks
    the SSD intra-chunk path (``kernels/ssd/ops``)."""
    d_inner, H, P, N = dims(cfg)
    B, T, _ = x.shape
    w = cfg.ssm.conv_width
    z, xc, Bm, Cm, dt = _split_proj(p, cfg, x)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out, _ = _causal_conv(p, cfg, conv_in)
    if T >= w - 1:
        conv_tail = conv_in[:, T - (w - 1):]
    else:  # short prefill: left-pad with zeros
        conv_tail = torch.cat([conv_in.new_zeros((B, (w - 1) - T) + conv_in.shape[2:]), conv_in],
                              dim=1)
    xc, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                       # [B,T,H]
    a = -torch.exp(p["A_log"]) * dt                                  # [B,T,H]
    xh = splittable(xc, -1, H).reshape(B, T, H, P)
    y, S = ssd_scan(xh * dt[..., None].to(xh.dtype), a, Bm, Cm, cfg.ssm.chunk, state0,
                    backend=backend)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    return _gate_out(p, cfg, merged(y.reshape(B, T, d_inner), -1, H), z), \
        {"state": S, "conv": conv_tail}


def mamba2_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict):
    """One-token recurrence.  x [B,1,D]; cache {"state": [B,H,P,N] fp32,
    "conv": [B,w-1,C]}, both written in place.  Returns (y [B,1,D], cache)."""
    d_inner, H, P, N = dims(cfg)
    B = x.shape[0]
    z, xc, Bm, Cm, dt = _split_proj(p, cfg, x)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out, conv_new = _causal_conv(p, cfg, conv_in, cache["conv"])
    xc, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                       # [B,1,H]
    a = -torch.exp(p["A_log"]) * dt                                  # [B,1,H]
    xc = splittable(xc, -1, H)
    xh = (xc.reshape(B, 1, H, P) * dt[..., None].to(xc.dtype))[:, 0]  # [B,H,P]
    S = cache["state"]
    S.mul_(torch.exp(a[:, 0])[..., None, None]).add_(
        torch.einsum("bn,bhp->bhpn", Bm[:, 0].float(), xh.float()))
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), S)
    y = y.to(x.dtype) + xc.reshape(B, 1, H, P)[:, 0] * p["D"][None, :, None].to(x.dtype)
    cache["conv"].copy_(conv_new)
    return _gate_out(p, cfg, y.reshape(B, 1, d_inner), z), cache
