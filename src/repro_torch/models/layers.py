"""Shared layers: norms, RoPE, MLPs, inits — plain functions on tensors.

Parameter convention (the JAX package's): a dense weight is ``[in, out]`` and
applies as ``x @ w``; every layer is an ``init(gen, ...) -> params`` plus a
pure ``apply(params, x, ...)`` pair over a flat dict of tensors.  The
numerics follow ``repro.models.layers``: RMSNorm in fp32, RoPE on
concatenated halves, fp32 log-sum-exp cross entropy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.tensor import settle, whole


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype, device) -> torch.Tensor:
    if torch.device(device).type == "meta":     # shapes alone: a meta draw costs ~1 ms a leaf
        return torch.empty((in_dim, out_dim), dtype=dtype, device=device)
    w = torch.randn((in_dim, out_dim), generator=gen, device=device)
    return (w * (1.0 / in_dim ** 0.5)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty((vocab, dim), dtype=dtype, device=device)
    return (torch.randn((vocab, dim), generator=gen, device=device) * 0.02).to(dtype)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def rope_frequencies(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, kind: str = "full"):
    """x [..., T, n_heads, head_dim]; positions [T] (absolute).  Rotates the
    two concatenated halves of the rotary dims (not interleaved pairs)."""
    if kind == "none":
        return x
    hd = x.shape[-1]
    rot_dim = hd if kind == "full" else hd // 2
    freqs = rope_frequencies(rot_dim, theta, x.device)              # [rot/2]
    ang = positions[:, None].float() * freqs                        # [T, rot/2]
    cos = torch.cos(ang)[:, None, :]                                # [T, 1, rot/2]
    sin = torch.sin(ang)[:, None, :]
    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., : rot_dim // 2], xr[..., rot_dim // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rotated.to(x.dtype), x[..., rot_dim:]], dim=-1)


def swiglu(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor, x: torch.Tensor):
    return settle((F.silu(x @ gate) * (x @ up)) @ down)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, onehot: bool = False) -> torch.Tensor:
    """Per-position cross entropy, fp32; logits [..., V], labels [...].

    ``onehot=True`` (``cfg.opt_onehot_xent``) picks the label's logit as
    the sum of ``logits * one_hot(labels)`` (a compare with an iota, no
    gather), as the JAX package does: one product by 1 and exact zeros, so
    the same value as the gather for finite logits."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    if onehot:
        iota = torch.arange(lf.shape[-1], device=lf.device)
        picked = (lf * (labels[..., None].long() == iota).to(lf.dtype)).sum(-1)
    else:
        picked = torch.gather(whole(lf, -1), -1, labels[..., None].long())[..., 0]
    return lse - picked
