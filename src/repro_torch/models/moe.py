"""Mixture-of-Experts: top-k router, GShard-style grouped capacity dispatch,
shared experts, and the load-balance auxiliary loss (the port of
``repro.models.moe``).

Dispatch is group-wise (``group_size`` tokens a group, capacity ``C =
ceil(g*k/E * capacity_factor)``), so the one-hot dispatch tensor is [g, E,
C] a group.  The trailing group is padded with zero rows, whose outputs are
discarded; their router logits are exactly 0, so all E experts tie for
them, and :func:`top_k` breaks ties toward the lower expert index, as
``jax.lax.top_k`` does: a pad's choices are experts 0..k-1.  The priority
is choice-major (every token's choice 0 before any token's choice 1), so a
pad's choice 0 takes a slot before a real token's choice 1.  Overflowing
assignments are dropped, in prefill and decode alike.  The router runs in
fp32 (``x.float() @ router``) whatever the model's dtype.

One-hots are comparisons with ``arange`` and dispatch never calls
``nonzero``, ``.item()`` or ``.tolist()``, so the loss runs under
``torch.func.vmap`` (the vmapped cohort mode) and never synchronises the
card.  No kernel of the port runs here: the JAX package computes the
dispatch and expert products outside any Pallas kernel too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..dist.tensor import whole
from .layers import dense_init, swiglu

EXPERT_KEYS = ("experts/gate", "experts/up", "experts/down")
SHARED_KEYS = ("shared/gate", "shared/up", "shared/down")


def _stack_init(gen: torch.Generator, n: int, in_dim: int, out_dim: int, dtype, device):
    """[n, in, out]: ``n`` dense inits drawn one after the other (the fp32
    draw of one expert at a time bounds the init's transient memory)."""
    out = torch.empty((n, in_dim, out_dim), dtype=dtype, device=device)
    if out.device.type != "meta":
        for e in range(n):
            out[e] = dense_init(gen, in_dim, out_dim, dtype, device)
    return out


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    """The router [D, E] in fp32, the expert stacks ``experts/{gate,up}``
    [E, D, F] and ``experts/down`` [E, F, D], and with ``num_shared`` the
    shared experts' SwiGLU ``shared/*`` of width ``expert_ff * num_shared``."""
    m, D = cfg.moe, cfg.d_model
    p = {"router": dense_init(gen, D, m.num_experts, torch.float32, device)}
    for name, (i, o) in zip(EXPERT_KEYS, ((D, m.expert_ff), (D, m.expert_ff),
                                          (m.expert_ff, D))):
        p[name] = _stack_init(gen, m.num_experts, i, o, dtype, device)
    if m.num_shared:
        F_s = m.expert_ff * m.num_shared
        for name, (i, o) in zip(SHARED_KEYS, ((D, F_s), (D, F_s), (F_s, D))):
            p[name] = dense_init(gen, i, o, dtype, device)
    return p


def capacity(cfg: ArchConfig, group: int) -> int:
    m = cfg.moe
    return max(1, math.ceil(group * m.top_k / m.num_experts * m.capacity_factor))


def top_k(probs: torch.Tensor, k: int):
    """The k largest of ``probs`` [..., E] in descending order, ties to the
    lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises none):
    -> (values, indices) [..., k]."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot [..., n] of ``idx`` by comparison with ``arange`` (an
    index outside 0..n-1 gives a zero row, as ``jax.nn.one_hot`` does)."""
    return (idx[..., None] == torch.arange(n, device=idx.device, dtype=idx.dtype)).float()


def _dispatch_group(router_probs: torch.Tensor, k: int, cap: int):
    """router_probs [g, E] -> (dispatch [g,E,C] fp32 0/1, combine [g,E,C]
    fp32, aux).  An assignment's position in its expert is the cumsum of
    the flattened, priority-ordered (choice-major) assignment stream;
    assignments at position ``cap`` or later are dropped (classic GShard)."""
    router_probs = whole(router_probs, 0, 1)   # on a mesh: the index arithmetic on every rank
    g, E = router_probs.shape
    gates, idx = top_k(router_probs, k)                           # [g,k]
    onehot = _onehot(idx, E)                                      # [g,k,E]
    # priority: expert choice j of token t ranks after all j'<j choices and
    # all earlier tokens' choice-j assignments (GShard ordering).  The stream
    # runs along the last axis: a cumsum over the outer axis of [k*g, E]
    # scans each of the few columns serially on a CUDA card (on an H100, 42 %
    # of DeepSeek-V2-Lite's prefill), and the integer-valued sums are equal.
    flat = onehot.permute(2, 1, 0).reshape(E, k * g)              # [E, k*g]
    pos_flat = torch.cumsum(flat, dim=-1) - flat                  # position in expert
    pos = pos_flat.reshape(E, k, g).permute(2, 1, 0)              # [g,k,E]
    pos = torch.sum(pos * onehot, dim=-1)                         # [g,k]
    keep = (pos < cap) & (gates > 0)
    cslots = torch.arange(cap, device=pos.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == cslots).float() * keep[..., None]
    disp = torch.einsum("gke,gkc->gec", onehot, pos_oh)           # [g,E,C]
    comb = torch.einsum("gke,gkc->gec", onehot * gates[..., None], pos_oh)
    # load-balance aux (Switch): E * sum_e f_e * P_e
    f_e = torch.mean(torch.sum(onehot, dim=1), dim=0)             # frac routed
    P_e = torch.mean(router_probs, dim=0)
    aux = E * torch.sum(f_e * P_e) / k
    return disp, comb, aux


def token_groups(cfg: ArchConfig, x: torch.Tensor):
    """x [B, T, D] -> (groups [n, g, D], capacity): the tokens in groups of
    ``g = min(group_size, B*T)``, the trailing group padded with zero rows."""
    B, T, D = x.shape
    tokens = x.reshape(B * T, D)
    g = min(cfg.moe.group_size, B * T)
    pad = (-(B * T)) % g
    if pad:   # pad the trailing group (padded tokens' outputs are discarded)
        tokens = torch.cat([tokens, tokens.new_zeros((pad, D))], dim=0)
    return tokens.reshape(-1, g, D), capacity(cfg, g)


def router_probs(router: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """The router's fp32 softmax over the experts, [..., g, E]."""
    return torch.softmax(xg.float() @ router, dim=-1)


def _group_ffn(params: dict, cfg: ArchConfig, xg: torch.Tensor, cap: int):
    """Groups xg [n, g, D] -> (y [n, g, D], aux [n]): the router in fp32,
    the dispatch of each group, the experts on their [E, C] slots."""
    xg = whole(xg, 1)     # on a mesh a group's tokens on every rank (a decode's one group)
    probs = whole(router_probs(params["router"], xg), 0)          # [n,g,E], every group
    disp, comb, aux = [], [], []
    for i in range(xg.shape[0]):
        d, c, a = _dispatch_group(probs[i], cfg.moe.top_k, cap)
        disp.append(d)
        comb.append(c)
        aux.append(a)
    disp = torch.stack(disp).to(xg.dtype)
    comb = torch.stack(comb).to(xg.dtype)
    expert_in = torch.einsum("ngec,ngd->necd", disp, xg)          # [n,E,C,D]
    gate, up, down = (params[k] for k in EXPERT_KEYS)
    h = F.silu(torch.einsum("necd,edf->necf", expert_in, gate))
    h = h * torch.einsum("necd,edf->necf", expert_in, up)
    eout = torch.einsum("necf,efd->necd", h, down)                # [n,E,C,D]
    return torch.einsum("ngec,necd->ngd", comb, eout), torch.stack(aux)


def moe_forward(params: dict, cfg: ArchConfig, x: torch.Tensor):
    """x [B, T, D] -> (y [B, T, D], aux scalar fp32 = the groups' mean aux x
    ``aux_coef``).  ``params`` holds ``router``, ``experts/*`` and
    ``shared/*``.  The groups go through the experts together, or one at a
    time with ``scan_groups`` (bounds the dispatch's working set; the same
    result)."""
    m = cfg.moe
    B, T, D = x.shape
    xg, cap = token_groups(cfg, x)
    if m.scan_groups and xg.shape[0] > 1:
        parts = [_group_ffn(params, cfg, xg[i:i + 1], cap) for i in range(xg.shape[0])]
        ys = torch.cat([y for y, _ in parts])
        auxs = torch.cat([a for _, a in parts])
    else:
        ys, auxs = _group_ffn(params, cfg, xg, cap)
    y = ys.reshape(-1, D)[: B * T].reshape(B, T, D)
    if m.num_shared:
        y = y + swiglu(*(params[k] for k in SHARED_KEYS), x)
    return y, auxs.mean() * m.aux_coef
