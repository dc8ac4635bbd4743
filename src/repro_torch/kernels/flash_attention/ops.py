"""Model-layout dispatch for flash attention (the JAX package's
``repro/kernels/flash_attention/ops.py``).

Models hold [B, T, H, hd] activations; the kernel takes [B, H, T, hd]
views of them.  ``backend="kernel"`` (the default): a CUDA tensor launches
the hand-written kernel (``kernel.py``) and nothing else, there is no
fallback; a CPU tensor takes the plain torch version
(``ref.flash_attention_torch``).  ``backend="ref"``: the plain version on
any device.  The kernel has no backward pass, so an input that requires a
gradient raises: the training loss never comes here.

DTensor inputs (a setup on a mesh) run the same backend on each rank's
local shards through ``local_map``: q's and k/v's head dims may be
sharded so that each GQA group stays on one rank (the KV heads divide
among the ranks), their batch dims alike; any other placement is
redistributed first, in the open (a head dim whose KV heads do not divide
is gathered).  Only local tensors reach the kernel.
"""
from __future__ import annotations

from functools import partial

import torch

from ...dist.tensor import is_dtensor
from .kernel import flash_attention_kernel
from .ref import flash_attention_torch

BACKENDS = ("kernel", "ref")


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                 window: int = 0, backend: str = "kernel") -> torch.Tensor:
    """Causal, or with ``causal=False`` over every key, attention (sliding-
    window when ``window``): q [B,Tq,H,hd], k/v [B,Tk,KV,hd] -> [B,Tq,H,hd]
    in q's dtype."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; have {BACKENDS}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attend is forward-only (the kernel has no backward): "
                           "call it under torch.no_grad() or torch.inference_mode()")
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        return _on_mesh(q, k, v, causal=causal, window=window, backend=backend)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if backend == "ref" or q.device.type == "cpu":
        out = flash_attention_torch(qt, kt, vt, causal=causal, window=window)
    elif q.device.type == "cuda":
        out = flash_attention_kernel(qt, kt, vt, causal=causal, window=window)
    else:
        raise ValueError(f"flash attention has no kernel for device {q.device}")
    return out.transpose(1, 2)


def _on_mesh(q, k, v, **kw) -> torch.Tensor:
    """:func:`flash_attend` on each rank's shards of DTensor inputs."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t.device_mesh for t in (q, k, v) if is_dtensor(t))
    q, k, v = (t if is_dtensor(t) else
               DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
               for t in (q, k, v))
    KV, n = k.shape[2], 1
    pl = []
    for i, ps in enumerate(zip(q.placements, k.placements, v.placements)):
        if all(p == Shard(0) for p in ps):
            pl.append(Shard(0))                      # the batch over this mesh dim
        elif all(p == Shard(2) for p in ps) and KV % (n * mesh.size(i)) == 0:
            pl.append(Shard(2))                      # whole GQA groups over this mesh dim
            n *= mesh.size(i)
        else:
            pl.append(Replicate())
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    # ``pl`` a list: one output's placements (a tuple would be one per output)
    return local_map(partial(flash_attend, **kw), out_placements=pl,
                     in_placements=(pl, pl, pl), device_mesh=mesh)(q, k, v)
