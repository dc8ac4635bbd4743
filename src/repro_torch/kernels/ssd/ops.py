"""The chunked SSD scan: the intra-chunk kernel plus the cross-chunk
recurrence in torch (the JAX package's ``repro/kernels/ssd/ops.py``).

``backend="kernel"`` (the default): a CUDA tensor launches the hand-written
intra-chunk kernel (``kernel.py``) and nothing else, there is no fallback;
a CPU tensor takes the plain torch version (``ref.ssd_intra_chunk_torch``).
``backend="ref"``: the plain version on any device.  The cross-chunk
recurrence is a tiny [B, H, P, N] rescale and add per chunk and stays in
torch; its chunk decays and the ``exp(cum)`` factor of the inter-chunk
term come from ``cum = cumsum(a)`` summed in fp64 and rounded once to
fp32, the exponents the intra-chunk step uses.  The scan is the port's
counterpart of ``repro.models.mamba2.ssd_chunked`` as well: both compute
:func:`ref.ssd_ref`'s recurrence.  The kernel is forward-only (no backward
pass); the train loss takes the plain version (``backend="ref"``), under
autograd and ``torch.func.vmap``.

DTensor inputs (a setup on a mesh) run the intra-chunk backend on each
rank's local shards through ``local_map``: the head dim of xdt and a may
be sharded (B and C, which have no head dim, are replicated over those
ranks), the batch dim of all four alike; any other placement is
redistributed first, in the open.  Only local tensors reach the kernel.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from ...dist.tensor import is_distributed, is_dtensor, whole, whole_grad
from .kernel import ssd_intra_chunk_kernel
from .ref import ssd_intra_chunk_torch

BACKENDS = ("kernel", "ref")


def ssd_intra_chunk(xdt, a, Bm, Cm, *, backend: str = "kernel"):
    """xdt [Bz,nc,Q,H,P]; a [Bz,nc,Q,H] f32; Bm/Cm [Bz,nc,Q,N] -> (y_intra,
    S_local), fp32."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown ssd backend {backend!r}; have {BACKENDS}")
    if any(is_dtensor(t) for t in (xdt, a, Bm, Cm)):
        return _intra_on_mesh(xdt, a, Bm, Cm, backend=backend)
    if backend == "ref" or xdt.device.type == "cpu":
        return ssd_intra_chunk_torch(xdt, a, Bm, Cm)
    if xdt.device.type == "cuda":
        return ssd_intra_chunk_kernel(xdt.contiguous(), a.contiguous(), Bm.contiguous(),
                                      Cm.contiguous())
    raise ValueError(f"ssd has no kernel for device {xdt.device}")


def _intra_on_mesh(xdt, a, Bm, Cm, *, backend: str):
    """:func:`ssd_intra_chunk` on each rank's shards of DTensor inputs."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ts = (xdt, a, Bm, Cm)
    mesh = next(t.device_mesh for t in ts if is_dtensor(t))
    xdt, a, Bm, Cm = (t if is_dtensor(t) else
                      DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
                      for t in ts)
    H, n = xdt.shape[3], 1
    px, pa, pbc, py, ps = [], [], [], [], []
    for i, (p_x, p_a, p_b, p_c) in enumerate(zip(xdt.placements, a.placements,
                                                 Bm.placements, Cm.placements)):
        if all(p == Shard(0) for p in (p_x, p_a, p_b, p_c)):
            pl = (Shard(0),) * 5                     # the batch over this mesh dim
        elif p_x == p_a == Shard(3) and H % (n * mesh.size(i)) == 0:
            pl = (Shard(3), Shard(3), Replicate(), Shard(3), Shard(2))   # heads
            n *= mesh.size(i)
        else:
            pl = (Replicate(),) * 5
        for dst, p in zip((px, pa, pbc, py, ps), pl):
            dst.append(p)
    args = (xdt.redistribute(mesh, px), a.redistribute(mesh, pa),
            Bm.redistribute(mesh, pbc), Cm.redistribute(mesh, pbc))
    return local_map(partial(ssd_intra_chunk, backend=backend), out_placements=(py, ps),
                     in_placements=(px, pa, pbc, pbc), device_mesh=mesh)(*args)


def ssd_scan(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             chunk: int, state0: torch.Tensor | None = None, *, backend: str = "kernel",
             out_dtype: torch.dtype | None = None):
    """xdt [B,T,H,P]; a [B,T,H]; Bm/Cm [B,T,N] -> (y [B,T,H,P] in
    ``out_dtype``, xdt's dtype when None, final state S [B,H,P,N] fp32), in
    chunks of ``min(chunk, T)``; y is summed in fp32 and rounded once.

    The JAX package asserts that T is a multiple of the chunk; the port pads
    a ragged last chunk with steps that leave the state as it is (a = 0,
    xdt = B = C = 0), which is exact, so a prompt may have any length."""
    gathered = is_distributed(xdt) and not is_dtensor(xdt)
    if gathered:
        # the train loss on a mesh (DTensors under vmap): its plain
        # products fold a sharded head dim behind the unsharded batch and
        # chunk dims, which DTensor cannot fold again under the cohort's
        # client dim, so the heads are gathered first, and the gradient
        # of the scan's output too
        xdt, a = whole(xdt, 2), whole(a, 2)
    B, T, H, P = xdt.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    nc = -(-T // Q)
    if nc * Q != T:
        pad = (0, 0, 0, nc * Q - T)
        xdt = F.pad(xdt, (0, 0) + pad)
        a, Bm, Cm = F.pad(a, pad), F.pad(Bm, pad), F.pad(Cm, pad)
    xdt_c = xdt.reshape(B, nc, Q, H, P)
    a_c = a.reshape(B, nc, Q, H).float()
    B_c = Bm.reshape(B, nc, Q, N)
    C_c = Cm.reshape(B, nc, Q, N)
    y_intra, S_local = ssd_intra_chunk(xdt_c, a_c, B_c, C_c, backend=backend)

    # cum summed in fp64 and rounded once to fp32, as the intra-chunk
    # kernel and its plain version form their exponents (ref.py's note)
    cum = torch.cumsum(a_c.double(), dim=2).float()                   # [B,nc,Q,H]
    decay = torch.exp(cum[:, :, -1])                                  # [B,nc,H]
    S = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device)
         if state0 is None else state0.float())
    S_prev = []                                   # the state entering each chunk
    for c in range(nc):
        S_prev.append(S)
        S = S * decay[:, c, :, None, None] + S_local[:, c]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", C_c.float(), torch.stack(S_prev, dim=1))
    y = y_intra + y_inter * torch.exp(cum)[..., None]
    y = y.reshape(B, nc * Q, H, P)[:, :T].to(out_dtype or xdt.dtype)
    return (whole_grad(y, 2) if gathered else y), S
