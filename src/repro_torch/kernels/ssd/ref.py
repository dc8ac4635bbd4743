"""SSD's plain torch versions: the sequential oracle and the intra-chunk
function the CUDA kernel computes.

* :func:`ssd_ref` is the port's copy of the JAX package's oracle
  (``repro/kernels/ssd/ref.py``), the state recurrence step by step::

      h_t = exp(a_t) * h_{t-1} + B_t (x) xdt_t
      y_t = C_t . h_t

* :func:`ssd_intra_chunk_torch` is the plain version of the kernel
  (``csrc/ssd.cu``; the JAX package's Pallas ``ssd_intra_chunk``): per
  (batch, chunk, head), ``cum = cumsum(a)``, the chunk's own output
  ``y_i = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) xdt_j`` and its local
  state ``S = sum_j exp(cum_end - cum_j) B_j (x) xdt_j``, in fp32.  It masks
  *before* the exp (``exp(-inf) = 0`` above the diagonal), so strong decay
  gives no inf * 0 = NaN, as the JAX kernel's mask-after form does.  cum
  is summed in float64, and the exponents cum_i - cum_j and cum_end - cum_j
  are formed in float64 and rounded once to fp32.  An fp32 cum, at |cum| ~
  200 in a 256-step chunk, is off by up to half an fp32 step (~8e-6) when
  rounded once and by ~1e-4 when summed in fp32 step by step (torch's float
  cumsum on the card); either error alone, through exponents near 0 and
  |C_i . B_j| ~ 20 at N 128, moves y past atol 3e-5 / rtol 3e-4 of the
  step computed in fp64 throughout.  The fp64 exponents keep y within 0.03
  of that bound of it (tests/test_torch_ssd.py).
"""
from __future__ import annotations

import torch


def ssd_ref(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
            state0: torch.Tensor | None = None):
    """xdt [B,T,H,P]; a [B,T,H]; Bm/Cm [B,T,N] -> (y [B,T,H,P], S [B,H,P,N]), fp32."""
    B, T, H, P = xdt.shape
    N = Bm.shape[-1]
    S = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device)
         if state0 is None else state0.float())
    ys = []
    for t in range(T):
        S = S * torch.exp(a[:, t].float())[..., None, None] + torch.einsum(
            "bn,bhp->bhpn", Bm[:, t].float(), xdt[:, t].float())
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), S))
    return torch.stack(ys, dim=1), S


def ssd_intra_chunk_torch(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                          Cm: torch.Tensor):
    """xdt [Bz,nc,Q,H,P]; a [Bz,nc,Q,H]; Bm/Cm [Bz,nc,Q,N] -> (y_intra
    [Bz,nc,Q,H,P], S_local [Bz,nc,H,P,N]), both fp32."""
    Q = xdt.shape[2]
    x, Bf, Cf = xdt.float(), Bm.float(), Cm.float()
    cum = torch.cumsum(a.double(), dim=2)                             # [Bz,nc,Q,H] fp64
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)                  # [Bz,nc,Qi,Qj]
    idx = torch.arange(Q, device=xdt.device)
    tri = (idx[:, None] >= idx[None, :])[:, :, None]                  # [Qi,Qj,1]
    diff = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).float()    # [Bz,nc,Qi,Qj,H]
    seg = torch.exp(torch.where(tri, diff, -torch.inf))
    y = torch.einsum("bcijh,bcjhp->bcihp", seg * scores[..., None], x)
    decay = torch.exp((cum[:, :, -1:] - cum).float())                 # [Bz,nc,Q,H]
    s = torch.einsum("bcqn,bcqhp->bchpn", Bf, decay[..., None] * x)
    return y, s
