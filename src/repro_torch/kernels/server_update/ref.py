"""Fused FedShuffleMVR server update (App. F): oracle and plain torch.

Per value, in fp32 with the outputs stored in the input dtypes:

    m' = a * (-Delta / eta_l) + (1 - a) * m        (App. F gradient estimate)
    x' = x + eta_g * Delta

Two versions:

* :func:`server_update_ref` is the port's copy of the JAX package's oracle
  (``repro/kernels/server_update/ref.py``): it divides by ``eta_l``;
* :func:`server_update_torch` is the plain torch version of the CUDA
  kernel's math (``csrc/server_update.cu``), which multiplies by
  ``inv_eta_l = 1 / eta_l`` as the Pallas kernel does.  Every product and
  sum is a separate torch op on fp32 0-dim scalar tensors, in the kernel's
  order (``ghat = (-d) * inv``, ``a * ghat``, ``(1 - a) * m`` with ``1 - a``
  formed in fp32, their sum, ``x + eta_g * d``), so nothing fuses into an
  FMA and the kernel equals it bit for bit on the card.  The two versions
  differ by the reciprocal's rounding: an ulp of ``ghat``.
"""
from __future__ import annotations

import torch


def server_update_ref(x: torch.Tensor, delta: torch.Tensor, m: torch.Tensor,
                      eta_g: float, a: float, eta_l: float):
    """The JAX oracle's math: (x', m') with ``ghat = -delta / eta_l``."""
    xf, df, mf = x.float(), delta.float(), m.float()
    ghat = -df / eta_l
    m_new = a * ghat + (1.0 - a) * mf
    x_new = xf + eta_g * df
    return x_new.to(x.dtype), m_new.to(m.dtype)


def _scalar(v, device) -> torch.Tensor:
    """``v`` (a float or a 0-dim tensor) as a 0-dim fp32 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        if v.dim() != 0:
            raise ValueError(f"expected a 0-dim scalar tensor, got shape {tuple(v.shape)}")
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), v, dtype=torch.float32, device=device)


def server_update_torch(x: torch.Tensor, d: torch.Tensor, m: torch.Tensor,
                        eta_g, a, inv_eta_l):
    """The kernel's math as separate torch ops: (x', m') with ``ghat =
    (-d) * inv_eta_l``.  ``eta_g``, ``a`` and ``inv_eta_l`` are floats or
    0-dim tensors, rounded to fp32."""
    dev = x.device
    eta, a_t, inv = _scalar(eta_g, dev), _scalar(a, dev), _scalar(inv_eta_l, dev)
    one_minus_a = torch.ones((), dtype=torch.float32, device=dev) - a_t
    df, mf = d.float(), m.float()
    ghat = torch.neg(df) * inv
    m_new = a_t * ghat + one_minus_a * mf
    x_new = x.float() + eta * df
    return x_new.to(x.dtype), m_new.to(m.dtype)
