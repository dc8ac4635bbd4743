"""Dispatch for the fused App. F server update over the port's flat dicts.

CUDA tensors launch the hand-written kernel (``kernel.py``) once for the
whole dict and nothing else: there is no fallback.  CPU tensors take the
plain torch version (``ref.server_update_torch``), which computes the same
bits, tensor by tensor.  A dict whose tensors lie on more than one device
raises.
"""
from __future__ import annotations

import torch

from .kernel import server_update_kernel
from .ref import server_update_torch


def apply_fused_update(params: dict, delta: dict, momentum: dict, *, eta_g: float, a: float,
                       inv_eta_l) -> tuple[dict, dict]:
    """(x', m') = kernel(x, Delta, m) for every tensor of ``params``; ``delta``
    is cast to each tensor's dtype (as the JAX wrapper does), ``momentum`` is
    f32.  ``inv_eta_l`` is a float or a 0-dim tensor (on the params' device
    for the kernel).  Returns new dicts; the inputs are not written."""
    names = list(params)
    xs = [params[k] for k in names]
    ds = [delta[k].to(params[k].dtype).contiguous() for k in names]
    ms = [momentum[k] for k in names]
    devices = {t.device for t in xs + ds + ms}
    if isinstance(inv_eta_l, torch.Tensor):
        devices.add(inv_eta_l.device)
    if len(devices) != 1:
        raise ValueError("apply_fused_update needs all its tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cuda":
        inv = inv_eta_l if isinstance(inv_eta_l, torch.Tensor) else torch.full(
            (), inv_eta_l, dtype=torch.float32, device=dev)
        x_new, m_new = server_update_kernel(xs, ds, ms, eta_g=eta_g, a=a, inv_eta_l=inv)
    elif dev.type == "cpu":
        pairs = [server_update_torch(x, d, m, eta_g, a, inv_eta_l) for x, d, m in zip(xs, ds, ms)]
        x_new, m_new = [p[0] for p in pairs], [p[1] for p in pairs]
    else:
        raise ValueError(f"apply_fused_update has no kernel for device {dev}")
    return dict(zip(names, x_new)), dict(zip(names, m_new))
