"""Model-layout dispatch for flash attention (the JAX package's
``repro/kernels/flash_attention/ops.py``).

Models hold [B, T, H, hd] activations; the kernel takes [B, H, T, hd]
views of them.  ``backend="kernel"`` (the default): a CUDA tensor launches
the hand-written kernel (``kernel.py``) and nothing else, there is no
fallback; a CPU tensor takes the plain torch version
(``ref.flash_attention_torch``).  ``backend="ref"``: the plain version on
any device.  The kernel has no backward pass, so an input that requires a
gradient raises: the training loss never comes here.
"""
from __future__ import annotations

import torch

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
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if backend == "ref" or q.device.type == "cpu":
        out = flash_attention_torch(qt, kt, vt, causal=causal, window=window)
    elif q.device.type == "cuda":
        out = flash_attention_kernel(qt, kt, vt, causal=causal, window=window)
    else:
        raise ValueError(f"flash attention has no kernel for device {q.device}")
    return out.transpose(1, 2)

