"""Dispatch for on-device RR index generation, by the tensors' device.

A CUDA tensor launches the hand-written kernel (``kernel.py``) and nothing
else: there is no fallback.  A CPU tensor takes the plain torch version
(``ref.rr_indices_torch``), which computes the same bits.
"""
from __future__ import annotations

import torch

from .kernel import rr_indices_kernel
from .ref import rr_indices_torch


def rr_indices(prekey: torch.Tensor, sizes: torch.Tensor, spe: torch.Tensor, *,
               B: int, K: int, rounds: int = 24, mode: str = "rr") -> torch.Tensor:
    """[C, K, B] int32 index matrices; see ``ref.rr_indices`` for semantics."""
    if prekey.device.type == "cuda":
        return rr_indices_kernel(prekey, sizes, spe, B=B, K=K, rounds=rounds, mode=mode)
    if prekey.device.type == "cpu":
        return rr_indices_torch(prekey, sizes, spe, B, K, rounds=rounds, mode=mode)
    raise ValueError(f"rr_indices has no kernel for device {prekey.device}")
