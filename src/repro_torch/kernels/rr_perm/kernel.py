"""CUDA kernel wrapper: on-device stateless RR index generation.

Launches ``rr_indices_kernel`` from ``repro_torch/csrc/rr_perm.cu`` (built
with ``nvcc`` for ``sm_90a`` at first use, loaded with ``ctypes``) on the
current stream.  One thread per output element of the [C, K, B] int32 index
matrix; the source's header note gives the bound and the design.  Replaces
the Pallas kernel ``repro/kernels/rr_perm/kernel.py:rr_indices_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load

_MODES = {"rr": 0, "wr": 1}


def _lib() -> ctypes.CDLL:
    lib = load("rr_perm")
    fn = lib.rr_indices_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def rr_indices_kernel(prekey: torch.Tensor, sizes: torch.Tensor, spe: torch.Tensor,
                      *, B: int, K: int, rounds: int = 24, mode: str = "rr") -> torch.Tensor:
    """[C] int64 ``prekey`` (values in [0, 2^32)), [C] int32 ``sizes`` and
    ``spe`` on one CUDA device -> [C, K, B] int32 index matrix."""
    if mode not in _MODES:
        raise ValueError(f"unknown rr mode {mode!r}; have {tuple(_MODES)}")
    (C,) = prekey.shape
    dev = prekey.device
    for name, t, dt in (("prekey", prekey, torch.int64), ("sizes", sizes, torch.int32),
                        ("spe", spe, torch.int32)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if t.dtype != dt or t.shape != (C,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{C}] {dt} tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    # grid (C, tiles of 256 indices): the y dimension holds at most 65535 tiles
    if not (C >= 1 and K >= 1 and B >= 1 and rounds >= 0 and K * B <= 65535 * 256):
        raise ValueError(f"bad shape C={C} K={K} B={B} rounds={rounds}")
    lib = _lib()
    with torch.cuda.device(dev):
        out = torch.empty((C, K, B), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rr_indices_launch(prekey.data_ptr(), sizes.data_ptr(), spe.data_ptr(),
                                    out.data_ptr(), C, K, B, rounds, _MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"rr_indices_kernel launch failed: cudaError {err}")
    rr_indices_kernel.launches += 1
    return out


rr_indices_kernel.launches = 0   # launches so far; reset by the caller
