"""CUDA kernel wrapper: the Mamba2 SSD intra-chunk step.

Launches one of two kernels of ``repro_torch/csrc/ssd.cu`` (built with
``nvcc`` for ``sm_90a`` at first use, loaded with ``ctypes``) on the
current stream: ``ssd_intra_chunk_mma`` (bf16 on the ``mma.sync`` tensor
cores, one block per 64-row tile of the chunk, head, chunk and batch) where
:func:`route` says ``"mma"``, else ``ssd_intra_chunk`` (fp32 sums on the
CUDA cores, one block per head, chunk and batch).  The source's header note
gives the bound and both designs.  Replaces the Pallas kernel
``repro/kernels/ssd/kernel.py:ssd_intra_chunk``.  On the ``simt`` route a
tile whose shared memory exceeds what a block of the card may have raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load

DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("mma", "simt")
MMA_P = 64                      # ssd_intra_chunk_mma's head dim
MMA_NS = (16, 128)              # its state dims: Hymba's and mamba2-1.3b's
MMA_TILE, MMA_MAX_Q = 64, 256   # its chunk lengths: multiples of the tile up to the max


def _lib() -> ctypes.CDLL:
    lib = load("ssd")
    fn = lib.ssd_intra_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.ssd_intra_chunk_mma_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_smem_bytes.restype = ctypes.c_longlong
    return lib


def route(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor) -> str:
    """Which kernel takes these inputs: ``"mma"`` for bf16 xdt, B and C and
    f32 a, with P 64, N 16 or 128 and Q 64, 128, 192 or 256,
    whose data pointers and row strides are 16-byte aligned
    (``ssd_intra_chunk_mma`` copies 16 bytes at a time); ``"simt"``
    (``ssd_intra_chunk``) for everything else, f32 above all.  Decided from
    dtypes, shapes, strides and pointers alone, before any launch; the
    device plays no part."""
    Q, P, N = xdt.shape[2], xdt.shape[-1], Bm.shape[-1]
    if (a.dtype != torch.float32 or P != MMA_P or N not in MMA_NS or Q % MMA_TILE
            or not MMA_TILE <= Q <= MMA_MAX_Q):
        return "simt"
    for t in (xdt, Bm, Cm):
        if (t.dtype != torch.bfloat16 or t.data_ptr() % 16 or t.stride(-1) != 1
                or any(s % 8 for s in t.stride()[:-1])):
            return "simt"
    return "mma"


def ssd_intra_chunk_kernel(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                           Cm: torch.Tensor, *, kernel: str | None = None):
    """xdt [Bz,nc,Q,H,P] (f32 or bf16); a [Bz,nc,Q,H] f32; Bm/Cm [Bz,nc,Q,N]
    (f32 or bf16, one dtype); contiguous, on one CUDA device -> (y_intra
    [Bz,nc,Q,H,P], S_local [Bz,nc,H,P,N]), both fp32.

    The kernel is :func:`route`'s choice; ``kernel`` names one instead (to
    time ``"simt"`` on the inputs ``"mma"`` takes), and ``"mma"`` on inputs
    it does not take raises."""
    Bz, nc, Q, H, P = xdt.shape
    N = Bm.shape[-1]
    dev = xdt.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_intra_chunk_kernel needs CUDA tensors, got {dev}")
    for name, t, dtypes, shape in (("xdt", xdt, DTYPES, (Bz, nc, Q, H, P)),
                                   ("a", a, (torch.float32,), (Bz, nc, Q, H)),
                                   ("Bm", Bm, DTYPES, (Bz, nc, Q, N)),
                                   ("Cm", Cm, (Bm.dtype,), (Bz, nc, Q, N))):
        if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {list(shape)} tensor of "
                             f"{[str(d) for d in dtypes]} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if max(nc, Bz) > 65535:
        raise ValueError(f"chunks {nc} and batch {Bz} must be <= 65535 (grid dims)")
    chosen = route(xdt, a, Bm, Cm)
    if kernel is not None:
        if kernel not in ROUTES or (kernel == "mma" and chosen != "mma"):
            raise ValueError(f"kernel {kernel!r} cannot take these inputs (route: {chosen!r})")
        chosen = kernel
    y = torch.empty((Bz, nc, Q, H, P), dtype=torch.float32, device=dev)
    s = torch.empty((Bz, nc, H, P, N), dtype=torch.float32, device=dev)
    args = (xdt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
            s.data_ptr(), Bz, nc, Q, H, P, N)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if chosen == "mma":
            err = lib.ssd_intra_chunk_mma_launch(*args, stream)
        else:
            err = lib.ssd_intra_chunk_launch(*args, int(xdt.dtype == torch.bfloat16),
                                             int(Bm.dtype == torch.bfloat16), stream)
    if err == -1:   # the simt tile exceeds a block's shared memory
        raise ValueError(f"ssd_intra_chunk_kernel: the (Q {Q}, P {P}, N {N}) tile needs "
                         f"{lib.ssd_smem_bytes(Q, P, N)} bytes of shared memory, more than "
                         f"a block of {torch.cuda.get_device_name(dev)} may have")
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk_kernel ({chosen}) launch failed: cudaError {err}")
    ssd_intra_chunk_kernel.launches += 1
    ssd_intra_chunk_kernel.route_launches[chosen] += 1
    return y, s


ssd_intra_chunk_kernel.launches = 0   # launches so far; reset by the caller
ssd_intra_chunk_kernel.route_launches = dict.fromkeys(ROUTES, 0)   # the same, by kernel
