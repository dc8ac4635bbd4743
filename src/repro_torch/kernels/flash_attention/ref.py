"""Flash attention's plain torch version: the port's copy of the JAX
package's oracle ``repro/kernels/flash_attention/ref.py:attention_ref``.

Scores in fp32 (``q . k * scale``, ``scale = 1 / sqrt(hd)``), -1e30 where
the causal or window mask hides a key, an fp32 softmax over every key,
``p @ v`` in fp32, cast to q's dtype at the end.  Causal (query i sees the
keys j <= i) unless ``causal=False``, which drops that mask: the audio
encoder's self-attention and the decoder's cross-attention over the
encoder memory, where Tq may differ from Tk.  The CUDA kernel
(``csrc/flash_attention.cu``) computes the same function with an online
softmax over key tiles, so the two agree to rounding (the sums run in
another order), not bitwise.  Queries are taken ``Q_CHUNK`` rows at a time
above ``CHUNK_THRESHOLD`` rows, which bounds the fp32 score tensor and,
since each row's softmax is its own, does not change a result.

A query row that sees no key has no answer the references agree on (the
oracle returns the mean of v, the TPU kernel 0 where it skips the row's
every key tile), so :func:`check_every_row_sees_a_key` refuses such inputs
for this version and the kernel alike.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
CHUNK_THRESHOLD = 2048
Q_CHUNK = 1024


def check_every_row_sees_a_key(Tq: int, Tk: int, window: int) -> None:
    """Raise ``ValueError`` if a query row would see no key.  Row i sees key
    Tk - 1 unless i - (Tk - 1) >= window, causal or not (a causal row sees
    min(i, Tk - 1), which the window cuts off the same way), so the rows
    i >= Tk - 1 + window see none, and with Tk == 0 no row sees one."""
    if Tq > 0 and (Tk == 0 or (window and Tq >= Tk + window)):
        raise ValueError(
            f"query rows {max(0, Tk - 1 + window)}..{Tq - 1} see no key (Tk {Tk}, window "
            f"{window}): the oracle returns the mean of v there and the TPU kernel 0, so "
            f"there is no answer to hold a kernel to")


def _rows(q, k, v, q0: int, *, causal: bool, window: int):
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    g = H // KV
    qg = q.reshape(B, KV, g, Tq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) / (hd ** 0.5)
    qpos = torch.arange(q0, q0 + Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = qpos >= kpos if causal else torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if window:
        mask = mask & (qpos - kpos < window)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(B, H, Tq, hd).to(q.dtype)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,H,Tq,hd]; k,v [B,KV,Tk,hd] with H % KV == 0 -> [B,H,Tq,hd] in
    q's dtype (fp32 softmax): query i at position i sees the keys j <= i
    when ``causal``, every key otherwise, and only those with i - j <
    window when ``window``."""
    Tq = q.shape[2]
    check_every_row_sees_a_key(Tq, k.shape[2], window)
    if Tq <= CHUNK_THRESHOLD:
        return _rows(q, k, v, 0, causal=causal, window=window)
    return torch.cat([_rows(q[:, :, q0:q0 + Q_CHUNK], k, v, q0, causal=causal, window=window)
                      for q0 in range(0, Tq, Q_CHUNK)], dim=2)
