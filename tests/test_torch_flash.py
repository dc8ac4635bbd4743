"""The PyTorch port's flash attention (``repro_torch.kernels.flash_attention``)
and its model attention (``repro_torch.models.attention.attend``) against
the JAX package's.

* the plain torch version (``flash_attention_torch``, what the CUDA kernel
  computes) vs JAX's Pallas kernel in interpret mode (``flash_attend(
  interpret=True)``) and its oracle (``reference_attend``), over the JAX
  test's sweep plus a group-of-5 windowed case, at the JAX tests'
  tolerances: 2e-5 in fp32 and 2e-2 in bf16 (the sums run in another order;
  bf16 keeps 8 bits of mantissa);
* the port's ``attend`` (the decode step's and the train loss's attention)
  vs JAX's ``attend`` with a window, a ``kv_valid`` mask and one query-
  chunked case above 2,048 queries, at 2e-5;
* the dispatch: a CPU tensor takes the plain version under
  ``backend="kernel"``, an input that requires a gradient raises;
* on a card (``cuda``-marked, skipped without one): the kernel vs the plain
  version at those tolerances, ragged T and strided inputs included.

All inputs are made with numpy from a seed; fp32 on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import flash_attend as j_flash  # noqa: E402
from repro.kernels.flash_attention.ops import reference_attend as j_reference  # noqa: E402
from repro.models.attention import attend as j_attend  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attend  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_torch  # noqa: E402
from repro_torch.models.attention import attend  # noqa: E402

SWEEP = [
    # B, T, H, KV, hd, window, bq (the JAX test's, then a group of 5 with a window)
    (1, 128, 4, 4, 32, 0, 64),
    (2, 256, 4, 2, 64, 0, 128),
    (1, 256, 8, 1, 64, 0, 64),     # MQA
    (1, 512, 4, 4, 32, 128, 128),  # sliding window
    (2, 128, 6, 3, 16, 64, 64),    # odd-ish heads
    (1, 256, 10, 2, 64, 96, 64),   # Hymba's group of 5, a window not a multiple of the tile
]


def _qkv(B, T, H, KV, hd, seed=0, Tk=None):
    r = np.random.default_rng(seed)
    Tk = T if Tk is None else Tk
    return (r.normal(size=(B, T, H, hd)).astype(np.float32),
            r.normal(size=(B, Tk, KV, hd)).astype(np.float32),
            r.normal(size=(B, Tk, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("B,T,H,KV,hd,window,bq", SWEEP)
def test_plain_matches_jax_kernel_and_oracle(B, T, H, KV, hd, window, bq):
    q, k, v = _qkv(B, T, H, KV, hd)
    got = flash_attend(*map(torch.from_numpy, (q, k, v)), window=window).numpy()
    pal = j_flash(q, k, v, causal=True, window=window, interpret=True, bq=bq, bk=bq)
    ref = j_reference(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(pal), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_plain_bf16_matches_jax_kernel():
    q, k, v = _qkv(1, 128, 4, 4, 32, seed=1)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = flash_attend(*tb, window=48)
    assert got.dtype == torch.bfloat16
    pal = j_flash(*jb, window=48, interpret=True, bq=64, bk=64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pal, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_plain_chunks_long_queries_without_changing_rows():
    """Above 2,048 queries the plain version goes 1,024 rows at a time."""
    q, k, v = _qkv(1, 2100, 2, 1, 8, seed=2)
    qt, kt, vt = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    got = flash_attention_torch(qt, kt, vt, window=300)
    want = j_reference(q, k, v, causal=True, window=300)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", ["window", "kv_valid", "chunked"])
def test_attend_matches_jax_attend(case):
    r = np.random.default_rng(3)
    B, H, KV, hd = 2, 4, 2, 16
    T = 2100 if case == "chunked" else 96
    q, k, v = _qkv(B, T, H, KV, hd, seed=4)
    q_pos = kv_pos = np.arange(T)
    kw = {}
    if case == "window":
        kw["window"] = 40
    if case == "kv_valid":   # a decode-like step: one query over a cache with holes
        q, q_pos = q[:, :1], np.array([T + 1])
        kw["kv_valid"] = r.random((B, T)) < 0.7
    if case == "chunked":
        kw["window"] = 500
    want = j_attend(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=True, **kw)
    tkw = {k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()}
    got = attend(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(q_pos),
                 torch.from_numpy(kv_pos), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_dispatch_cpu_takes_plain_and_autograd_raises():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 70, 4, 2, 16, seed=5))
    before = flash_attention_kernel.launches
    a = flash_attend(q, k, v, window=20)
    b = flash_attend(q, k, v, window=20, backend="ref")
    assert torch.equal(a, b) and flash_attention_kernel.launches == before
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attend(q.requires_grad_(), k, v)
    with torch.no_grad():
        flash_attend(q, k, v)
    with pytest.raises(ValueError, match="backend"):
        flash_attend(q.detach(), k, v, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q.detach().transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


CUDA_CASES = [
    # B, T, H, KV, hd, window, dtype
    (2, 2048, 25, 5, 64, 1024, "bfloat16"),   # Hymba's prefill, batch cut to 2
    (2, 2048, 25, 5, 64, 0, "float32"),
    (1, 77, 4, 4, 32, 0, "float32"),          # ragged T
    (1, 1000, 10, 2, 64, 100, "float32"),     # window not a multiple of the tile
    (1, 300, 8, 1, 128, 0, "bfloat16"),       # MQA, hd 128
    (2, 130, 6, 3, 16, 64, "float32"),        # hd 16
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,hd,window,dtype", CUDA_CASES)
def test_cuda_kernel_matches_plain(B, T, H, KV, hd, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(dev, tdt) for x in _qkv(B, T, H, KV, hd, seed=6))
    qkv = torch.cat([q, k.repeat(1, 1, H // KV, 1)], dim=2)   # strided q: a slice of it
    q_view = qkv[:, :, :H]
    before = flash_attention_kernel.launches
    got = flash_attend(q_view, k, v, window=window)
    want = flash_attend(q, k, v, window=window, backend="ref")
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=tol,
                               rtol=tol)
