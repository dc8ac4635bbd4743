"""The PyTorch port's flash attention (``repro_torch.kernels.flash_attention``)
and its model attention (``repro_torch.models.attention.attend``) against
the JAX package's.

* the plain torch version (``flash_attention_torch``, what the CUDA kernel
  computes) vs JAX's Pallas kernel in interpret mode (``flash_attend(
  interpret=True)``) and its oracle (``reference_attend``), over the JAX
  test's sweep plus a group-of-5 windowed case, and in the non-causal mode
  (``causal=False``, which the JAX package's own tests never run) with Tq
  = Tk, Tq < Tk (256 x 1,024), Tq > Tk, GQA and a window, at the JAX
  tests' tolerances: 2e-5 in fp32 and 2e-2 in bf16 (the sums run in
  another order; bf16 keeps 8 bits of mantissa);
* inputs where a query row sees no key (i >= Tk - 1 + window) are refused,
  and the two JAX references disagree there (the Pallas kernel gives 0
  where it skips every key tile, the oracle the mean of v);
* the port's ``attend`` (the decode step's and the train loss's attention)
  vs JAX's ``attend`` with a window, a ``kv_valid`` mask, one query-
  chunked case above 2,048 queries and a non-causal one over a memory of
  another length (the decoder's cross-attention), at 2e-5;
* the dispatch: a CPU tensor takes the plain version under
  ``backend="kernel"``, an input that requires a gradient raises;
* the routing between the three CUDA kernels (``kernel.route``, decided
  from dtypes, strides, pointers and the mode, so it runs on CPU tensors):
  ``"wgmma"`` for the non-causal calls of SeamlessM4T-medium's encoder
  views and its cross-attention views (``cross_kv``), ``"mma"`` for the
  causal bf16 prefill views of Hymba-1.5B, Qwen1.5-0.5B and SeamlessM4T-
  medium as ``_qkv`` builds them, the bf16 stress shapes, a window and hd
  32 / 128, ``"simt"`` for f32, hd 48 and views misaligned for 16-byte
  copies; the ``ctypes`` argtypes against the C entry points' parameters
  in the CUDA source;
* ``flash_fwd_mma``'s arithmetic, emulated in torch here (tiles of 64
  keys, the online softmax in log2 units, p = p_hi + p_lo in bf16 through
  P·V, l from the fp32 p), vs the plain version and JAX's Pallas kernel in
  interpret mode within one bf16 step (1e-3 + 2^-7·|ref|, the bound the
  card holds the kernel to at the serving shape), over the windows and GQA
  groups of ``CUDA_CASES``, causal and not; and one bf16 rounding of p,
  which that bound must refuse;
* ``flash_fwd_wgmma``'s arithmetic (the same with 128-key tiles, non-
  causal) vs the plain version and the Pallas kernel within one bf16 step,
  on the non-causal shapes it takes, Tq and Tk off its tile, and rows that
  two keys carry with cancelling values; there one bf16 rounding of p
  leaves the bound (it holds on the random cases), which decides the
  kernel's two P·V products;
* on a card (``cuda``-marked, skipped without one): the kernel vs the plain
  version at those tolerances, causal and not, ragged T and Tk and strided
  inputs included, with the route each case took.

All inputs are made with numpy from a seed; fp32 on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import flash_attend as j_flash  # noqa: E402
from repro.kernels.flash_attention.ops import reference_attend as j_reference  # noqa: E402
from repro.models.attention import attend as j_attend  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    ARGTYPES, MMA_HDS, flash_attention_kernel, route)
from repro_torch.kernels.flash_attention.ops import flash_attend  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_torch  # noqa: E402
from repro_torch.models.attention import _qkv as t_qkv  # noqa: E402
from repro_torch.models.attention import attend, gqa_init  # noqa: E402
from repro_torch.models.blocks import cross_kv, dec_block_init  # noqa: E402

SWEEP = [
    # B, T, H, KV, hd, window, bq (the JAX test's, then a group of 5 with a window)
    (1, 128, 4, 4, 32, 0, 64),
    (2, 256, 4, 2, 64, 0, 128),
    (1, 256, 8, 1, 64, 0, 64),     # MQA
    (1, 512, 4, 4, 32, 128, 128),  # sliding window
    (2, 128, 6, 3, 16, 64, 64),    # odd-ish heads
    (1, 256, 10, 2, 64, 96, 64),   # Hymba's group of 5, a window not a multiple of the tile
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


NONCAUSAL = [
    # B, Tq, Tk, H, KV, hd, window, bq, bk
    (1, 128, 128, 4, 4, 32, 0, 64, 64),      # Tq = Tk (the encoder's self-attention)
    (1, 256, 1024, 2, 2, 16, 0, 128, 256),   # Tq < Tk: the cross-attention's 256 x 1,024
    (2, 128, 32, 4, 2, 32, 0, 64, 32),       # Tq > Tk (the reduced decoder over 32 frames), GQA
    (1, 256, 256, 8, 2, 32, 96, 64, 64),     # a window, a group of 4
    (1, 128, 64, 4, 4, 16, 80, 64, 64),      # Tq > Tk with a window: every row sees a key
]


@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,window,bq,bk", NONCAUSAL)
def test_plain_noncausal_matches_jax_kernel_and_oracle(B, Tq, Tk, H, KV, hd, window, bq, bk):
    q, k, v = _qkv(B, Tq, H, KV, hd, seed=8, Tk=Tk)
    got = flash_attend(*map(torch.from_numpy, (q, k, v)), causal=False, window=window).numpy()
    pal = j_flash(q, k, v, causal=False, window=window, interpret=True, bq=bq, bk=bk)
    ref = j_reference(q, k, v, causal=False, window=window)
    np.testing.assert_allclose(got, np.asarray(pal), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_plain_noncausal_bf16_matches_jax_kernel():
    q, k, v = _qkv(1, 128, 4, 2, 32, seed=9, Tk=256)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = flash_attend(*tb, causal=False)
    assert got.dtype == torch.bfloat16
    pal = j_flash(*jb, causal=False, interpret=True, bq=64, bk=64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pal, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_rows_that_see_no_key_are_refused(causal):
    """Tq 128 over Tk 32 keys with a window of 16: rows 47.. see no key."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 4, 2, 16, seed=10, Tk=32))
    for fn in (lambda: flash_attend(q, k, v, causal=causal, window=16),
               lambda: flash_attention_torch(*(x.transpose(1, 2) for x in (q, k, v)),
                                             causal=causal, window=16),
               lambda: flash_attention_kernel(*(x.transpose(1, 2) for x in (q, k, v)),
                                              causal=causal, window=16)):
        with pytest.raises(ValueError, match=r"rows 47\.\.127 see no key"):
            fn()
    flash_attend(q[:, :47], k, v, causal=causal, window=16)   # the last row that sees one
    with pytest.raises(ValueError, match="see no key"):
        flash_attend(q, k[:, :0], v[:, :0], causal=causal)


def test_jax_references_disagree_on_rows_that_see_no_key():
    """Why those inputs are refused: the Pallas kernel skips the key tiles
    of a query tile that sees none and returns 0 there; the oracle's
    softmax over -1e30 everywhere is uniform, the mean of v."""
    q, k, v = _qkv(1, 128, 4, 2, 16, seed=10, Tk=32)
    pal = np.asarray(j_flash(q, k, v, causal=False, window=16, interpret=True, bq=32, bk=32))
    ref = np.asarray(j_reference(q, k, v, causal=False, window=16))
    mean_v = np.repeat(v.mean(axis=1, keepdims=True), 2, axis=2)   # [1, 1, H, hd]
    np.testing.assert_array_equal(pal[:, 64:], 0.0)               # query tiles 2, 3 skipped
    np.testing.assert_allclose(ref[:, 47:], np.broadcast_to(mean_v, ref[:, 47:].shape),
                               atol=1e-6)
    np.testing.assert_allclose(pal[:, :47], ref[:, :47], atol=2e-5, rtol=2e-5)
    assert np.abs(pal[:, 64:] - ref[:, 64:]).max() > 0.05


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


@pytest.mark.parametrize("case", ["window", "kv_valid", "chunked", "noncausal"])
def test_attend_matches_jax_attend(case):
    r = np.random.default_rng(3)
    B, H, KV, hd = 2, 4, 2, 16
    T = 2100 if case == "chunked" else 96
    Tk = 40 if case == "noncausal" else T
    q, k, v = _qkv(B, T, H, KV, hd, seed=4, Tk=Tk)
    q_pos, kv_pos = np.arange(T), np.arange(Tk)
    kw = {}
    if case == "window":
        kw["window"] = 40
    if case == "kv_valid":   # a decode-like step: one query over a cache with holes
        q, q_pos = q[:, :1], np.array([T + 1])
        kw["kv_valid"] = r.random((B, T)) < 0.7
    if case == "chunked":
        kw["window"] = 500
    if case == "noncausal":  # cross-attention over a memory with holes
        kw["causal"], kw["kv_valid"] = False, r.random((B, Tk)) < 0.7
    want = j_attend(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos), **kw)
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


def _packed_views(b, t, h, kv, d, dtype, *, width=None, offset=0):
    """q, k, v as [B,H,T,hd] views of one packed [b, t, h + 2 kv, width]
    tensor (``width`` >= d; the head dim's first d of it), ``offset``
    elements into its storage, as the stress checks on the card build them."""
    width = width or d
    n = b * t * (h + 2 * kv) * width
    flat = torch.zeros(n + offset, dtype=dtype)[offset:]
    packed = flat.view(b, t, h + 2 * kv, width)[..., :d]
    return tuple(x.transpose(1, 2) for x in packed.split([h, kv, kv], dim=2))


def _prefill_views(arch: str, T: int = 8):
    """The [B,H,T,hd] views the prefill hands the kernel: ``_qkv`` of one
    layer of ``arch`` at full width, bf16 on the CPU."""
    cfg = get_arch(arch)
    gen = torch.Generator().manual_seed(0)
    p = gqa_init(gen, cfg, torch.bfloat16, "cpu")
    x = torch.randn((1, T, cfg.d_model), generator=gen).to(torch.bfloat16)
    return tuple(t.transpose(1, 2) for t in t_qkv(p, cfg, x, torch.arange(T)))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen1.5-0.5b", "seamless-m4t-medium"])
def test_route_takes_mma_for_the_prefill_views(arch):
    """The causal prefill's views take ``mma``; SeamlessM4T-medium's, which
    also serve its encoder's non-causal self-attention, take ``wgmma``
    there."""
    q, k, v = _prefill_views(arch)
    assert q.dtype == torch.bfloat16 and q.shape[-1] == 64
    assert route(q, k, v) == route(q, k, v, causal=True) == "mma"
    if arch == "seamless-m4t-medium":
        assert route(q, k, v, causal=False) == "wgmma"


def test_route_takes_mma_for_the_seamless_cross_views():
    """The decoder's cross-attention: q from ``_qkv`` over 8 prompt
    positions, k and v from ``cross_kv`` over 24 encoder frames (Tq != Tk)."""
    cfg = get_arch("seamless-m4t-medium")
    gen = torch.Generator().manual_seed(0)
    p = dec_block_init(gen, cfg, torch.bfloat16, "cpu", "blocks/0/")
    x = torch.randn((1, 8, cfg.d_model), generator=gen).to(torch.bfloat16)
    enc_out = torch.randn((1, 24, cfg.d_model), generator=gen).to(torch.bfloat16)
    cross = {name[len("blocks/0/cross/"):]: w for name, w in p.items() if "/cross/" in name}
    q = t_qkv(cross, cfg, x, torch.arange(8))[0].transpose(1, 2)
    k, v = (t.transpose(1, 2) for t in cross_kv(p, cfg, enc_out, "blocks/0/"))
    assert q.shape == (1, 16, 8, 64) and k.shape == v.shape == (1, 16, 24, 64)
    assert k.dtype == torch.bfloat16 and route(q, k, v, causal=False) == "wgmma"


def test_argtypes_match_the_c_entry_points():
    """Each ctypes argtype list against its extern "C" function's
    parameters in the CUDA source: one stale entry would shift every
    argument after it."""
    import ctypes
    import re
    from pathlib import Path

    import repro_torch

    src = (Path(repro_torch.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    assert sorted(ARGTYPES) == sorted(re.findall(r"^int (\w+)\(", src, re.M))
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "const long long*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    for name, argtypes in ARGTYPES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        want = [ctype[re.sub(r"\s*\w+$", "", p.strip())] for p in params.split(",")]
        assert argtypes == want, name


@pytest.mark.parametrize("b,t,h,kv,d", [(2, 1000, 10, 2, 64), (1, 300, 8, 1, 128)])
def test_route_takes_mma_for_bf16_stress_shapes(b, t, h, kv, d):
    assert route(*_packed_views(b, t, h, kv, d, torch.bfloat16)) == "mma"


@pytest.mark.parametrize("case", ["causal", "window", "hd32", "hd128"])
def test_route_keeps_mma_off_the_wgmma_inputs(case):
    """``wgmma`` takes only the non-causal mode without a window at hd 64:
    the causal mode, a window and the other head dims stay on ``mma``."""
    d = {"hd32": 32, "hd128": 128}.get(case, 64)
    q, k, v = _packed_views(1, 70, 8, 2, d, torch.bfloat16)
    kw = {"causal": dict(causal=True), "window": dict(causal=False, window=16)}.get(
        case, dict(causal=False))
    assert route(q, k, v, **kw) == "mma"


@pytest.mark.parametrize("case", ["float32", "hd48", "stride", "pointer"])
def test_route_takes_simt_otherwise(case):
    kw = {"float32": dict(dtype=torch.float32),
          "hd48": dict(d=48),
          "stride": dict(width=65),      # a time stride of 12 * 65 elements
          "pointer": dict(offset=4)}[case]   # 8 bytes into the storage
    args = dict(b=1, t=70, h=8, kv=2, d=64, dtype=torch.bfloat16) | kw
    q, k, v = _packed_views(args.pop("b"), args.pop("t"), args.pop("h"), args.pop("kv"),
                            args.pop("d"), args.pop("dtype"), **args)
    assert route(q, k, v) == route(q, k, v, causal=False) == "simt"


LOG2E = 1.4426950408889634
# the serving shape's bound on the card: one bf16 step, plus 1e-3 for the
# order of the fp32 sums (chip_smoke.py: FLASH_MAIN_BF16_ATOL / _RTOL)
STEP_ATOL, STEP_RTOL = 1e-3, 2.0 ** -7


def _emulate_mma(q, k, v, *, causal=True, window=0, split=True, bk=64):
    """``flash_fwd_mma``'s arithmetic on [B,H,T,hd] bf16 tensors: each
    64-row query tile visits the ``bk``-key tiles from its window's first
    to its causal last (to the last of Tk when not ``causal``); scores q.k
    in fp32 times scale·log2(e), -1e30 where masked; the running max m, p =
    2^(x - m) and l summed in fp32; O is rescaled and gains bf16(p)·V, and
    bf16(p - bf16(p))·V when ``split`` (the kernel's two products); O /
    max(l, 1e-30) rounded to bf16.  With ``bk=128`` and ``causal=False``
    it is ``flash_fwd_wgmma``'s (the query tiles play no part there: every
    row visits every key tile)."""
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    kf, vf = (x.float().repeat_interleave(H // KV, 1) for x in (k, v))
    sl2 = np.float32(1.0 / hd ** 0.5) * np.float32(LOG2E)
    out = torch.empty((B, H, Tq, hd))
    for q0 in range(0, Tq, 64):
        rows = torch.arange(q0, min(q0 + 64, Tq))[:, None]
        m = torch.full((B, H, len(rows), 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, len(rows), hd))
        first = max(0, q0 - window + 1) if window else 0
        last = min(Tk - 1, q0 + 63) if causal else Tk - 1
        for k0 in range(first // bk * bk, last + 1, bk):
            keys = torch.arange(k0, min(k0 + bk, Tk))[None, :]
            x = q[:, :, q0:q0 + 64].float() @ kf[:, :, k0:k0 + bk].transpose(-1, -2) * sl2
            ok = keys <= rows if causal else torch.ones_like(keys <= rows)
            if window:
                ok = ok & (rows - keys < window)
            x = torch.where(ok, x, -1e30)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            m = m_new
            p = torch.exp2(x - m)
            l = l * corr + p.sum(-1, keepdim=True)
            hi = p.bfloat16().float()
            pv = hi @ vf[:, :, k0:k0 + bk]
            if split:
                pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + bk]
            acc = acc * corr + pv
        out[:, :, q0:q0 + 64] = acc / l.clamp_min(1e-30)
    return out.to(torch.bfloat16)


EMU_CASES = [
    # B, T, H, KV, hd, window: the windows and GQA groups of CUDA_CASES
    (1, 1152, 5, 1, 64, 1024),   # Hymba's group of 5 and window
    (1, 256, 5, 1, 64, 0),
    (1, 128, 4, 4, 32, 0),
    (1, 512, 10, 2, 64, 100),
    (1, 192, 8, 1, 128, 0),
    (2, 192, 6, 3, 16, 64),
    (1, 384, 6, 2, 32, 70),
    (1, 256, 4, 2, 64, 50),
]


def _bf16_inputs(B, T, H, KV, hd, seed, Tk=None):
    q, k, v = _qkv(B, T, H, KV, hd, seed=seed, Tk=Tk)
    return ([torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2) for x in (q, k, v)],
            [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)])


@pytest.mark.parametrize("B,T,H,KV,hd,window", EMU_CASES)
def test_mma_numerics_within_one_bf16_step(B, T, H, KV, hd, window):
    tb, jb = _bf16_inputs(B, T, H, KV, hd, seed=7)
    got = _emulate_mma(*tb, window=window).float().transpose(1, 2).numpy()
    ref = flash_attention_torch(*tb, window=window).float().transpose(1, 2).numpy()
    pal = np.asarray(j_flash(*jb, window=window, interpret=True, bq=64, bk=64), np.float32)
    np.testing.assert_allclose(got, ref, atol=STEP_ATOL, rtol=STEP_RTOL)
    np.testing.assert_allclose(got, pal, atol=STEP_ATOL, rtol=STEP_RTOL)


NONCAUSAL_EMU_CASES = [
    # B, Tq, Tk, H, KV, hd, window: the non-causal shapes of CUDA_CASES
    (1, 256, 1024, 4, 4, 64, 0),    # SeamlessM4T's cross-attention, 4 of its 16 heads
    (1, 256, 256, 4, 4, 64, 0),     # its encoder's self-attention
    (1, 128, 32, 4, 2, 32, 0),      # Tq > Tk: one ragged key tile
    (1, 192, 320, 6, 3, 64, 100),   # a window
    (1, 128, 192, 8, 1, 128, 0),    # MQA, hd 128
]


@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,window", NONCAUSAL_EMU_CASES)
def test_mma_noncausal_numerics_within_one_bf16_step(B, Tq, Tk, H, KV, hd, window):
    tb, jb = _bf16_inputs(B, Tq, H, KV, hd, seed=11, Tk=Tk)
    got = _emulate_mma(*tb, causal=False, window=window).float().transpose(1, 2).numpy()
    ref = flash_attention_torch(*tb, causal=False, window=window).float().transpose(1, 2).numpy()
    pal = np.asarray(j_flash(*jb, causal=False, window=window, interpret=True, bq=64,
                             bk=min(64, Tk)), np.float32)
    np.testing.assert_allclose(got, ref, atol=STEP_ATOL, rtol=STEP_RTOL)
    np.testing.assert_allclose(got, pal, atol=STEP_ATOL, rtol=STEP_RTOL)


def _dominated_inputs(seed, B=1, Tq=256, Tk=1024, H=4, hd=64):
    """bf16 [B,H,T,hd] inputs where two keys carry each row and their values
    cancel: q row i is 8·e_c (c = i % hd), so its scores are column c of k;
    in each head, column c holds 20 at key a_c and 19.5 at key b_c > a_c
    (p = e^-0.5 ≈ 0.6065 against the max, not a bf16 number) and N(0, 1)
    elsewhere (weights ~e^-20); v_b = bf16(-v_a / e^-0.5), so the output is
    ~0 and one bf16 rounding of p_b (2^-9.2 relative) moves it by ~6.6e-4
    |v_b|.  a_c and b_c lie in one 128-key tile or in two, a first."""
    r = np.random.default_rng(seed)
    q = np.zeros((B, H, Tq, hd), np.float32)
    q[..., np.arange(Tq), np.arange(Tq) % hd] = 8.0
    k = r.normal(size=(B, H, Tk, hd)).astype(np.float32)
    v = r.normal(size=(B, H, Tk, hd)).astype(np.float32)
    for b in range(B):
        for h in range(H):
            keys = r.permutation(Tk)[:2 * hd].reshape(hd, 2)
            keys.sort(axis=1)
            for c, (a, bb) in enumerate(keys):
                k[b, h, a, c], k[b, h, bb, c] = 20.0, 19.5
                v[b, h, a] = 2.0 * r.normal(size=hd)
                v[b, h, bb] = -v[b, h, a] / np.exp(-0.5)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    jb = [jnp.asarray(x.transpose(0, 2, 1, 3)).astype(jnp.bfloat16) for x in (q, k, v)]
    return tb, jb


# the non-causal emulation cases of flash_fwd_wgmma: NONCAUSAL_EMU_CASES'
# shapes it takes (no window, hd 64), Tq and Tk off its 128-key tile, and
# the dominated rows
WGMMA_EMU_CASES = [c[:6] for c in NONCAUSAL_EMU_CASES if c[5] == 64 and c[6] == 0] + [
    (1, 200, 1000, 4, 2, 64),
    (1, 1, 129, 4, 4, 64),
    "dominated",
]


def _wgmma_case(case):
    if case == "dominated":
        return _dominated_inputs(12)
    B, Tq, Tk, H, KV, hd = case
    return _bf16_inputs(B, Tq, H, KV, hd, seed=13, Tk=Tk)


@pytest.mark.parametrize("case", WGMMA_EMU_CASES, ids=str)
def test_wgmma_numerics_within_one_bf16_step(case):
    """``flash_fwd_wgmma``'s arithmetic (128-key tiles, p = p_hi + p_lo)
    within one bf16 step of the plain version and of JAX's Pallas kernel in
    interpret mode (which keeps p in fp32)."""
    tb, jb = _wgmma_case(case)
    got = _emulate_mma(*tb, causal=False, bk=128).float().transpose(1, 2).numpy()
    ref = flash_attention_torch(*tb, causal=False).float().transpose(1, 2).numpy()
    Tq, Tk = tb[0].shape[2], tb[1].shape[2]   # the Pallas grid wants whole tiles
    pal = np.asarray(j_flash(*jb, causal=False, interpret=True, bq=64 if Tq % 64 == 0 else Tq,
                             bk=128 if Tk % 128 == 0 else Tk), np.float32)
    np.testing.assert_allclose(got, ref, atol=STEP_ATOL, rtol=STEP_RTOL)
    np.testing.assert_allclose(got, pal, atol=STEP_ATOL, rtol=STEP_RTOL)


def test_wgmma_keeps_p_in_two_bf16_parts():
    """The decision for ``flash_fwd_wgmma``: one bf16 rounding of p holds
    the one-step bound on the random non-causal cases but not where two
    keys carry a row and their values cancel, so the kernel keeps P_hi +
    P_lo (two register-A wgmma products), which holds it there too."""
    for case in WGMMA_EMU_CASES[:-1]:
        tb, _ = _wgmma_case(case)
        ref = flash_attention_torch(*tb, causal=False).float()
        once = (_emulate_mma(*tb, causal=False, bk=128, split=False).float() - ref).abs()
        assert int((once > STEP_ATOL + STEP_RTOL * ref.abs()).sum()) == 0, case
    tb, _ = _dominated_inputs(12)
    ref = flash_attention_torch(*tb, causal=False).float()
    bound = STEP_ATOL + STEP_RTOL * ref.abs()
    once = (_emulate_mma(*tb, causal=False, bk=128, split=False).float() - ref).abs()
    split = (_emulate_mma(*tb, causal=False, bk=128).float() - ref).abs()
    assert int((once > bound).sum()) > 0
    assert int((split > bound).sum()) == 0


def test_one_bf16_rounding_of_p_leaves_the_one_step_bound():
    """Why the kernel splits p: rounded once to bf16, a p near 1 of a row's
    dominant key (the first rows of a causal prefill) moves its output by up
    to 2^-9·|v|, and the bound the card holds the kernel to refuses it."""
    tb, _ = _bf16_inputs(1, 256, 4, 2, 64, seed=7)
    ref = flash_attention_torch(*tb, window=0).float()
    bound = STEP_ATOL + STEP_RTOL * ref.abs()
    once = (_emulate_mma(*tb, split=False).float() - ref).abs()
    split = (_emulate_mma(*tb).float() - ref).abs()
    assert int((once > bound).sum()) > 0
    assert int((split > bound).sum()) == 0


CUDA_CASES = [
    # B, T, H, KV, hd, window, dtype, then Tk (None: T) and causal
    (2, 2048, 25, 5, 64, 1024, "bfloat16", None, True),   # Hymba's prefill, batch cut to 2
    (2, 2048, 25, 5, 64, 0, "float32", None, True),
    (1, 77, 4, 4, 32, 0, "float32", None, True),          # ragged T
    (1, 1000, 10, 2, 64, 100, "float32", None, True),     # window not a multiple of the tile
    (1, 300, 8, 1, 128, 0, "bfloat16", None, True),       # MQA, hd 128
    (2, 130, 6, 3, 16, 64, "float32", None, True),        # hd 16
    (1, 333, 6, 2, 32, 70, "bfloat16", None, True),       # the mma route: ragged T, hd 32
    (1, 200, 4, 2, 48, 50, "bfloat16", None, True),       # the simt route in bf16: hd 48
    (2, 1024, 16, 16, 64, 0, "bfloat16", None, False),    # SeamlessM4T's encoder, batch cut to 2
    (2, 256, 16, 16, 64, 0, "bfloat16", 1024, False),     # its cross-attention: Tq < Tk
    (2, 256, 16, 16, 64, 0, "float32", 1024, False),
    (1, 128, 4, 2, 32, 0, "bfloat16", 77, False),         # Tq > Tk, ragged Tk
    (1, 300, 6, 3, 64, 100, "float32", 1000, False),      # a window, not causal
    (1, 300, 6, 3, 64, 100, "bfloat16", 1000, False),
    (1, 200, 4, 2, 64, 0, "bfloat16", 1000, False),      # the wgmma route: ragged Tq and Tk
    (1, 1, 4, 4, 64, 0, "bfloat16", 129, False),         # one query over 1 + 128 keys
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,hd,window,dtype,Tk,causal", CUDA_CASES)
def test_cuda_kernel_matches_plain(B, T, H, KV, hd, window, dtype, Tk, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(dev, tdt) for x in _qkv(B, T, H, KV, hd, seed=6, Tk=Tk))
    qkv = torch.cat([q, q], dim=2)   # strided q: a slice of it
    q_view = qkv[:, :, :H]
    want_route = ("simt" if dtype != "bfloat16" or hd not in MMA_HDS
                  else "wgmma" if not causal and not window and hd == 64 else "mma")
    before = flash_attention_kernel.launches
    by_route = dict(flash_attention_kernel.route_launches)
    got = flash_attend(q_view, k, v, causal=causal, window=window)
    want = flash_attend(q, k, v, causal=causal, window=window, backend="ref")
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    assert {r: n - by_route[r] for r, n in flash_attention_kernel.route_launches.items()} == {
        r: int(r == want_route) for r in by_route}
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=tol,
                               rtol=tol)
