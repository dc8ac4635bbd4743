"""The PyTorch port's SSD (``repro_torch.kernels.ssd``) and Mamba2 mixer
(``repro_torch.models.mamba2``) against the JAX package's.

* the plain intra-chunk version (``ssd_intra_chunk_torch``, what the CUDA
  kernel computes) vs JAX's Pallas ``ssd_intra_chunk`` in interpret mode
  over the JAX test's sweep;
* ``ssd_scan`` (intra-chunk + the cross-chunk recurrence) vs the sequential
  oracle ``ssd_ref``, the port's copy and JAX's, over the sweep; a nonzero
  initial state; a ragged last chunk (the port pads it; JAX asserts);
* strong decay (a = -2 over a 64-step chunk): the port stays finite and
  equals ``ssd_ref`` (JAX's Pallas kernel and ``ssd_chunked`` exponentiate
  before masking and return NaN there);
* ``mamba2_forward`` (prefill, its decode cache) and ``mamba2_decode`` vs
  JAX's at the init-scale decay;
* the routing between the kernel's two routes (``route``, on CPU tensors):
  ``mma`` = ``ssd_intra_chunk_mma``, bf16 on the tensor cores at Hymba's
  and mamba2-1.3b's tiles, and ``simt`` = ``ssd_intra_chunk`` for the rest,
  f32 above all;
* a torch emulation of ``ssd_intra_chunk_mma``'s arithmetic (bf16
  operands, fp32 sums of 16-wide k steps, L split into bf16 parts, two at
  N 16 and three above, dec·B into two, cum in fp64, the select before the
  exp) vs JAX's Pallas kernel over the sweep and vs the plain version at
  Q 128 / N 16 and Q 256 / N 128; both vs the same step computed in fp64
  throughout; strong decay through it; what leaves the bound: one bf16 L,
  two bf16 parts of L at mamba2-1.3b's full tile, cum summed in fp32 step
  by step (against the plain version and against fp64);
* on a card (``cuda``-marked, skipped without one): the kernel vs the plain
  version, each case on its route, and the f32 tile that exceeds a block's
  shared memory raises.

Tolerance: the JAX test's atol 3e-5 / rtol 3e-4 (fp32; the chunked form
sums in another order than the recurrence).  Inputs from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import ARCHS  # noqa: E402
from repro.kernels.ssd.kernel import ssd_intra_chunk as j_intra  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro_torch.configs.base import ArchConfig, SSMConfig  # noqa: E402
from repro_torch.kernels.ssd.kernel import route, ssd_intra_chunk_kernel  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_intra_chunk, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_torch, ssd_ref  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.utils.pytree import flatten, to_torch  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-4)
SWEEP = [
    # B, T, H, P, N, chunk, hb (the JAX test's)
    (1, 64, 4, 8, 16, 32, 4),
    (2, 128, 8, 16, 32, 32, 4),
    (1, 256, 4, 32, 16, 64, 2),
    (2, 96, 6, 8, 8, 32, 3),
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


def _inputs(B, T, H, P, N, seed=0, decay=None):
    r = np.random.default_rng(seed)
    xdt = (r.normal(size=(B, T, H, P)) * 0.5).astype(np.float32)
    a = (-np.logaddexp(r.normal(size=(B, T, H)), 0.0)).astype(np.float32)   # -softplus
    if decay is not None:
        a = np.full((B, T, H), decay, np.float32)
    Bm = (r.normal(size=(B, T, N)) * 0.5).astype(np.float32)
    Cm = (r.normal(size=(B, T, N)) * 0.5).astype(np.float32)
    return xdt, a, Bm, Cm


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("B,T,H,P,N,chunk,hb", SWEEP)
def test_plain_intra_chunk_matches_jax_kernel(B, T, H, P, N, chunk, hb):
    xdt, a, Bm, Cm = _inputs(B, T, H, P, N)
    nc = T // chunk
    shaped = (xdt.reshape(B, nc, chunk, H, P), a.reshape(B, nc, chunk, H),
              Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N))
    y, s = ssd_intra_chunk_torch(*_t(*shaped))
    jy, js = j_intra(*shaped, hb=hb, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("B,T,H,P,N,chunk,hb", SWEEP)
def test_scan_matches_recurrence(B, T, H, P, N, chunk, hb):
    xdt, a, Bm, Cm = _inputs(B, T, H, P, N)
    y, S = ssd_scan(*_t(xdt, a, Bm, Cm), chunk)
    ry, rS = ssd_ref(*_t(xdt, a, Bm, Cm))
    jy, jS = j_ssd_ref(xdt, a, Bm, Cm)
    for got, want in ((y, ry), (S, rS), (y, jy), (S, jS)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scan_initial_state_threading_and_ragged_chunk():
    xdt, a, Bm, Cm = _inputs(1, 128, 4, 8, 16, seed=1)
    y_full, S_full = ssd_ref(*_t(xdt, a, Bm, Cm))
    _, S_half = ssd_ref(*_t(xdt[:, :64], a[:, :64], Bm[:, :64], Cm[:, :64]))
    y2, S2 = ssd_scan(*_t(xdt[:, 64:], a[:, 64:], Bm[:, 64:], Cm[:, 64:]), 32, state0=S_half)
    np.testing.assert_allclose(y2.numpy(), y_full[:, 64:].numpy(), **TOL)
    np.testing.assert_allclose(S2.numpy(), S_full.numpy(), **TOL)
    # 100 steps in chunks of 32: the last chunk is padded with state-preserving steps
    y3, S3 = ssd_scan(*_t(xdt[:, :100], a[:, :100], Bm[:, :100], Cm[:, :100]), 32)
    r3, rS3 = ssd_ref(*_t(xdt[:, :100], a[:, :100], Bm[:, :100], Cm[:, :100]))
    np.testing.assert_allclose(y3.numpy(), r3.numpy(), **TOL)
    np.testing.assert_allclose(S3.numpy(), rS3.numpy(), **TOL)


def test_strong_decay_is_finite_and_equals_recurrence():
    xdt, a, Bm, Cm = _inputs(2, 128, 4, 16, 16, seed=2, decay=-2.0)
    y, S = ssd_scan(*_t(xdt, a, Bm, Cm), 64)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    jy, jS = j_ssd_ref(xdt, a, Bm, Cm)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **TOL)
    yi, si = ssd_intra_chunk(*_t(xdt.reshape(2, 2, 64, 4, 16), a.reshape(2, 2, 64, 4),
                                 Bm.reshape(2, 2, 64, 16), Cm.reshape(2, 2, 64, 16)))
    assert torch.isfinite(yi).all() and torch.isfinite(si).all()


def _mixer_setup(seed=0):
    jcfg = ARCHS["hymba-1.5b"].reduced()
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    d = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields}
    cfg = ArchConfig(**(d | {"ssm": SSMConfig(**d["ssm"])}))
    jp = jm2.mamba2_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, cfg, jp, to_torch(flatten(jax.tree.map(np.asarray, jp)), "cpu")


def test_mamba2_forward_and_decode_match_jax():
    jcfg, cfg, jp, p = _mixer_setup()
    x = (np.random.default_rng(3).normal(size=(2, 67, cfg.d_model)) * 0.5).astype(np.float32)
    T = 64
    jy, jc = jm2.mamba2_forward(jp, jcfg, x[:, :T])
    with torch.inference_mode():
        y, c = mamba2.mamba2_forward(p, cfg, torch.from_numpy(x[:, :T]))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in ("state", "conv"):
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), **TOL)
    for t in range(T, x.shape[1]):
        jy, jc = jm2.mamba2_decode(jp, jcfg, x[:, t:t + 1], jc)
        with torch.inference_mode():
            y, c = mamba2.mamba2_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]), c)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(c["state"].numpy(), np.asarray(jc["state"]), **TOL)


def _chunked(xdt, a, Bm, Cm, Bz, nc):
    """The [B, T, ...] arrays of :func:`_inputs` cut into chunks."""
    Q = xdt.shape[1] // nc
    return (xdt.reshape(Bz, nc, Q, *xdt.shape[2:]), a.reshape(Bz, nc, Q, a.shape[-1]),
            Bm.reshape(Bz, nc, Q, -1), Cm.reshape(Bz, nc, Q, -1))


def _zeros(shape, dtype, offset=0):
    """A contiguous zero tensor whose data starts ``offset`` elements into
    its storage (offset 1 of bf16: rows 2 bytes off 16-byte alignment)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def _route_args(Bz, nc, Q, H, P, N, dtype=torch.bfloat16, offset=0):
    return (_zeros((Bz, nc, Q, H, P), dtype, offset), _zeros((Bz, nc, Q, H), torch.float32),
            _zeros((Bz, nc, Q, N), dtype, offset), _zeros((Bz, nc, Q, N), dtype, offset))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-1.3b"])
def test_route_takes_mma_for_the_bf16_tiles(arch):
    ssm = ARCHS[arch].ssm
    Q, P, N = ssm.chunk, ssm.head_dim, ssm.state_dim
    assert (Q, P, N) == {"hymba-1.5b": (128, 64, 16), "mamba2-1.3b": (256, 64, 128)}[arch]
    assert route(*_route_args(2, 3, Q, 4, P, N)) == "mma"


@pytest.mark.parametrize("case", ["float32", "pointer", "P32", "N24", "N32", "N64", "Q96",
                                  "Q32", "Q320", "Q2048"])
def test_route_takes_simt_otherwise(case):
    kw = {"float32": dict(dtype=torch.float32), "pointer": dict(offset=1),
          "P32": dict(P=32), "N24": dict(N=24), "N32": dict(N=32), "N64": dict(N=64),
          "Q96": dict(Q=96), "Q32": dict(Q=32), "Q320": dict(Q=320),
          "Q2048": dict(Q=2048)}[case]
    args = dict(Bz=1, nc=2, Q=128, H=3, P=64, N=16) | kw
    assert route(*_route_args(**args)) == "simt"


def _ksum(lhs, rhs):
    """lhs [..., M, K] @ rhs [..., K, N] as the tensor cores sum it: fp32
    products of 16-wide k steps, added one after the other in fp32."""
    out = 0.0
    for k in range(0, lhs.shape[-1], 16):
        out = out + lhs[..., k:k + 16] @ rhs[..., k:k + 16, :]
    return out


def _bf16_parts(v, n):
    """v as n bf16 parts: each the rest of v after the parts before it,
    rounded to bf16 (the rests are exact in fp32)."""
    parts = []
    for _ in range(n):
        parts.append(v.bfloat16().float())
        v = v - parts[-1]
    return parts


def _emulate_mma(xdt, a, Bm, Cm, *, l_parts=None, cum=None):
    """``ssd_intra_chunk_mma``'s arithmetic on [Bz,nc,Q,H,P] / [Bz,nc,Q,N]
    tensors: xdt, B and C rounded to bf16 (the kernel's inputs); cum summed
    in fp64 and kept as two fp32 parts hi + lo, the exponents formed as
    (hi_i - hi_j) + (lo_i - lo_j) (or ``cum`` as given, an fp32 cum with no
    lo part); per 64-row tile of i and 64-step tile of j up to the
    diagonal, scores = C B^T, L = exp(cum_i - cum_j) scores with the
    exponential selected only where j <= i, y += L_hi X + L_lo X (+ L_mid X): L in ``l_parts`` bf16 parts, by
    default as ``ssd.cu``'s kLParts, two at N <= 16 and three above; S =
    X^T (dec B)_hi + X^T (dec B)_lo with dec_j = exp(cum_end - cum_j); every
    product summed in fp32 over 16-wide k steps."""
    Bz, nc, Q, H, P = xdt.shape
    if l_parts is None:
        l_parts = 2 if Bm.shape[-1] <= 16 else 3
    x = xdt.bfloat16().float().permute(0, 1, 3, 2, 4)                # [Bz,nc,H,Q,P]
    Bf, Cf = Bm.bfloat16().float(), Cm.bfloat16().float()
    if cum is None:
        c64 = torch.cumsum(a.double(), dim=2)
        hi = c64.float()
        lo = (c64 - hi.double()).float()
    else:
        hi, lo = cum, torch.zeros_like(cum)
    hi, lo = (c.permute(0, 1, 3, 2) for c in (hi, lo))                # [Bz,nc,H,Q]

    y = torch.zeros_like(x)
    for i0 in range(0, Q, 64):
        i = torch.arange(i0, min(i0 + 64, Q))
        for j0 in range(0, i0 + 1, 64):
            j = torch.arange(j0, min(j0 + 64, Q))
            scores = _ksum(Cf[:, :, i], Bf[:, :, j].transpose(-1, -2))[:, :, None]
            diff = (hi[..., i, None] - hi[..., None, j]) + (lo[..., i, None] - lo[..., None, j])
            L = torch.exp(torch.where(j[None, :] <= i[:, None], diff, -torch.inf)) * scores
            for part in _bf16_parts(L, l_parts):
                y[..., i, :] += _ksum(part, x[..., j, :])
    dec = torch.exp((hi[..., -1:] - hi) + (lo[..., -1:] - lo))        # [Bz,nc,H,Q]
    s = sum(_ksum(x.transpose(-1, -2), part)
            for part in _bf16_parts(dec[..., None] * Bf[:, :, None], 2))   # [Bz,nc,H,P,N]
    return y.permute(0, 1, 3, 2, 4), s


def _bf16_valued(*xs):
    """float32 arrays holding bf16 values (the kernel's inputs, exactly)."""
    return [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]


@pytest.mark.parametrize("B,T,H,P,N,chunk,hb", SWEEP)
def test_mma_emulation_matches_jax_kernel(B, T, H, P, N, chunk, hb):
    xdt, a, Bm, Cm = _inputs(B, T, H, P, N, seed=5)
    xdt, Bm, Cm = _bf16_valued(xdt, Bm, Cm)
    shaped = _chunked(xdt, a, Bm, Cm, B, T // chunk)
    y, s = _emulate_mma(*_t(*shaped))
    jy, js = j_intra(*shaped, hb=hb, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


# Bz, nc, Q, H, P, N: Hymba-1.5B's tile and mamba2-1.3b's, few heads
MMA_TILES = [(1, 2, 128, 4, 64, 16), (1, 1, 256, 2, 64, 128)]


def _tile_inputs(Bz, nc, Q, H, P, N, seed, decay=None):
    xdt, a, Bm, Cm = _inputs(Bz, nc * Q, H, P, N, seed=seed, decay=decay)
    xdt, Bm, Cm = _bf16_valued(xdt, Bm, Cm)
    return _t(*_chunked(xdt, a, Bm, Cm, Bz, nc))


@pytest.mark.parametrize("shape", MMA_TILES)
def test_mma_emulation_matches_plain(shape):
    args = _tile_inputs(*shape, seed=6)
    for got, want in zip(_emulate_mma(*args), ssd_intra_chunk_torch(*args)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_mma_emulation_strong_decay_is_finite():
    args = _tile_inputs(2, 2, 128, 4, 64, 16, seed=2, decay=-2.0)
    got = _emulate_mma(*args)
    assert all(torch.isfinite(g).all() for g in got)
    for g, want in zip(got, ssd_intra_chunk_torch(*args)):
        np.testing.assert_allclose(g.numpy(), want.numpy(), **TOL)


def _off(got, want):
    """How many elements of ``got`` are off atol 3e-5 / rtol 3e-4 of ``want``."""
    return int(((got - want).abs() > TOL["atol"] + TOL["rtol"] * want.abs()).sum())


def test_one_bf16_rounding_of_l_leaves_the_bound():
    """Why the kernel splits L: rounded once to bf16 (2^-9 relative a term),
    L moves y at Hymba's tile far past atol 3e-5 / rtol 3e-4; in the two
    parts the kernel takes at N 16 it stays within it."""
    args = _tile_inputs(*MMA_TILES[0], seed=6)
    want = ssd_intra_chunk_torch(*args)[0]
    assert _off(_emulate_mma(*args, l_parts=1)[0], want) > want.numel() // 10
    assert _off(_emulate_mma(*args)[0], want) == 0


def test_two_bf16_parts_of_l_leave_the_bound_at_mamba2_scale():
    """Why three parts: L_hi + L_lo (2^-17 relative a term) keeps Hymba's
    prefill within the bound, but at mamba2-1.3b's tile (Q 256, N 128:
    |C.B| up to ~20), with 32 of its 64 heads at a 4 x 2,048-token prefill,
    a few of 16.8 M outputs leave it; L_hi + L_mid + L_lo (2^-26) holds
    them."""
    args = _tile_inputs(4, 8, 256, 32, 64, 128, seed=1)
    off = {2: 0, 3: 0}
    for b in range(4):                     # a batch row at a time, to bound the memory
        row = [t[b:b + 1] for t in args]
        want = ssd_intra_chunk_torch(*row)[0]
        for n in off:
            off[n] += _off(_emulate_mma(*row, l_parts=n)[0], want)
    assert off[2] > 0 and off[3] == 0


def _fp32_cums(a):
    """Two fp32 cums of a [Bz,nc,Q,H]: summed in fp32 step by step (as
    torch's float cumsum along this dim does on the card), and summed in
    fp64 and rounded once (as it does on the CPU)."""
    steps = torch.zeros_like(a)
    run = torch.zeros_like(a[:, :, 0])
    for j in range(a.shape[2]):
        run = run + a[:, :, j]
        steps[:, :, j] = run
    return {"steps": steps, "rounded once": torch.cumsum(a.double(), dim=2).float()}


# half of mamba2-1.3b's 4 x 2,048-token prefill at 16 of its 64 heads
MAMBA2_PART = (4, 8, 256, 16, 64, 128)


def test_fp32_step_order_cum_leaves_the_bound():
    """Why the kernel keeps cum in fp64 (as hi + lo): with an fp32 cum,
    |cum| ~200 at a 256-step chunk, summed step by step or rounded once,
    the kernel's arithmetic moves y past atol 3e-5 / rtol 3e-4 of the plain
    version at mamba2-1.3b's tile; with hi + lo it does not."""
    args = _tile_inputs(*MAMBA2_PART, seed=1)
    off = {"steps": 0, "rounded once": 0, "hi + lo": 0}
    for b in range(args[0].shape[0]):      # a batch row at a time, to bound the memory
        row = [t[b:b + 1] for t in args]
        want = ssd_intra_chunk_torch(*row)[0]
        for name, cum in _fp32_cums(row[1]).items():
            off[name] += _off(_emulate_mma(*row, cum=cum)[0], want)
        off["hi + lo"] += _off(_emulate_mma(*row)[0], want)
    assert off["steps"] > 0 and off["rounded once"] > 0 and off["hi + lo"] == 0, off


def _dense(xdt, a, Bm, Cm, dtype, cum=None):
    """The intra-chunk step (y, S) with every cast, exponential and sum in
    ``dtype``, cum = cumsum(a) in ``dtype`` unless given: in float64, a
    witness for the rounding of the fp32 versions, independent of both."""
    Q = xdt.shape[2]
    x, Bf, Cf = xdt.to(dtype), Bm.to(dtype), Cm.to(dtype)
    cum = (torch.cumsum(a.to(dtype), dim=2) if cum is None else cum).to(dtype)
    idx = torch.arange(Q)
    tri = (idx[:, None] >= idx[None, :])[:, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = torch.exp(torch.where(tri, diff, -torch.inf)) * torch.einsum(
        "bcin,bcjn->bcij", Cf, Bf)[..., None]
    y = torch.einsum("bcijh,bcjhp->bcihp", L, x)
    decay = torch.exp(cum[:, :, -1:] - cum)
    return y, torch.einsum("bcqn,bcqhp->bchpn", Bf, decay[..., None] * x)


@pytest.mark.parametrize("shape", MMA_TILES)
def test_mma_emulation_and_plain_match_fp64(shape):
    """The kernel's arithmetic and the plain version it is held to are each
    within atol 3e-5 / rtol 3e-4 of the step computed in fp64 throughout."""
    args = _tile_inputs(*shape, seed=6)
    wit = _dense(*args, torch.float64)
    for got in (_emulate_mma(*args), ssd_intra_chunk_torch(*args)):
        for g, w in zip(got, wit):
            np.testing.assert_allclose(g.double().numpy(), w.numpy(), **TOL)


def test_fp32_step_order_cum_misses_fp64():
    """Why the plain version forms its exponents in fp64: as it was before,
    with an fp32 cum (step by step on the card, rounded once on the CPU),
    it leaves atol 3e-5 / rtol 3e-4 of the step computed in fp64 throughout
    at mamba2-1.3b's tile; as it is, and the kernel's arithmetic, do not."""
    args = _tile_inputs(*MAMBA2_PART, seed=1)
    off = {"steps": 0, "rounded once": 0, "plain": 0, "kernel": 0}
    for b in range(args[0].shape[0]):
        row = [t[b:b + 1] for t in args]
        wit = _dense(*row, torch.float64)[0]
        for name, cum in _fp32_cums(row[1]).items():
            off[name] += _off(_dense(*row, torch.float32, cum=cum)[0].double(), wit)
        off["plain"] += _off(ssd_intra_chunk_torch(*row)[0].double(), wit)
        off["kernel"] += _off(_emulate_mma(*row)[0].double(), wit)
    assert off["steps"] > 0 and off["rounded once"] > 0, off
    assert off["plain"] == 0 and off["kernel"] == 0, off

@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,want_route", [
    ((2, 16, 128, 25, 64, 16), "bfloat16", "mma"),    # Hymba, Bz 2
    ((1, 1, 256, 2, 64, 128), "bfloat16", "mma"),     # mamba2-1.3b's tile
    ((2, 4, 32, 8, 16, 32), "float32", "simt"),
    ((1, 4, 64, 4, 32, 16), "float32", "simt"),
    ((2, 3, 32, 6, 8, 8), "float32", "simt")])
def test_cuda_kernel_matches_plain(shape, dtype, want_route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    Bz, nc, Q, H, P, N = shape
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)
    xdt, a, Bm, Cm = _inputs(Bz, nc * Q, H, P, N, seed=4)
    args = (torch.from_numpy(xdt.reshape(Bz, nc, Q, H, P)).to(dev, tdt),
            torch.from_numpy(a.reshape(Bz, nc, Q, H)).to(dev),
            torch.from_numpy(Bm.reshape(Bz, nc, Q, N)).to(dev, tdt),
            torch.from_numpy(Cm.reshape(Bz, nc, Q, N)).to(dev, tdt))
    assert route(*args) == want_route
    before = ssd_intra_chunk_kernel.route_launches[want_route]
    y, s = ssd_intra_chunk(*args)
    wy, ws = ssd_intra_chunk(*args, backend="ref")
    torch.cuda.synchronize()
    assert ssd_intra_chunk_kernel.route_launches[want_route] == before + 1
    np.testing.assert_allclose(y.cpu().numpy(), wy.cpu().numpy(), **TOL)
    np.testing.assert_allclose(s.cpu().numpy(), ws.cpu().numpy(), **TOL)
    with pytest.raises(ValueError, match="shared memory"):   # mamba2-1.3b's tile in f32
        z = torch.zeros
        ssd_intra_chunk_kernel(z((1, 1, 256, 1, 64), device=dev), z((1, 1, 256, 1), device=dev),
                               z((1, 1, 256, 128), device=dev), z((1, 1, 256, 128), device=dev))
