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
* on a card (``cuda``-marked, skipped without one): the kernel vs the plain
  version, and the tile that exceeds a block's shared memory raises.

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
from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_kernel  # noqa: E402
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((2, 16, 128, 25, 64, 16), "bfloat16"),   # Hymba, Bz 2
                                         ((2, 4, 32, 8, 16, 32), "float32"),
                                         ((1, 4, 64, 4, 32, 16), "float32"),
                                         ((2, 3, 32, 6, 8, 8), "float32")])
def test_cuda_kernel_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    Bz, nc, Q, H, P, N = shape
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)
    xdt, a, Bm, Cm = _inputs(Bz, nc * Q, H, P, N, seed=4)
    args = (torch.from_numpy(xdt.reshape(Bz, nc, Q, H, P)).to(dev, tdt),
            torch.from_numpy(a.reshape(Bz, nc, Q, H)).to(dev),
            torch.from_numpy(Bm.reshape(Bz, nc, Q, N)).to(dev, tdt),
            torch.from_numpy(Cm.reshape(Bz, nc, Q, N)).to(dev, tdt))
    before = ssd_intra_chunk_kernel.launches
    y, s = ssd_intra_chunk(*args)
    wy, ws = ssd_intra_chunk(*args, backend="ref")
    torch.cuda.synchronize()
    assert ssd_intra_chunk_kernel.launches == before + 1
    np.testing.assert_allclose(y.cpu().numpy(), wy.cpu().numpy(), **TOL)
    np.testing.assert_allclose(s.cpu().numpy(), ws.cpu().numpy(), **TOL)
    with pytest.raises(ValueError, match="shared memory"):   # mamba2-1.3b's tile
        z = torch.zeros
        ssd_intra_chunk_kernel(z((1, 1, 256, 1, 64), device=dev), z((1, 1, 256, 1), device=dev),
                               z((1, 1, 256, 128), device=dev), z((1, 1, 256, 128), device=dev))
