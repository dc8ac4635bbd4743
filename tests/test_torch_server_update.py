"""The PyTorch port's fused App. F server update (``repro_torch.kernels.
server_update``) against the JAX package's, and its contracts in the port.

* the port's plain torch version (the CUDA kernel's math, ``x * (1/eta_l)``)
  and its copy of the oracle (``x / eta_l``) vs JAX's Pallas kernel in
  interpret mode and its oracle, at the JAX tests' tolerances (1e-6 on x and
  1e-5 on m in f32, 1e-2 on x in bf16), over ragged sizes, both dtypes and a
  sweep of the three scalars;
* the dict wrapper ``apply_fused_update`` on the CPU vs JAX's pytree wrapper,
  leaves of 1, 255 and 65,537 values; a tensor of 0 values;
* within the port: the plain version equals a numpy fp32 mirror of the
  kernel's operation order bitwise (no fused multiply-add), the mixed-device
  and non-CUDA calls raise;
* on a card (``cuda``-marked, skipped without one): the kernel equals the
  plain version bitwise, f32 and bf16, ragged sizes, over a tensor table
  longer than one launch holds.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.server_update.kernel import fused_server_update  # noqa: E402
from repro.kernels.server_update.ops import apply_fused_update as j_apply  # noqa: E402
from repro.kernels.server_update.ref import server_update_ref as j_ref  # noqa: E402
from repro_torch.kernels.server_update.kernel import server_update_kernel  # noqa: E402
from repro_torch.kernels.server_update.ops import apply_fused_update  # noqa: E402
from repro_torch.kernels.server_update.ref import server_update_ref, server_update_torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, seed=3, dtype=np.float32):
    r = np.random.default_rng(seed)
    x = r.normal(size=n).astype(dtype)
    d = (r.normal(size=n) * 0.01).astype(dtype)
    m = r.normal(size=n).astype(np.float32)
    return x, d, m


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n,block", [(64, 64), (1000, 256), (65536, 8192), (7, 16)])
def test_plain_and_oracle_match_jax_sizes(n, block):
    x, d, m = _inputs(n)
    jx, jm = fused_server_update(jnp.asarray(x), jnp.asarray(d), jnp.asarray(m), 1.0, 0.1, 0.05,
                                 block=block, interpret=True)
    rx, rm = j_ref(jnp.asarray(x), jnp.asarray(d), jnp.asarray(m), 1.0, 0.1, 0.05)
    px, pm = server_update_torch(*_t(x, d, m), 1.0, 0.1, 1 / 0.05)
    ox, om = server_update_ref(*_t(x, d, m), 1.0, 0.1, 0.05)
    for got_x, got_m in ((px, pm), (ox, om)):
        for want_x, want_m in ((jx, jm), (rx, rm)):
            np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-6, rtol=0)
            np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_dtypes(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, d, _ = _inputs(512)
    m = np.zeros(512, np.float32)
    jxin, jdin = jnp.asarray(x).astype(jdt), jnp.asarray(d).astype(jdt)
    jx, _ = fused_server_update(jxin, jdin, jnp.asarray(m), 1.0, 0.1, 0.05, block=128,
                                interpret=True)
    rx, _ = j_ref(jxin, jdin, jnp.asarray(m), 1.0, 0.1, 0.05)
    xin = torch.from_numpy(np.array(jxin.astype(jnp.float32))).to(tdt)
    din = torch.from_numpy(np.array(jdin.astype(jnp.float32))).to(tdt)
    px, pm = server_update_torch(xin, din, torch.from_numpy(m), 1.0, 0.1, 1 / 0.05)
    assert px.dtype == tdt and pm.dtype == torch.float32
    tol = 1e-2 if dtype == "bfloat16" else 1e-6
    for want in (jx, rx):
        np.testing.assert_allclose(px.float().numpy(), np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("seed", range(8))
def test_plain_matches_jax_scalar_sweep(seed):
    """The JAX suite's property over (eta_g, a, eta_l), as fixed draws."""
    r = np.random.default_rng(100 + seed)
    eta_g, a, eta_l = float(r.uniform(0.1, 2.0)), float(r.uniform(0.0, 1.0)), float(r.uniform(0.01, 1.0))
    if seed == 0:
        a = 0.0
    if seed == 1:
        a = 1.0
    x = np.linspace(-1, 1, 130, dtype=np.float32)
    d, m = (np.sin(x) * 0.1).astype(np.float32), np.cos(x).astype(np.float32)
    jx, jm = fused_server_update(jnp.asarray(x), jnp.asarray(d), jnp.asarray(m), eta_g, a, eta_l,
                                 block=64, interpret=True)
    px, pm = server_update_torch(*_t(x, d, m), eta_g, a, 1 / eta_l)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), atol=1e-5)


def test_plain_is_the_kernels_operation_order_bitwise():
    """A numpy fp32 mirror that rounds after every operation, in the CUDA
    kernel's order: torch computes the same bits (nothing fused)."""
    x, d, m = _inputs(4099, seed=7)
    f = np.float32
    eta_g, a, inv = f(0.8), f(0.1), f(1) / (f(0.05) * f(3.7))
    ghat = (-d) * inv
    want_m = (a * ghat) + ((f(1) - a) * m)
    want_x = x + eta_g * d
    px, pm = server_update_torch(*_t(x, d, m), 0.8, 0.1, torch.tensor(inv))
    np.testing.assert_array_equal(px.numpy().view(np.uint32), want_x.view(np.uint32))
    np.testing.assert_array_equal(pm.numpy().view(np.uint32), want_m.view(np.uint32))


def test_dict_wrapper_matches_jax_ragged():
    """Leaves of 1, 255 and 65,537 values and a 2-D leaf, one call; the
    port's dict of tensors vs JAX's pytree (Pallas interpret, block 256)."""
    shapes = {"a": (1,), "b": (255,), "c": (65537,), "w": (33, 9)}
    r = np.random.default_rng(5)
    params = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    delta = {k: (v * 0.01).astype(np.float32) for k, v in params.items()}
    mom = {k: r.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    jt = lambda t: {k: jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    jx, jm = j_apply(jt(params), jt(delta), jt(mom), eta_g=1.0, a=0.1, eta_l=0.1,
                     interpret=True, block=256)
    tt = lambda t: {k: torch.from_numpy(v.copy()) for k, v in t.items()}  # noqa: E731
    px, pm = apply_fused_update(tt(params), tt(delta), tt(mom), eta_g=1.0, a=0.1,
                                inv_eta_l=torch.tensor(1 / 0.1, dtype=torch.float32))
    for k in shapes:
        assert px[k].shape == shapes[k] and pm[k].dtype == torch.float32
        np.testing.assert_allclose(px[k].numpy(), np.asarray(jx[k]), atol=1e-6, err_msg=k)
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), atol=1e-5, err_msg=k)


def test_dict_wrapper_casts_delta_and_keeps_inputs():
    """Delta is cast to x's dtype (bf16 here); an empty tensor passes
    through; the inputs are not written."""
    params = {"x": torch.linspace(-1, 1, 9).to(torch.bfloat16), "e": torch.zeros(0)}
    delta = {"x": torch.full((9,), 0.01), "e": torch.zeros(0)}
    mom = {"x": torch.ones(9), "e": torch.zeros(0)}
    before = {k: v.clone() for k, v in params.items()}
    px, pm = apply_fused_update(params, delta, mom, eta_g=1.0, a=0.5, inv_eta_l=4.0)
    want_x, want_m = server_update_torch(params["x"], delta["x"].to(torch.bfloat16), mom["x"],
                                         1.0, 0.5, 4.0)
    assert torch.equal(px["x"], want_x) and torch.equal(pm["x"], want_m)
    assert px["e"].shape == (0,) and pm["e"].shape == (0,)
    assert all(torch.equal(params[k], before[k]) for k in params)
    assert px["x"] is not params["x"] and pm["x"] is not mom["x"]


def test_mixed_devices_and_cpu_kernel_call_raise():
    params = {"x": torch.zeros(4)}
    with pytest.raises(ValueError, match="one device"):
        apply_fused_update(params, {"x": torch.zeros(4, device="meta")}, {"x": torch.zeros(4)},
                           eta_g=1.0, a=0.1, inv_eta_l=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        server_update_kernel([torch.zeros(4)], [torch.zeros(4)], [torch.zeros(4)], eta_g=1.0,
                             a=0.1, inv_eta_l=torch.tensor(1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_bitwise(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)
    sizes = [1, 255, 0, 65537, 4096, 3] * 50          # 300 tensors: two launches
    r = np.random.default_rng(9)
    xs = [torch.from_numpy(r.normal(size=n).astype(np.float32)).to(dev, tdt) for n in sizes]
    ds = [torch.from_numpy((r.normal(size=n) * 0.01).astype(np.float32)).to(dev, tdt) for n in sizes]
    ms = [torch.from_numpy(r.normal(size=n).astype(np.float32)).to(dev) for n in sizes]
    inv = torch.reciprocal(torch.tensor(0.05, device=dev) * torch.tensor(3.7, device=dev))
    before = server_update_kernel.launches
    gx, gm = server_update_kernel(xs, ds, ms, eta_g=0.8, a=0.1, inv_eta_l=inv)
    assert server_update_kernel.launches - before == 2
    torch.cuda.synchronize()
    for x, d, m, kx, km in zip(xs, ds, ms, gx, gm):
        px, pm = server_update_torch(x, d, m, 0.8, 0.1, inv)
        assert torch.equal(kx.view(torch.int16 if dtype == "bfloat16" else torch.int32),
                           px.view(torch.int16 if dtype == "bfloat16" else torch.int32))
        assert torch.equal(km.view(torch.int32), pm.view(torch.int32))
