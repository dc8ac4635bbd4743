"""The PyTorch port's rr_perm kernel module against the JAX package.

The port's plain torch version (``rr_indices_torch``, int64 arithmetic
masked to 32 bits) must equal the JAX package's numpy mirror, its jnp
reference and its Pallas kernel in interpret mode BITWISE, including padding
slots (client id -1) and keys near 2^32 - 1.  On a CUDA device the
hand-written kernel must equal the plain version bitwise too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rr_perm import ref as jref  # noqa: E402
from repro.kernels.rr_perm.ops import rr_indices as jax_dispatch  # noqa: E402
from repro.utils import tags as jtags  # noqa: E402
from repro_torch.kernels.rr_perm import ops as pops  # noqa: E402
from repro_torch.kernels.rr_perm import ref as pref  # noqa: E402
from repro_torch.kernels.rr_perm.kernel import rr_indices_kernel  # noqa: E402
from repro_torch.utils import tags as ptags  # noqa: E402

SEED = 0xFFFFFFFF            # folds in as the largest uint32
RND = 0xFFFFFFF0
B, K = 5, 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slots(n):
    """A slot of size n for a client id near 2^32 - 1, one for client 7 and a
    padding slot (client -1, size 1, spe 1) — the pipeline's layout."""
    clients = np.array([0xFFFFFFFE, 7, -1], np.int64)
    sizes = np.array([n, n, 1], np.int32)
    spe = np.maximum(1, -(-sizes // B)).astype(np.int32)
    spe[2] = 1
    return clients, sizes, spe


def _jax_prekey(clients):
    return jref.stream_key(SEED, clients.astype(np.uint32), np.uint32(RND), np)


def _port(clients, sizes, spe, mode, K=K):
    prekey = pref.stream_key_torch(SEED, torch.from_numpy(clients), RND)
    return pref.rr_indices_torch(prekey, torch.from_numpy(sizes), torch.from_numpy(spe),
                                 B, K, mode=mode).numpy()


@pytest.mark.parametrize("mode", ["rr", "wr"])
@pytest.mark.parametrize("n", [1, 7, 1000, 12345])
def test_plain_torch_matches_jax_numpy_jnp_and_pallas(n, mode):
    clients, sizes, spe = _slots(n)
    prekey = _jax_prekey(clients)
    host = jref.rr_indices(prekey, sizes, spe, B, K, mode=mode, xp=np)
    args = (jnp.asarray(prekey), jnp.asarray(sizes), jnp.asarray(spe))
    jnp_ref = jax_dispatch(*args, B=B, K=K, mode=mode, backend="ref")
    pallas = jax_dispatch(*args, B=B, K=K, mode=mode, backend="pallas", interpret=True)
    port = _port(clients, sizes, spe, mode)
    assert port.dtype == np.int32 and port.shape == (3, K, B)
    np.testing.assert_array_equal(port, host)
    np.testing.assert_array_equal(port, np.asarray(jnp_ref))
    np.testing.assert_array_equal(port, np.asarray(pallas))
    # the port's own numpy mirror is the same function
    np.testing.assert_array_equal(
        pref.rr_indices(prekey, sizes, spe, B, K, mode=mode), host)


@pytest.mark.parametrize("client", [0, 1, 12345, 0x7FFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF, -1])
def test_stream_key_matches_jax(client):
    c = np.array([client], np.int64)
    want = jref.stream_key(SEED, c.astype(np.uint32), np.uint32(RND), np)
    got = pref.stream_key_torch(SEED, torch.from_numpy(c), RND)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(pref.stream_key(SEED, c.astype(np.uint32), np.uint32(RND)), want)


def test_fmix32_and_key_combine_wrap_near_2_32():
    """The int64 multiply is split in 16-bit halves: products of two values
    near 2^32 - 1 exceed 2^63 and must still wrap exactly like uint32."""
    rng = np.random.default_rng(0)
    h = np.concatenate([np.arange(0xFFFFFFFF - 64, 0xFFFFFFFF + 1, dtype=np.uint64),
                        rng.integers(0, 2**32, size=4096, dtype=np.uint64)]).astype(np.uint32)
    v = h[::-1].copy()
    ht = torch.from_numpy(h.astype(np.int64))
    np.testing.assert_array_equal(pref.fmix32_torch(ht).numpy(),
                                  jref.fmix32(h, np).astype(np.int64))
    np.testing.assert_array_equal(
        pref.key_combine_torch(ht, torch.from_numpy(v.astype(np.int64))).numpy(),
        jref.key_combine(h, v, np).astype(np.int64))


@pytest.mark.parametrize("mode", ["rr", "wr"])
def test_k_prefix_property(mode):
    """A K/2 generation is exactly the first K/2 steps of the K generation
    (what lets a shorter step budget reuse the same streams)."""
    clients, sizes, spe = _slots(37)
    full = _port(clients, sizes, spe, mode, K=8)
    half = _port(clients, sizes, spe, mode, K=4)
    np.testing.assert_array_equal(half, full[:, :4])


def test_permutation_np_matches_jax():
    for n in (1, 7, 1000):
        np.testing.assert_array_equal(pref.permutation_np(7, 3, 11, 2, n),
                                      jref.permutation_np(7, 3, 11, 2, n))


def test_cpu_dispatch_takes_plain_version_and_kernel_refuses_cpu():
    clients, sizes, spe = _slots(9)
    prekey = pref.stream_key_torch(SEED, torch.from_numpy(clients), RND)
    s, e = torch.from_numpy(sizes), torch.from_numpy(spe)
    launches = rr_indices_kernel.launches
    got = pops.rr_indices(prekey, s, e, B=B, K=K)
    np.testing.assert_array_equal(got.numpy(), _port(clients, sizes, spe, "rr"))
    assert rr_indices_kernel.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        rr_indices_kernel(prekey, s, e, B=B, K=K)


def test_tag_registries_equal_jax():
    assert ptags.DOMAIN_TAGS == jtags.DOMAIN_TAGS
    assert ptags.SUBTAGS == jtags.SUBTAGS


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rr", "wr"])
def test_cuda_kernel_matches_plain_bitwise(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    clients, sizes, spe = _slots(12345)
    dev = torch.device("cuda")
    prekey = pref.stream_key_torch(SEED, torch.from_numpy(clients).to(dev), RND)
    s, e = torch.from_numpy(sizes).to(dev), torch.from_numpy(spe).to(dev)
    got = rr_indices_kernel(prekey, s, e, B=B, K=K, mode=mode)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), _port(clients, sizes, spe, mode))
