"""The PyTorch port's quantize kernel module against the JAX package.

The port's numpy mirror and its plain torch version (``quantize_pack_torch``
/ ``unpack_dequantize_torch``: uint32 keys in int64, separate multiply and
add) must equal the JAX package's numpy mirror, its jnp reference and its
Pallas kernels in interpret mode BITWISE — packed bytes, scales and decoded
values — for bits in {2, 4, 8} and chunk in {8, 256}, including all-zero
chunks, ``-0.0``, keys near 2^32 - 1 and rows whose last chunk is ragged.
On a CUDA device the hand-written kernels must equal the plain version
bitwise too (``cuda``-marked; they skip without a card).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quantize import ops as jops  # noqa: E402
from repro.kernels.quantize import ref as jref  # noqa: E402
from repro_torch.kernels.quantize import ops as pops  # noqa: E402
from repro_torch.kernels.quantize import ref as pref  # noqa: E402
from repro_torch.kernels.quantize.kernel import (quantize_pack_kernel,  # noqa: E402
                                                 unpack_dequantize_kernel)
from repro_torch.kernels.rr_perm.ref import key_combine_torch  # noqa: E402

NC = 6


def _values(chunk, seed=0):
    """[NC, chunk] f32: normal values of mixed magnitudes, one all-zero
    chunk, one of signed zeros, one chunk with a single nonzero value."""
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(NC, chunk)) * 10.0 ** rng.integers(-3, 3, size=(NC, 1))).astype(np.float32)
    v[1] = 0.0
    v[2] = np.where(np.arange(chunk) % 2, np.float32(-0.0), np.float32(0.0))
    v[3] = 0.0
    v[3, chunk // 2] = -1.5
    return v


def _keys():
    """[NC] uint32 chunk keys, most of them near 2^32 - 1."""
    k = np.array([0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFF00, 0, 1, 0x80000000], np.uint64)
    return k.astype(np.uint32)


@pytest.mark.parametrize("chunk", [8, 256])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_matches_jax_numpy_jnp_and_pallas_bitwise(bits, chunk):
    v, keys = _values(chunk, bits), _keys()
    want_p, want_s = jref.quantize_pack(v, keys, bits, xp=np)
    ref_p, ref_s = jops.quantize_pack(jnp.asarray(v), jnp.asarray(keys), bits=bits, backend="ref")
    pal_p, pal_s = jops.quantize_pack(jnp.asarray(v), jnp.asarray(keys), bits=bits,
                                      backend="pallas", interpret=True)
    for p, s in ((ref_p, ref_s), (pal_p, pal_s), pref.quantize_pack(v, keys, bits)):
        np.testing.assert_array_equal(np.asarray(p), want_p)
        np.testing.assert_array_equal(np.asarray(s).view(np.uint32), want_s.view(np.uint32))
    # the plain torch version over one row of NC chunks
    got_p, got_s = pref.quantize_pack_torch(torch.from_numpy(v.reshape(1, -1)),
                                            torch.from_numpy(keys.astype(np.int64)[None]),
                                            chunk=chunk, bits=bits)
    assert got_p.dtype == torch.uint8 and got_p.shape == (1, NC, chunk * bits // 8)
    np.testing.assert_array_equal(got_p[0].numpy(), want_p)
    np.testing.assert_array_equal(got_s[0].numpy().view(np.uint32), want_s.view(np.uint32))


@pytest.mark.parametrize("chunk", [8, 256])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_dequantize_matches_jax_numpy_jnp_and_pallas_bitwise(bits, chunk):
    v, keys = _values(chunk, 10 + bits), _keys()
    packed, scale = jref.quantize_pack(v, keys, bits, xp=np)
    want = jref.unpack_dequantize(packed, scale, chunk, bits, xp=np)
    outs = [jops.unpack_dequantize(jnp.asarray(packed), jnp.asarray(scale), chunk=chunk,
                                   bits=bits, backend=b, interpret=True) for b in ("ref", "pallas")]
    outs.append(pref.unpack_dequantize(packed, scale, chunk, bits))
    got = pref.unpack_dequantize_torch(torch.from_numpy(packed)[None], torch.from_numpy(scale)[None],
                                       n=NC * chunk, chunk=chunk, bits=bits)
    outs.append(got[0].reshape(NC, chunk).numpy())
    for o in outs:
        np.testing.assert_array_equal(np.asarray(o).view(np.uint32), want.view(np.uint32))
    # all-zero chunks decode to zeros; the error bound holds elsewhere
    assert not want[1].any() and not want[2].any()
    L = 2 ** (bits - 1) - 1
    assert (np.abs(want - v) <= scale[:, None] / L * (1 + 1e-6)).all()


@pytest.mark.parametrize("n", [1, 13, 256, 301])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_ragged_rows_equal_the_mirror_of_zero_padded_chunks(bits, n):
    """Rows of n values: the plain torch version (and so the kernel, which
    masks the tail instead of padding) equals the mirror on the row padded
    with zeros to whole chunks; decoding returns n values."""
    chunk = 8
    rng = np.random.default_rng(n)
    v = rng.normal(size=(3, n)).astype(np.float32)
    nc = -(-n // chunk)
    keys = rng.integers(2**32 - 64, 2**32, size=(3, nc), dtype=np.uint64).astype(np.int64)
    p, s = pref.quantize_pack_torch(torch.from_numpy(v), torch.from_numpy(keys), chunk=chunk,
                                    bits=bits)
    back = pref.unpack_dequantize_torch(p, s, n=n, chunk=chunk, bits=bits)
    assert back.shape == (3, n)
    for r in range(3):
        pad = np.zeros(nc * chunk, np.float32)
        pad[:n] = v[r]
        wp, ws = jref.quantize_pack(pad.reshape(nc, chunk), keys[r].astype(np.uint32), bits, xp=np)
        np.testing.assert_array_equal(p[r].numpy(), wp)
        np.testing.assert_array_equal(s[r].numpy(), ws)
        wd = jref.unpack_dequantize(wp, ws, chunk, bits, xp=np).reshape(-1)[:n]
        np.testing.assert_array_equal(back[r].numpy().view(np.uint32), wd.view(np.uint32))


def test_plain_version_slices_large_inputs_identically(monkeypatch):
    """The plain torch version works a slice of chunks at a time; the slice
    size does not change a byte."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.normal(size=(2, 1000)).astype(np.float32))
    keys = key_combine_torch(torch.tensor([[5], [7]]), torch.arange(125)[None])
    whole = pref.quantize_pack_torch(v, keys, chunk=8, bits=4)
    monkeypatch.setattr(pref, "_SLICE_VALUES", 24)
    sliced = pref.quantize_pack_torch(v, keys, chunk=8, bits=4)
    assert torch.equal(whole[0], sliced[0]) and torch.equal(whole[1], sliced[1])


def test_packing_helpers_and_validation():
    rng = np.random.default_rng(4)
    for bits in (2, 4, 8):
        lv = rng.integers(0, 2 * (2 ** (bits - 1) - 1) + 1, size=(3, 16)).astype(np.uint8)
        np.testing.assert_array_equal(pref.pack_levels(lv, bits), jref.pack_levels(lv, bits, np))
        np.testing.assert_array_equal(pref.unpack_levels(pref.pack_levels(lv, bits), 16, bits), lv)
    assert pref.BITS_CHOICES == jref.BITS_CHOICES
    assert pref.packed_width(256, 4) == jref.packed_width(256, 4) == 128
    with pytest.raises(ValueError):
        pref.packed_width(3, 4)
    with pytest.raises(ValueError):
        pref.levels(3)


def test_cpu_dispatch_takes_plain_version_and_kernels_refuse_cpu():
    v = torch.randn(2, 16)
    keys = torch.zeros(2, 2, dtype=torch.int64)
    before = (quantize_pack_kernel.launches, unpack_dequantize_kernel.launches)
    for backend in ("kernel", "ref"):
        p, s = pops.quantize_pack(v, keys, chunk=8, bits=4, backend=backend)
        want = pref.quantize_pack_torch(v, keys, chunk=8, bits=4)
        assert torch.equal(p, want[0]) and torch.equal(s, want[1])
        out = pops.unpack_dequantize(p, s, n=16, chunk=8, bits=4, backend=backend)
        assert torch.equal(out, pref.unpack_dequantize_torch(p, s, n=16, chunk=8, bits=4))
    assert (quantize_pack_kernel.launches, unpack_dequantize_kernel.launches) == before
    with pytest.raises(ValueError, match="backend"):
        pops.quantize_pack(v, keys, chunk=8, bits=4, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        quantize_pack_kernel(v, keys, chunk=8, bits=4)
    with pytest.raises(ValueError, match="CUDA"):
        unpack_dequantize_kernel(p, s, n=16, chunk=8, bits=4)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_kernels_match_plain_bitwise(bits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(bits)
    n, chunk = 1000, 256                      # a ragged last chunk
    v = rng.normal(size=(3, n)).astype(np.float32)
    v[1, :512] = 0.0
    keys = torch.from_numpy(rng.integers(2**32 - 512, 2**32, size=(3, 4),
                                         dtype=np.uint64).astype(np.int64))
    want = pref.quantize_pack_torch(torch.from_numpy(v), keys, chunk=chunk, bits=bits)
    got = quantize_pack_kernel(torch.from_numpy(v).to(dev), keys.to(dev), chunk=chunk, bits=bits)
    back = unpack_dequantize_kernel(*got, n=n, chunk=chunk, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    plain = pref.unpack_dequantize_torch(*want, n=n, chunk=chunk, bits=bits)
    np.testing.assert_array_equal(back.cpu().numpy().view(np.uint32), plain.numpy().view(np.uint32))
