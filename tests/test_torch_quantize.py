"""The PyTorch port's quantize kernel module against the JAX package.

The port's numpy mirror and its plain torch version (``quantize_pack_torch``
/ ``unpack_dequantize_torch``: uint32 keys in int64, separate multiply and
add) must equal the JAX package's numpy mirror, its jnp reference and its
Pallas kernels in interpret mode BITWISE — packed bytes, scales and decoded
values — for bits in {2, 4, 8} and chunk in {8, 256}, including all-zero
chunks, ``-0.0``, keys near 2^32 - 1 and rows whose last chunk is ragged.
On a CUDA device the hand-written kernels must equal the plain version
bitwise too, on both routes (``cuda``-marked; they skip without a card).
On the CPU: the kernels' routing (``route``), the warp route's hoisted hash
in numpy uint32, and a torch emulation of the warp route's lane layout held
to the plain version bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quantize import ops as jops  # noqa: E402
from repro.kernels.quantize import ref as jref  # noqa: E402
from repro_torch.kernels.quantize import ops as pops  # noqa: E402
from repro_torch.kernels.quantize import ref as pref  # noqa: E402
from repro_torch.kernels.quantize.kernel import (_choose, quantize_pack_kernel,  # noqa: E402
                                                 route, unpack_dequantize_kernel)
from repro_torch.kernels.rr_perm import ref as rr_ref  # noqa: E402
from repro_torch.kernels.rr_perm.ref import fmix32_torch, key_combine_torch  # noqa: E402

NC = 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
@pytest.mark.parametrize("chunk", [128, 256, 384, 512, 640, 768, 896, 1024])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_kernels_match_plain_bitwise(bits, chunk):
    """Both routes at every chunk the warp route takes (each of its kernel
    instances), 4 chunks a row with a ragged last one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(bits)
    n = 4 * chunk - 24                        # a ragged last chunk; n % 4 == 0
    v = rng.normal(size=(3, n)).astype(np.float32)
    v[1, :2 * chunk] = 0.0
    keys = torch.from_numpy(rng.integers(2**32 - 512, 2**32, size=(3, 4),
                                         dtype=np.uint64).astype(np.int64))
    want = pref.quantize_pack_torch(torch.from_numpy(v), keys, chunk=chunk, bits=bits)
    plain = pref.unpack_dequantize_torch(*want, n=n, chunk=chunk, bits=bits)
    vd = torch.from_numpy(v).to(dev)
    assert route(n, chunk, bits, vd.data_ptr()) == "warp"
    for kernel in ("warp", "block"):
        before = quantize_pack_kernel.route_launches[kernel]
        got = quantize_pack_kernel(vd, keys.to(dev), chunk=chunk, bits=bits, kernel=kernel)
        back = unpack_dequantize_kernel(*got, n=n, chunk=chunk, bits=bits, kernel=kernel)
        torch.cuda.synchronize()
        assert quantize_pack_kernel.route_launches[kernel] == before + 1
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        np.testing.assert_array_equal(back.cpu().numpy().view(np.uint32),
                                      plain.numpy().view(np.uint32))


@pytest.mark.cuda
def test_cuda_warp_kernel_refuses_block_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    v = torch.randn(2, 1002, device=dev)             # n % 4 != 0: route "block"
    keys = torch.zeros(2, 4, dtype=torch.int64, device=dev)
    before = dict(quantize_pack_kernel.route_launches)
    with pytest.raises(ValueError, match="cannot take"):
        quantize_pack_kernel(v, keys, chunk=256, bits=4, kernel="warp")
    p, s = quantize_pack_kernel(v, keys, chunk=256, bits=4)
    assert quantize_pack_kernel.route_launches["block"] == before["block"] + 1
    with pytest.raises(ValueError, match="cannot take"):
        unpack_dequantize_kernel(p, s, n=1002, chunk=256, bits=4, kernel="warp")


def _e2e_wire_leaves():
    """The value counts of CharLM-100M's 12 wire leaves (meta tensors)."""
    from repro_torch.launch.train import charlm_e2e_config
    from repro_torch.models.model import build_model
    from repro_torch.utils.pytree import wire_shapes

    cfg, _ = charlm_e2e_config()
    return [like.numel() for _, like in wire_shapes(build_model(cfg).init(0, "meta"))]


def test_route_sends_the_e2e_leaves_to_warp_and_the_rest_to_block():
    aligned = torch.empty(64).data_ptr()              # the CPU allocator aligns to 64 bytes
    view = torch.empty(65)[1:]                        # one element in: 4 bytes off
    assert aligned % 16 == 0 and view.data_ptr() % 16 == 4
    leaves = _e2e_wire_leaves()
    assert len(leaves) == 12 and sum(leaves) == 114_051_840
    for n in leaves:
        for bits in (2, 4, 8):
            assert route(n, 256, bits, aligned) == "warp"
    for c in (8, 256, 1000):                          # chip_smoke's stress rows
        assert route(37 * c + 5, c, 4, aligned) == "block"
    assert route(37 * 1024 + 516, 1024, 4, aligned) == "warp"   # ragged tail, n % 4 == 0
    assert route(37 * 128, 128, 2, aligned) == "warp"
    assert route(4096, 2048, 4, aligned) == "block"   # past 32 values a lane
    assert route(4096, 192, 4, aligned) == "block"    # not a multiple of 128
    assert route(1002, 256, 4, aligned) == "block"    # n % 4 != 0
    assert route(1000, 256, 4, view.data_ptr()) == "block"
    assert route(1000, 256, 4, aligned, view.data_ptr()) == "block"
    with pytest.raises(ValueError):
        route(1000, 256, 3, aligned)
    # a named kernel: "block" takes anything, "warp" only what route gives it
    assert _choose("warp", None) == "warp" and _choose("warp", "block") == "block"
    assert _choose("block", None) == "block"
    for chosen, kernel in (("block", "warp"), ("warp", "simt")):
        with pytest.raises(ValueError, match="cannot take"):
            _choose(chosen, kernel)


def test_hoisted_hash_equals_key_combine_bitwise():
    """The warp route hashes position p of a chunk with key h as
    fmix32(h ^ (p + K)), K = 0x9E3779B9 + (h << 6) + (h >> 2) formed once a
    chunk: the mirror's key_combine(h, p) in uint32 arithmetic mod 2^32."""
    p = np.arange(2**16, dtype=np.uint32)
    near = [0, 1, 2, 3, 2**31 - 2, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 4, 2**32 - 3,
            2**32 - 2, 2**32 - 1]
    for key in near:
        h = np.array([key], np.uint32)
        k = np.uint32(0x9E3779B9) + (h << np.uint32(6)) + (h >> np.uint32(2))
        got = rr_ref.fmix32(h ^ (p + k))
        np.testing.assert_array_equal(got, rr_ref.key_combine(h, p))
        np.testing.assert_array_equal(got, np.asarray(jref.key_combine(h, p, np)))


_M32 = 0xFFFFFFFF


def _warp_lanes(n, chunk):
    """[nc, V, 32] positions 4l + 128i of lane l's float4 i in each chunk's
    row, and whether that float4 lies before n (all of it, as n % 4 == 0)."""
    nc, V = -(-n // chunk), chunk // 128
    pos = 4 * torch.arange(32)[None, :] + 128 * torch.arange(V)[:, None]
    base = chunk * torch.arange(nc)[:, None, None]
    return pos.expand(nc, V, 32), base + pos < n


def _emulate_warp_quantize(v, keys, *, chunk, bits):
    """``quantize_pack_warp_kernel`` on CPU tensors, lane by lane: each lane
    loads its float4s (one past n reads 0.0; the row's tail is padded with
    NaN to show that it is never read), takes its max-abs, then the 5-step
    xor-shuffle max; hashes with the hoisted offset; packs a float4's four
    levels into one little-endian word (level e at bit bits * e) and stores
    its bits/2 bytes at byte (l + 32i) * bits/2 of the chunk."""
    R, n = v.shape
    assert n % 4 == 0 and chunk % 128 == 0
    pos, ok = _warp_lanes(n, chunk)
    nc, V = pos.shape[:2]
    L = float(pref.levels(bits))
    padded = torch.nn.functional.pad(v, (0, nc * chunk - n), value=float("nan"))
    x = padded.reshape(R, nc, V * 128).gather(
        2, (pos[..., None] + torch.arange(4)).reshape(1, nc, -1).expand(R, -1, -1))
    x = torch.where(ok[None, ..., None], x.reshape(R, nc, V, 32, 4), 0.0)
    m = x.abs().amax(dim=(2, 4))                      # [R, nc, 32]: each lane's own max
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        m = torch.maximum(m, m[..., lane ^ off])
    scale = m[..., 0]
    assert (m == scale[..., None]).all()              # every lane holds the chunk's scale
    inv = torch.where(scale > 0, torch.div(torch.full_like(scale, L), scale), 0.0)
    key = keys[..., None, None, None]                 # [R, nc, 1, 1, 1]
    koff = (0x9E3779B9 + ((key << 6) & _M32) + (key >> 2)) & _M32
    p0 = (pos[None, ..., None] + koff) & _M32         # [R, nc, V, 32, 1]
    h = fmix32_torch(key ^ ((p0 + torch.arange(4)) & _M32))
    u = h.to(torch.float32) * 2.0**-32
    y = x.abs() * inv[..., None, None, None] + u
    q = torch.clamp(torch.floor(y), 0.0, L)
    lv = torch.where(x < 0, L - q, L + q).to(torch.int64)
    word = sum(lv[..., e] << (bits * e) for e in range(4))      # [R, nc, V, 32]
    nbytes = bits // 2
    out = torch.stack([(word >> (8 * k)) & 0xFF for k in range(nbytes)], dim=-1)
    return out.reshape(R, nc, V * 32 * nbytes).to(torch.uint8), scale


def _emulate_warp_dequantize(packed, scale, *, n, chunk, bits):
    """``unpack_dequantize_warp_kernel`` on CPU tensors: each lane reads its
    little-endian word of bits/2 bytes at byte (l + 32i) * bits/2, unpacks
    the four levels and writes the float4 only where it lies before n (the
    rest of the buffer keeps a NaN it must never lose)."""
    R = packed.shape[0]
    pos, ok = _warp_lanes(n, chunk)
    nc, V = pos.shape[:2]
    L = float(pref.levels(bits))
    recip = float(np.float32(1.0) / np.float32(L))
    nbytes = bits // 2
    b = packed.reshape(R, nc, V, 32, nbytes).to(torch.int64)
    word = sum(b[..., k] << (8 * k) for k in range(nbytes))
    lv = torch.stack([(word >> (bits * e)) & (2**bits - 1) for e in range(4)], dim=-1)
    vals = (lv.to(torch.float32) - L) * scale[..., None, None, None] * recip
    out = torch.full((R, nc, V * 128), float("nan"))
    idx = (pos[..., None] + torch.arange(4)).reshape(nc, -1)
    keep = ok[..., None].expand(nc, V, 32, 4).reshape(nc, -1)
    for r in range(R):
        for j in range(nc):
            out[r, j, idx[j][keep[j]]] = vals[r, j].reshape(-1)[keep[j]]
    out = out.reshape(R, nc * V * 128)
    assert torch.isnan(out[:, n:]).all()
    return out[:, :n]


@pytest.mark.parametrize("chunk", [128, 256, 384, 896, 1024])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_warp_lane_layout_emulation_matches_plain_bitwise(bits, chunk):
    rng = np.random.default_rng(100 * bits + chunk)
    n = 2 * chunk + 68                                # a ragged last chunk of 68 values
    v = (rng.normal(size=(3, n)) * 10.0 ** rng.integers(-3, 3, size=(3, 1))).astype(np.float32)
    v[1, :chunk] = 0.0
    v[2, chunk:2 * chunk] = np.where(np.arange(chunk) % 2, np.float32(-0.0), np.float32(0.0))
    nc = 3
    keys = torch.from_numpy(np.array([[0xFFFFFFFF, 0xFFFFFFFE, 0], [1, 0x80000000, 0x7FFFFFFF],
                                      [2**32 - 300, 5, 2**31 + 7]], np.int64))
    vt = torch.from_numpy(v)
    want_p, want_s = pref.quantize_pack_torch(vt, keys, chunk=chunk, bits=bits)
    got_p, got_s = _emulate_warp_quantize(vt, keys, chunk=chunk, bits=bits)
    assert got_p.shape == want_p.shape == (3, nc, chunk * bits // 8)
    assert torch.equal(got_p, want_p)
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32), want_s.numpy().view(np.uint32))
    want_d = pref.unpack_dequantize_torch(want_p, want_s, n=n, chunk=chunk, bits=bits)
    got_d = _emulate_warp_dequantize(want_p, want_s, n=n, chunk=chunk, bits=bits)
    np.testing.assert_array_equal(got_d.numpy().view(np.uint32), want_d.numpy().view(np.uint32))
