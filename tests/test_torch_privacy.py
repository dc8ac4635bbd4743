"""The PyTorch port's privacy plane (``repro_torch.fed.privacy``) against the
JAX package and within the port.

* twins of ``tests/test_privacy.py``: fixed point, pair keys, masks,
  payloads and the masked aggregate bitwise equal to JAX's (its numpy
  backend) under a hypothesis property over (C, n, bits, dropped), the
  chunked aggregate equal to the whole-leaf one at any chunk, blinding;
  the accountant's epsilon bitwise JAX's and its closed forms and
  references; the clip within rtol 1e-6 of JAX's (fp32 sums in another
  order) and the cohort clip bitwise the per-client clip and the
  ``"dp_clip"`` transform, in both forms; the noise's uniforms bitwise
  JAX's over a tree with stacked layers (JAX's leaf order and counters),
  its normals within ``NORMAL_ATOL`` of JAX's (``log`` / ``cos`` / ``sqrt``
  in fp32 may differ by an ulp); resume records and refusals; bind-time
  validation;
* twins of ``tests/test_privacy_equivalence.py`` on the duplicated
  quadratic: the plane off (default or with inactive knob values) adds no
  key and matches JAX; the DP keys; DP padded == bucketed, vmapped ==
  sequential and engine (prefetch on) == legacy, bitwise; secagg padded ==
  bucketed and within the fixed-point grid of the plane-off run; the whole
  stack with qsgd and the buffered fleet; 2 + 2 rounds through a DP
  checkpoint bitwise 4, and DP files of either package loading in the
  other; epsilon on the rows and the clip-scale histogram through
  ``train()``; each round against JAX's;
* CharLM-tiny with DP, secagg and telemetry through the cohort engine
  against JAX (each leaf within atol 1e-6 + rtol 1e-4 of its largest
  magnitude; the DP noise is bitwise on both sides, the normals within an
  ulp).

JAX's ``test_privacy_off_jaxpr_frozen`` and
``test_single_compilation_privacy`` wait for compiled round steps (ROADMAP
item 2).
"""
import dataclasses
import json
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.paper_tasks import CHARLM_TINY as J_TINY  # noqa: E402
from repro.data.federated import FederatedPipeline as JPipe  # noqa: E402
from repro.data.federated import Population as JPop  # noqa: E402
from repro.data.tasks import CharLMTask as JCharLM  # noqa: E402
from repro.data.tasks import DuplicatedQuadraticTask as JDup  # noqa: E402
from repro.fed import privacy as jpriv  # noqa: E402
from repro.fed.cohort import CohortEngine as JEngine  # noqa: E402
from repro.fed.losses import make_loss as j_make_loss  # noqa: E402
from repro.fed.losses import make_quadratic_loss as j_quad  # noqa: E402
from repro.fed.privacy import dp as jdp  # noqa: E402
from repro.fed.rounds import as_device_batch as j_as_device  # noqa: E402
from repro.fed.rounds import build_round_step as j_build_step  # noqa: E402
from repro.fed.strategy import bind_strategy as j_bind  # noqa: E402
from repro.fed.strategy import strategy_for as j_strategy_for  # noqa: E402
from repro.kernels.rr_perm.ref import fmix32, key_combine  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.utils import checkpoint as j_ckpt  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig  # noqa: E402
from repro_torch.core.local import RoundEnd  # noqa: E402
from repro_torch.data.federated import FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import CharLMTask, DuplicatedQuadraticTask  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.losses import make_loss, make_quadratic_loss  # noqa: E402
from repro_torch.fed.privacy import (RDPAccountant, accountant_for, add_dp_noise,  # noqa: E402
                                     check_dp_resume, clip_update, dp_checkpoint_record,
                                     dp_clip_cohort, dp_clip_transform, fixed_point_decode,
                                     fixed_point_encode, mask_matrix, noise_key, noise_uniforms,
                                     pair_keys, rdp_subsampled_gaussian, secagg_chunks,
                                     secagg_combine, secagg_payloads, secagg_reference,
                                     validate_privacy_config)
from repro_torch.fed.privacy.dp import _std_normal  # noqa: E402
from repro_torch.fed.rounds import build_round_step  # noqa: E402
from repro_torch.fed.strategy import bind_strategy, strategy_for  # noqa: E402
from repro_torch.fed.train_loop import train  # noqa: E402
from repro_torch.kernels.rr_perm.ref import key_combine_torch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils.checkpoint import load_metadata, load_server_state, save_server_state  # noqa: E402
from repro_torch.utils.pytree import wire_layout  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

TASK = DuplicatedQuadraticTask(copies=(1, 2, 3))
JTASK = JDup(copies=(1, 2, 3))
LOSS = make_quadratic_loss(3)
X0 = np.array([0.3, -0.1, 0.2], np.float32)
N_ROUNDS = 3
ATOL = 1e-6
# the Box–Muller normals against XLA's on the CPU: fp32 log / cos / sqrt
# may each differ by an ulp, and |z| <= 6.7 for u in (0, 1) at 2^-32
NORMAL_ATOL = 1e-5
BASE_KEYS = {"local_loss", "delta_norm", "cohort"}
DP_KEYS = {"dp_clipped_frac", "dp_sigma"}
DP_ON = dict(dp="on", dp_clip=0.5, dp_noise_mult=0.6)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of
    several cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fl(**kw):
    kw = dict(num_clients=4, cohort_size=2, sampling="uniform", epochs=1, local_batch=1,
              local_lr=0.1, seed=7) | kw
    return FLConfig(**kw), JFL(**kw)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.array(a))


# a tree with a layer-stacked leaf in the port's per-layer keys: JAX's
# leaves are blocks/a (stacked [2, ...]), blocks/b (stacked), then head
def _layered(rng, C, scale=2.0):
    port = {"head": rng.uniform(-scale, scale, (C, 5)).astype(np.float32)}
    for i in range(2):
        port[f"blocks/{i}/b"] = rng.uniform(-scale, scale, (C, 3)).astype(np.float32)
        port[f"blocks/{i}/a"] = rng.uniform(-scale, scale, (C, 2, 2)).astype(np.float32)
    jax_tree = {"head": port["head"],
                "blocks": {n: np.stack([port[f"blocks/{i}/{n}"] for i in range(2)], axis=1)
                           for n in ("a", "b")}}
    return {k: _t(v) for k, v in port.items()}, jax_tree


# ---------------------------------------------------------------------------
# secagg: fixed point, masks, cancellation, blinding — bitwise JAX's
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(bits=st.integers(min_value=1, max_value=20), seed=st.integers(min_value=0, max_value=10_000))
def test_fixed_point_roundtrip(bits, seed):
    x = _rng("fp", seed).uniform(-100.0, 100.0, size=37).astype(np.float32)
    x[:3] = [0.5 * 2.0 ** -bits, 1.5 * 2.0 ** -bits, 1e12]     # ties to even, the clamp
    enc = fixed_point_encode(_t(x), bits)
    assert np.array_equal(enc.numpy(), jpriv.fixed_point_encode(x, bits, np).astype(np.int64))
    dec = fixed_point_decode(enc, bits).numpy()
    assert np.array_equal(dec, jpriv.fixed_point_decode(enc.numpy().astype(np.uint32), bits, np))
    assert np.all(np.abs(dec[3:] - x[3:]) <= 2.0 ** -bits)


@settings(max_examples=15, deadline=None)
@given(c=st.integers(min_value=1, max_value=6), n=st.integers(min_value=1, max_value=33),
       rnd=st.integers(min_value=0, max_value=1000), seed=st.integers(min_value=0, max_value=10_000))
def test_mask_antisymmetry(c, n, rnd, seed):
    ids = _rng("mask", seed).choice(1000, size=c, replace=False)
    keys = pair_keys(3, _t(ids), rnd)
    assert torch.equal(keys, keys.T), "pair keys must be symmetric"
    jkeys = jpriv.pair_keys(3, ids.astype(np.uint32), np.uint32(rnd), np)
    assert np.array_equal(keys.numpy(), jkeys.astype(np.int64))
    m = mask_matrix(keys, _t(ids), 1, n)
    jm = jpriv.mask_matrix(jkeys, ids.astype(np.uint32), leaf_idx=1, n=n, xp=np)
    assert np.array_equal(m.numpy(), jm.astype(np.int64))
    assert not ((m + m.transpose(0, 1)) & 0xFFFFFFFF).any(), "mask(i,j) + mask(j,i) != 0"
    assert not m[torch.arange(c), torch.arange(c)].any(), "nonzero diagonal mask"


def _secagg_case(rng, c, bits, with_drops):
    fl, jfl = _fl(num_clients=max(c, 2), cohort_size=c, secagg="pairwise", secagg_bits=bits)
    deltas, jdeltas = _layered(rng, c)
    coeff = rng.uniform(0.0, 1.5, size=c).astype(np.float32)
    ids = rng.choice(100, size=c, replace=False)
    valid = rng.integers(0, 2, size=c).astype(np.float32)
    dropped = None
    if with_drops:
        # disjoint from valid: clients who dispatched masks but never shipped
        dropped = ((1.0 - valid) * rng.integers(0, 2, size=c)).astype(np.float32)
    return fl, jfl, deltas, jdeltas, coeff, ids, valid, dropped


@settings(max_examples=20, deadline=None)
@given(c=st.integers(min_value=1, max_value=6), bits=st.integers(min_value=4, max_value=24),
       rnd=st.integers(min_value=0, max_value=500), seed=st.integers(min_value=0, max_value=10_000),
       with_drops=st.booleans(), chunk=st.sampled_from([1, 3, 7, 1 << 20]))
def test_secagg_cancellation_bitwise(c, bits, rnd, seed, with_drops, chunk):
    """The masked modular aggregate == the unmasked fixed-point sum, bitwise,
    for any validity / dropout pattern and any chunk; == JAX's; the
    payloads JAX's; the chunked payloads the whole-leaf ones."""
    fl, jfl, deltas, jdeltas, coeff, ids, valid, dropped = _secagg_case(
        _rng("cancel", seed), c, bits, with_drops)
    drop_t = None if dropped is None else _t(dropped)
    got = secagg_combine(deltas, _t(coeff), _t(valid), drop_t, _t(ids), rnd, fl, chunk=chunk)
    want = secagg_reference(deltas, _t(coeff), _t(valid), fl)
    for k in deltas:
        assert torch.equal(got[k], want[k]), (k, "cancellation")
    jgot = jpriv.secagg_combine(jdeltas, coeff, valid, dropped, ids.astype(np.uint32),
                                np.uint32(rnd), jfl, np)
    assert np.array_equal(got["head"].numpy(), jgot["head"])
    for i in range(2):
        for n in ("a", "b"):
            assert np.array_equal(got[f"blocks/{i}/{n}"].numpy(), jgot["blocks"][n][i]), n
    whole = secagg_payloads(deltas, _t(coeff), _t(valid), drop_t, _t(ids), rnd, fl)
    jwhole = jpriv.secagg_payloads(jdeltas, coeff, valid, dropped, ids.astype(np.uint32),
                                   np.uint32(rnd), jfl, np)
    for (enc, pay, masks), (jenc, jpay, jmasks) in zip(whole, jwhole):
        for a, b in ((enc, jenc), (pay, jpay), (masks, jmasks)):
            assert np.array_equal(a.numpy(), b.astype(np.int64))
    # the chunked walk yields the whole-leaf encodings and payloads
    layout = {k: (li, names) for li, (_, names) in enumerate(wire_layout(deltas)) for k in names}
    for name, a, enc, pay, _ in secagg_chunks(deltas, _t(coeff), _t(valid), drop_t, _t(ids),
                                              rnd, fl, chunk=chunk):
        li, names = layout[name]
        off = sum(deltas[k][0].numel() for k in names[:names.index(name)]) + a
        assert torch.equal(enc, whole[li][0][:, off:off + enc.shape[1]])
        assert torch.equal(pay, whole[li][1][:, off:off + pay.shape[1]])


def test_secagg_payload_blinding():
    """Each client's payload differs from its encoding wherever it has a
    dispatched partner; a single-client cohort ships its encoding."""
    rng = _rng("blind", 0)
    c = 4
    fl, _ = _fl(cohort_size=c, secagg="pairwise", secagg_bits=16)
    deltas = {"w": _t(rng.uniform(-1, 1, size=(c, 8)).astype(np.float32))}
    coeff, valid = torch.full((c,), 0.25), torch.ones(c)
    ids = torch.arange(c)
    (enc, pay, _), = secagg_payloads(deltas, coeff, valid, None, ids, 3, fl)
    for i in range(c):
        assert not torch.equal(pay[i], enc[i]), f"client {i} unblinded"
    fl1, _ = _fl(cohort_size=1, secagg="pairwise", secagg_bits=16)
    (enc1, pay1, _), = secagg_payloads({"w": deltas["w"][:1]}, coeff[:1], valid[:1], None,
                                       ids[:1], 3, fl1)
    assert torch.equal(pay1, enc1)


def test_secagg_masks_change_with_round():
    fl, _ = _fl(cohort_size=2, secagg="pairwise")
    ids = torch.arange(2)
    assert not torch.equal(pair_keys(fl.seed, ids, 0), pair_keys(fl.seed, ids, 1))


# ---------------------------------------------------------------------------
# accountant: epsilon bitwise JAX's, monotonicity, closed forms, references
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(z=st.floats(min_value=0.4, max_value=4.0), q=st.floats(min_value=0.01, max_value=1.0),
       delta=st.sampled_from([1e-7, 1e-5, 1e-3]))
def test_accountant_monotone_in_rounds(z, q, delta):
    acct = RDPAccountant(noise_mult=z, sampling_rate=q, delta=delta)
    jacct = jpriv.RDPAccountant(noise_mult=z, sampling_rate=q, delta=delta)
    rounds = (0, 1, 2, 5, 20, 100, 1000)
    eps = [acct.epsilon(r) for r in rounds]
    assert eps == [jacct.epsilon(r) for r in rounds]       # bitwise: the same arithmetic
    assert eps[0] == 0.0
    assert all(b >= a for a, b in zip(eps, eps[1:])), eps
    assert all(e >= 0.0 and math.isfinite(e) for e in eps[1:]), eps


@settings(max_examples=15, deadline=None)
@given(q=st.floats(min_value=0.01, max_value=1.0), rounds=st.integers(min_value=1, max_value=500))
def test_accountant_antitone_in_noise(q, rounds):
    eps = [RDPAccountant(noise_mult=z, sampling_rate=q, delta=1e-5).epsilon(rounds)
           for z in (0.5, 1.0, 2.0, 4.0)]
    assert all(b <= a + 1e-12 for a, b in zip(eps, eps[1:])), eps


def test_rdp_full_participation_closed_form():
    orders = (2, 3, 8, 64)
    for z in (0.5, 1.0, 3.0):
        got = rdp_subsampled_gaussian(1.0, z, orders)
        np.testing.assert_allclose(got, np.asarray(orders, np.float64) / (2.0 * z * z),
                                   rtol=1e-12)


def test_rdp_matches_exact_integer_combinatorics():
    q, z = 0.1, 1.3
    orders = tuple(range(2, 33))
    got = rdp_subsampled_gaussian(q, z, orders)
    assert np.array_equal(got, jpriv.rdp_subsampled_gaussian(q, z, orders))
    for i, a in enumerate(orders):
        s = sum(math.comb(a, k) * (1 - q) ** (a - k) * q ** k
                * math.exp(k * (k - 1) / (2 * z * z)) for k in range(a + 1))
        assert math.isclose(got[i], math.log(s) / (a - 1), rel_tol=1e-10), a


def test_rdp_matches_gaussian_quadrature():
    for q, z, a in ((0.05, 1.0, 4), (0.3, 1.5, 8), (0.5, 0.9, 3)):
        x = np.linspace(-40 * z, 40 * z, 400_001)
        pdf = np.exp(-x * x / (2 * z * z)) / (z * math.sqrt(2 * math.pi))
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        moment = trapezoid(pdf * ((1 - q) + q * np.exp((2 * x - 1) / (2 * z * z))) ** a, x)
        got = float(rdp_subsampled_gaussian(q, z, (a,))[0])
        assert math.isclose(got, math.log(moment) / (a - 1), rel_tol=1e-6), (q, z, a)


def test_accountant_rejects_bad_params():
    for kw in (dict(noise_mult=0.0, sampling_rate=0.5, delta=1e-5),
               dict(noise_mult=1.0, sampling_rate=0.0, delta=1e-5),
               dict(noise_mult=1.0, sampling_rate=0.5, delta=1.0)):
        with pytest.raises(ValueError):
            RDPAccountant(**kw)
    with pytest.raises(ValueError):
        rdp_subsampled_gaussian(0.5, 1.0, (1,))


# ---------------------------------------------------------------------------
# dp mechanism: clipping, chain/driver agreement, noise
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(clip=st.floats(min_value=0.05, max_value=10.0), seed=st.integers(min_value=0, max_value=10_000))
def test_clip_bounds_norm(clip, seed):
    rng = _rng("clip", seed)
    delta = {"a": _t(rng.normal(0, 3, size=(4, 3)).astype(np.float32)),
             "b": _t(rng.normal(0, 3, size=7).astype(np.float32))}
    out, was, scale = clip_update(delta, clip)
    jout, jwas, jscale = jdp.clip_update({k: jnp.asarray(v.numpy()) for k, v in delta.items()},
                                         clip)
    assert float(was) == float(jwas)
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-6)
    for k in delta:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=1e-6, atol=1e-7)
    nrm_in = math.sqrt(sum(float((v.double() ** 2).sum()) for v in delta.values()))
    nrm_out = math.sqrt(sum(float((v.double() ** 2).sum()) for v in out.values()))
    assert nrm_out <= clip * (1 + 1e-5)
    if nrm_in <= clip:
        assert float(was) == 0.0 and float(scale) == 1.0
        for k in delta:
            assert torch.equal(out[k], delta[k])
    else:
        assert float(was) == 1.0


@settings(max_examples=10, deadline=None)
@given(c=st.integers(min_value=1, max_value=5), clip=st.floats(min_value=0.1, max_value=5.0),
       seed=st.integers(min_value=0, max_value=10_000))
def test_cohort_clip_matches_per_client(c, clip, seed):
    """The driver's [C] clip == clip_update per slot, bitwise — and bitwise
    the ``dp_clip`` transform's finalize_delta, per client and in the cohort
    step's stacked form."""
    deltas, _ = _layered(_rng("cohort", seed), c)
    fl, _ = _fl(cohort_size=c, dp="on", dp_clip=clip)
    stack, clipped, scale = dp_clip_cohort(deltas, fl)
    tfm = dp_clip_transform(None, fl)
    end = RoundEnd(x=None, y=None, delta=deltas, steps=torch.ones(c), eta=torch.ones(c),
                   momentum=None, opt=None)
    stacked_fin = tfm.finalize_delta(end, deltas)
    for i in range(c):
        one = {k: v[i] for k, v in deltas.items()}
        out_i, was_i, scale_i = clip_update(one, clip)
        assert float(was_i) == float(clipped[i]) and float(scale_i) == float(scale[i])
        fin = tfm.finalize_delta(None, one)
        for k in one:
            assert torch.equal(stack[k][i], out_i[k])
            assert torch.equal(fin[k], out_i[k])
            assert torch.equal(stacked_fin[k][i], out_i[k])


def test_dp_noise_replays_per_round_and_matches_jax():
    fl, jfl = _fl(dp="on", dp_noise_mult=1.5, dp_clip=1.0)
    agg = {"blocks/0/a": torch.zeros(2, 2), "blocks/1/a": torch.zeros(2, 2),
           "blocks/0/b": torch.zeros(3), "blocks/1/b": torch.zeros(3), "head": torch.zeros(5)}
    coeff, valid = torch.tensor([0.5, 0.25, 0.25, 0.0]), torch.tensor([1.0, 1.0, 1.0, 0.0])
    a1, s1 = add_dp_noise(agg, coeff, valid, fl, 4)
    a2, s2 = add_dp_noise(agg, coeff, valid, fl, 4)
    a3, _ = add_dp_noise(agg, coeff, valid, fl, 5)
    assert float(s1) == float(s2) == pytest.approx(0.75)
    for k in agg:
        assert torch.equal(a1[k], a2[k]) and not torch.equal(a1[k], a3[k])
    # against JAX on its stacked tree: leaf i of JAX's order, its counters
    jagg = {"blocks": {"a": jnp.zeros((2, 2, 2)), "b": jnp.zeros((2, 3))}, "head": jnp.zeros(5)}
    ja, js = jdp.add_dp_noise(jagg, jnp.asarray(coeff.numpy()), jnp.asarray(valid.numpy()), jfl,
                              jnp.int32(4))
    assert float(s1) == float(js)
    for i in range(2):
        for n in ("a", "b"):
            np.testing.assert_allclose(a1[f"blocks/{i}/{n}"].numpy(), np.asarray(ja["blocks"][n][i]),
                                       rtol=0, atol=NORMAL_ATOL * 0.75)
    np.testing.assert_allclose(a1["head"].numpy(), np.asarray(ja["head"]), rtol=0,
                               atol=NORMAL_ATOL * 0.75)
    z = torch.cat([v.reshape(-1) for v in a1.values()]) / 0.75
    assert abs(float(z.mean())) < 1.5 and 0.2 < float(z.std()) < 3.0


@pytest.mark.parametrize("rnd", [0, 3, 1 << 20])
def test_noise_uniforms_bitwise_and_normals_close_to_jax(rnd):
    """The uniforms of a leaf at counters 1000.. (a later layer of a stacked
    leaf) bitwise JAX's; the normals within NORMAL_ATOL."""
    key = noise_key(9, rnd)
    jkey = jdp.noise_key(9, jnp.int32(rnd))
    assert int(key[0]) == int(np.asarray(jkey)[0])
    lk = key_combine_torch(key, 2)
    jlk = key_combine(jkey, jnp.uint32(2), jnp)
    n, start = 4096, 1000
    u1, u2 = noise_uniforms(lk, n, start)
    ctr = jnp.arange(start, start + n, dtype=jnp.uint32)
    ka = key_combine(jlk.reshape(1), ctr, jnp)
    kb = key_combine(ka, jnp.uint32(1), jnp)
    for u, k in ((u1, ka), (u2, kb)):
        want = (fmix32(k, jnp).astype(jnp.float32) + 0.5) * jnp.float32(2.0 ** -32)
        assert np.array_equal(u.numpy(), np.asarray(want))
    z = _std_normal(lk, n, start)
    jz = np.asarray(jdp._std_normal(jlk, (start + n,)))[start:]
    np.testing.assert_allclose(z.numpy(), jz, rtol=0, atol=NORMAL_ATOL)


# ---------------------------------------------------------------------------
# resume: epsilon bitwise through save/load, mechanism drift rejected
# ---------------------------------------------------------------------------

def _quad_state(fl, rnd=0):
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=fl.num_clients)
    return strat.init({"x": _t(X0)})._replace(rnd=rnd)


def test_epsilon_bitwise_after_resume(tmp_path):
    fl, jfl = _fl(dp="on", dp_clip=0.5, dp_noise_mult=1.2, dp_delta=1e-6, num_clients=3)
    path = str(tmp_path / "ck")
    save_server_state(path, _quad_state(fl, 7), fl=fl)
    acct = accountant_for(fl)
    rec = load_metadata(path)["dp_accounting"]
    assert rec == jpriv.dp_checkpoint_record(jfl, 7)
    assert rec["rounds"] == 7 and rec["epsilon"] == acct.epsilon(7)
    restored = load_server_state(path, _quad_state(fl), fl=fl)
    assert restored.rnd == 7
    for r in (8, 20, 100):
        assert accountant_for(fl).epsilon(r) == acct.epsilon(r)


def test_resume_rejects_mechanism_drift(tmp_path):
    fl, _ = _fl(dp="on", dp_clip=0.5, dp_noise_mult=1.2, num_clients=3)
    path = str(tmp_path / "ck")
    save_server_state(path, _quad_state(fl), fl=fl)
    with pytest.raises(ValueError, match="noise_mult"):
        load_server_state(path, _quad_state(fl), fl=dataclasses.replace(fl, dp_noise_mult=2.0))
    path2 = str(tmp_path / "ck2")
    save_server_state(path2, _quad_state(fl))
    with pytest.raises(ValueError, match="dp_accounting"):
        load_server_state(path2, _quad_state(fl), fl=fl)
    load_server_state(path, _quad_state(fl), fl=fl)


def test_check_dp_resume_fields():
    fl, _ = _fl(dp="on")
    rec = dp_checkpoint_record(fl, 10)
    check_dp_resume(rec, fl)
    for key, bad in (("noise_mult", 9.0), ("clip", 9.0), ("delta", 0.5), ("sampling_rate", 0.9)):
        with pytest.raises(ValueError, match=key):
            check_dp_resume({**rec, key: bad}, fl)
    with pytest.raises(ValueError):
        check_dp_resume(None, fl)


# ---------------------------------------------------------------------------
# bind-time validation, with JAX's messages
# ---------------------------------------------------------------------------

def _same_error(kw, transform_names=()):
    fl, jfl = _fl(**kw)
    with pytest.raises(ValueError) as ei:
        validate_privacy_config(fl, transform_names=transform_names)
    with pytest.raises(ValueError) as ej:
        jpriv.validate_privacy_config(jfl, transform_names=transform_names)
    assert str(ei.value) == str(ej.value)
    return str(ei.value)


def test_validation_rejects_ambiguous_clip_composition():
    msg = _same_error(dict(dp="on"), ("clip",))
    assert "clip_norm" in msg and "dp_clip" in msg


def test_validation_rejects_bad_knobs():
    for kw, word in ((dict(dp="on", dp_clip=0.0), "dp_clip"),
                     (dict(dp="on", dp_noise_mult=0.0), "dp_noise_mult"),
                     (dict(dp="on", dp_delta=1.0), "dp_delta"),
                     (dict(secagg="pairwise", secagg_bits=31), "secagg_bits"),
                     (dict(secagg="pairwise", aggregator="coordinate_median"), "aggregator"),
                     (dict(secagg="pairwise", guard="quarantine"), "quarantine"),
                     (dict(dp="maybe"), "fl.dp")):
        assert word in _same_error(kw), kw


def test_validation_passes_valid_configs():
    validate_privacy_config(_fl(dp="on")[0], transform_names=("local_sgd",))
    validate_privacy_config(_fl(secagg="pairwise", secagg_bits=16)[0])
    validate_privacy_config(_fl(dp="on", secagg="pairwise")[0])


def test_bind_strategy_runs_privacy_validation():
    fl, _ = _fl(dp="on", local_update="local_clip")
    with pytest.raises(ValueError, match="dp_clip"):
        bind_strategy(None, fl, make_quadratic_loss(2), num_clients=fl.num_clients)
    # a chain with the dp_clip link binds; so does the plane off with bad knobs
    bind_strategy(None, _fl(dp_clip=-1.0, secagg_bits=99)[0], make_quadratic_loss(2),
                  num_clients=4)


# ---------------------------------------------------------------------------
# rounds on the quadratic
# ---------------------------------------------------------------------------


def _qkw(preset="fedshuffle", mode="vmapped", **kw):
    kw.setdefault("seed", 11)
    kw.setdefault("server_lr", 0.8)
    return dict(num_clients=3, cohort_size=2, sampling="uniform", epochs=2, local_batch=1,
                algorithm=preset, local_lr=0.05, mvr_a=0.2, cohort_mode=mode,
                drop_last_steps=1, buckets=2) | kw


def _port_rounds(kw, rounds=N_ROUNDS, engine=False, state=None, start=0):
    fl = FLConfig(**kw)
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=fl.num_clients)
    pop = Population.build(fl, sizes=TASK.sizes())
    if state is None:
        state = strat.init({"x": _t(X0)})
    if engine:
        eng = CohortEngine.build(TASK, pop, fl, device="cpu")
        step = build_round_step(LOSS, strat, fl, plane=eng.plane, device="cpu")
        with eng.round_plans(rounds - start, prefetch=2, start=start) as it:
            for _, plan in it:
                state, mets = step(state, plan)
        return state, mets
    pipe = FederatedPipeline(TASK, pop, fl)
    step = build_round_step(LOSS, strat, fl, device="cpu")
    for r in range(start, rounds):
        state, mets = step(state, pipe.round_batch(r))
    return state, mets


def _jax_rounds(kw, rounds=N_ROUNDS):
    jfl = JFL(**kw)
    jl = j_quad(3)
    pipe = JPipe(JTASK, JPop.build(jfl, sizes=JTASK.sizes()), jfl)
    strat = j_bind(j_strategy_for(jfl), jfl, jl, num_clients=jfl.num_clients)
    step = j_build_step(jl, strat, jfl, num_clients=jfl.num_clients)
    state = strat.init({"x": jnp.asarray(X0)})
    for r in range(rounds):
        state, mets = step(state, j_as_device(pipe.round_batch(r)))
    return state, mets


def _tree_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _tree_equal(a[k], b[k], f"{what}/{k}")
    else:
        assert torch.equal(a, b), what


def _runs_equal(a, b, what):
    (sa, ma), (sb, mb) = a, b
    _tree_equal(sa.params, sb.params, f"{what}: params")
    _tree_equal(sa.opt, sb.opt, f"{what}: opt")
    if sa.clients is not None:
        _tree_equal(sa.clients, sb.clients, f"{what}: bank")
    _tree_equal(ma, mb, f"{what}: metrics")


def _close_to_jax(run, jrun, what, atol=ATOL):
    (state, mets), (jstate, jmets) = run, jrun
    np.testing.assert_allclose(state.params["x"].numpy(), np.asarray(jstate.params["x"]),
                               rtol=0, atol=atol, err_msg=what)
    assert set(mets) == set(jmets), what
    for k in jmets:
        np.testing.assert_allclose(np.asarray(mets[k]), np.asarray(jmets[k]), rtol=1e-6,
                                   atol=atol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
@pytest.mark.parametrize("exec_mode", ["padded", "bucketed"])
def test_privacy_off_matches_seed_bitwise(mode, exec_mode):
    """The plane off: no key, JAX's trajectory, and the inactive knobs'
    values change no bit."""
    kw = _qkw("fedshuffle", mode, exec_mode=exec_mode)
    run = _port_rounds(kw)
    assert set(run[1]) == BASE_KEYS
    _runs_equal(run, _port_rounds(kw | dict(dp_clip=123.0, dp_noise_mult=9.0, dp_delta=0.42,
                                            secagg_bits=24)), "inactive knobs")
    _close_to_jax(run, _jax_rounds(kw), f"{mode}/{exec_mode}")


def test_privacy_metric_keys_frozen():
    assert set(_port_rounds(_qkw(**DP_ON))[1]) == BASE_KEYS | DP_KEYS
    assert set(_port_rounds(_qkw(secagg="pairwise"))[1]) == BASE_KEYS
    assert set(_port_rounds(_qkw(secagg="pairwise", **DP_ON))[1]) == BASE_KEYS | DP_KEYS


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_dp_padded_matches_bucketed_bitwise(mode):
    padded = _port_rounds(_qkw("fedshuffle", mode, exec_mode="padded", **DP_ON))
    _runs_equal(padded, _port_rounds(_qkw("fedshuffle", mode, exec_mode="bucketed", **DP_ON)),
                f"dp/{mode}")
    _close_to_jax(padded, _jax_rounds(_qkw("fedshuffle", mode, **DP_ON)), f"dp/{mode}",
                  atol=NORMAL_ATOL)


def test_dp_vmapped_matches_sequential_bitwise():
    _runs_equal(_port_rounds(_qkw("fedshuffle", "vmapped", **DP_ON)),
                _port_rounds(_qkw("fedshuffle", "sequential", **DP_ON)), "dp modes")


@pytest.mark.parametrize("exec_mode", ["padded", "bucketed"])
def test_dp_engine_matches_legacy_bitwise(exec_mode):
    kw = _qkw("fedshuffle", "vmapped", exec_mode=exec_mode, engine="cohort", **DP_ON)
    _runs_equal(_port_rounds(kw), _port_rounds(kw, engine=True), f"dp-engine/{exec_mode}")


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_secagg_padded_matches_bucketed_bitwise(mode):
    kw = _qkw("fedshuffle", mode, secagg="pairwise")
    padded = _port_rounds(kw | dict(exec_mode="padded"))
    _runs_equal(padded, _port_rounds(kw | dict(exec_mode="bucketed")), f"secagg/{mode}")
    _close_to_jax(padded, _jax_rounds(kw), f"secagg/{mode}")


def test_secagg_matches_plain_aggregation_within_quantization():
    off, _ = _port_rounds(_qkw())
    for bits, tol in ((16, 2.0 ** -12), (24, 2.0 ** -20)):
        sa, _ = _port_rounds(_qkw(secagg="pairwise", secagg_bits=bits))
        err = float((sa.params["x"] - off.params["x"]).abs().max())
        assert 0 < err <= tol, (bits, err)


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_privacy_composes_with_codec_and_buffered_fleet(mode):
    """clip -> encode -> decode -> mask -> modular sum -> noise over
    staleness-discounted coefficients, with a dropped client to recover."""
    kw = _qkw("fedshuffle", mode, uplink="qsgd", uplink_bits=8, fleet="zipf_latency",
              server_mode="buffered", buffer_size=2, staleness="poly", staleness_power=0.5,
              faults="dropout", drop_prob=0.3, secagg="pairwise", **DP_ON)
    padded = _port_rounds(kw | dict(exec_mode="padded"))
    _runs_equal(padded, _port_rounds(kw | dict(exec_mode="bucketed")), "stack")
    for key in DP_KEYS | {"mean_staleness", "uplink_mbytes"}:
        assert key in padded[1], key
    _close_to_jax(padded, _jax_rounds(kw), f"stack/{mode}", atol=NORMAL_ATOL)


def test_dp_resume_replays_noise_bitwise_and_files_cross_load(tmp_path):
    """4 straight rounds == 2 + save/load_server_state + 2, a fresh step on
    the resumed side; the DP file of either package loads in the other."""
    kw = _qkw(**DP_ON)
    fl, jfl = FLConfig(**kw), JFL(**kw)
    straight, _ = _port_rounds(kw, rounds=4)
    half, _ = _port_rounds(kw, rounds=2)
    path = str(tmp_path / "ck")
    save_server_state(path, half, fl=fl)
    resumed, _ = _port_rounds(kw, rounds=4, state=load_server_state(path, _quad_state(fl), fl=fl),
                              start=2)
    _tree_equal(straight.params, resumed.params, "resume: params")
    assert resumed.rnd == 4
    jstrat = j_bind(j_strategy_for(jfl), jfl, j_quad(3), num_clients=3)
    back = j_ckpt.load_server_state(path, jstrat.init({"x": jnp.zeros(3, jnp.float32)}), fl=jfl)
    assert np.array_equal(np.asarray(back.params["x"]), half.params["x"].numpy())
    with pytest.raises(ValueError, match="noise_mult"):
        j_ckpt.load_server_state(path, jstrat.init({"x": jnp.zeros(3, jnp.float32)}),
                                 fl=dataclasses.replace(jfl, dp_noise_mult=2.0))
    jstate, _ = _jax_rounds(kw, rounds=2)
    j_ckpt.save_server_state(str(tmp_path / "jax"), jstate, fl=jfl)
    with open(str(tmp_path / "jax.json")) as f:
        assert json.load(f)["dp_accounting"] == load_metadata(path)["dp_accounting"]
    from_jax = load_server_state(str(tmp_path / "jax"), _quad_state(fl), fl=fl)
    assert from_jax.rnd == 2
    assert np.array_equal(from_jax.params["x"].numpy(), np.asarray(jstate.params["x"]))


def test_privacy_telemetry_histogram_and_epsilon():
    """telemetry="metrics" adds the clip-scale histogram; train() folds it
    into a registry instrument and reports the accountant's epsilon, bitwise
    its pure function, on every row and in the gauge."""
    fl = FLConfig(**_qkw(telemetry="metrics", secagg="pairwise", **DP_ON))
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    res = train(LOSS, {"x": _t(X0)}, pipe, fl, N_ROUNDS, log_every=0, device="cpu")
    insts = res.registry.instruments()
    assert insts["hist_dp_scale"].total == N_ROUNDS * fl.cohort_size
    eps = [r["dp_epsilon"] for r in res.metrics.rows]
    acct = accountant_for(fl)
    assert eps == [acct.epsilon(r + 1) for r in range(N_ROUNDS)]
    assert all(e > 0 for e in eps) and all(b >= a for a, b in zip(eps, eps[1:]))
    assert insts["dp_epsilon"].value == eps[-1]


def test_no_dp_epsilon_when_plane_off():
    fl = FLConfig(**_qkw(telemetry="metrics"))
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    res = train(LOSS, {"x": _t(X0)}, pipe, fl, N_ROUNDS, log_every=0, device="cpu")
    assert all("dp_epsilon" not in r for r in res.metrics.rows)
    assert "hist_dp_scale" not in res.registry.instruments()


# ---------------------------------------------------------------------------
# CharLM-tiny with DP, secagg and telemetry through the cohort engine vs JAX
# ---------------------------------------------------------------------------

TINY_FL = dict(num_clients=8, cohort_size=4, sampling="uniform", epochs=1, local_batch=2,
               algorithm="fedshuffle", local_lr=0.05, imbalance="lognormal", mean_samples=3,
               seed=1, engine="cohort", rr_backend="device_ref", prefetch=0,
               cohort_mode="vmapped", dp="on", dp_clip=0.5, dp_noise_mult=0.01,
               secagg="pairwise", secagg_bits=20, telemetry="metrics")


def test_charlm_tiny_private_round_matches_jax():
    rounds = 2
    jfl = JFL(**TINY_FL)
    jtask = JCharLM(vocab=J_TINY.vocab, seq_len=16, num_clients=8)
    jmodel = j_build_model(J_TINY)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jloss = j_make_loss(jmodel)
    jeng = JEngine.build(jtask, JPop.build(jfl), jfl)
    jstrat = j_bind(j_strategy_for(jfl), jfl, jloss, num_clients=8)
    jstep = jax.jit(j_build_step(jloss, jstrat, jfl, num_clients=8, plane=jeng.plane))
    jstate = jstrat.init(jparams)
    for r in range(rounds):
        jstate, jm = jstep(jstate, jeng.device_plan(r))
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    cfg = ArchConfig(**{k: v for k, v in dataclasses.asdict(J_TINY).items() if k in fields})
    loss = make_loss(build_model(cfg))
    fl = FLConfig(**TINY_FL)
    eng = CohortEngine.build(CharLMTask(vocab=cfg.vocab, seq_len=16, num_clients=8),
                             Population.build(fl), fl, device="cpu")
    strat = bind_strategy(strategy_for(fl), fl, loss, num_clients=8)
    step = build_round_step(loss, strat, fl, plane=eng.plane, device="cpu")
    state = strat.init(params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    for r in range(rounds):
        state, mets = step(state, eng.device_plan(r))
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg, "cpu")
    for k, w in want.items():
        g = state.params[k].numpy()
        assert np.abs(g - w.numpy()).max() <= 1e-6 + 1e-4 * np.abs(w.numpy()).max(), k
    assert set(mets) == set(jm)
    assert float(mets["dp_sigma"]) == float(jm["dp_sigma"])
    assert float(mets["dp_clipped_frac"]) == float(jm["dp_clipped_frac"])
    for k in ("hist_steps", "hist_dp_scale"):
        assert np.array_equal(mets[k].numpy(), np.asarray(jm[k])), k
