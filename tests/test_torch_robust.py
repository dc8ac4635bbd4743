"""The PyTorch port's robustness plane (``repro_torch.fed.robust``) against
the JAX package and within the port.

* twins of ``tests/test_robust.py``: adversary masks and attack round keys
  bitwise equal to JAX's (its numpy and jnp backends), round-independent
  membership, the adversary frequency; the four attacks bitwise equal to
  JAX's on one stack (``scaled_noise``'s noise over a multi-leaf tree with
  stacked layers, keyed by JAX's leaf order); every aggregator on random
  weighted multi-leaf stacks within rtol 1e-5 / atol 1e-6 of JAX's (fp32
  sums in other orders), the weighted median and krum's selections
  identical; the breakdown-point properties — the median under a
  minority, the trimmed mean with adversarial mass strictly below
  ``trim_frac * W`` (n_adv < trim * n drawn strictly: JAX's generator
  draws n_adv = 1 where trim * n < 1, ROADMAP §3), krum picking an honest
  client; ``mean`` bitwise ``weighted_sum``; zero-coefficient slots inert;
  scrub + renormalize against NaN; norm / centered clipping; the guard
  primitives (quarantine masks, suspicion ratios, renormalized mass,
  ``params_ok`` / ``select_state``) against JAX's; the config surface and
  registrars;
* krum's threshold search as the JAX package runs it: its first int32
  midpoint wraps, so every valid partner counts in the score (ROADMAP §3,
  "Facts about the reference"); the port's scores equal that sum;
* twins of ``tests/test_robust_equivalence.py`` on the duplicated
  quadratic: the plane off keeps the metric keys and matches JAX
  (FedShuffle; ``tests/test_torch_fleet.py`` holds both planes off over the
  preset grid); the three
  plane keys; each aggregator under attack with quarantine padded ==
  bucketed bitwise in both modes and within atol 1e-6 of JAX; engine
  (prefetch on) == legacy bitwise; the whole stack (attack -> qsgd -> quarantine
  -> trimmed mean over staleness-discounted buffered coefficients) layout-
  equal and against JAX; quarantine healing a scaled attack; the reject
  guard keeping params and opt and, with a bank, restoring the cohort's
  rows bitwise while ``rnd`` advances; the train loop's per-round plane
  counters equal to JAX's;
* CharLM-tiny under a sign flip with trimmed mean and quarantine through
  the cohort engine against JAX (each leaf within atol 1e-6 + rtol 1e-4
  of its largest magnitude).

JAX's ``test_single_compilation_robust`` waits for compiled round steps
(ROADMAP item 2); ``test_robust_telemetry_histogram_and_counters`` (the
suspicion histogram) is held in ``tests/test_torch_obs.py``, its counters
half here too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.paper_tasks import CHARLM_TINY as J_TINY  # noqa: E402
from repro.data.federated import ClientMeta as JMeta  # noqa: E402
from repro.data.federated import FederatedPipeline as JPipe  # noqa: E402
from repro.data.federated import Population as JPop  # noqa: E402
from repro.data.tasks import CharLMTask as JCharLM  # noqa: E402
from repro.data.tasks import DuplicatedQuadraticTask as JDup  # noqa: E402
from repro.fed import robust as jrobust  # noqa: E402
from repro.fed.cohort import CohortEngine as JEngine  # noqa: E402
from repro.fed.losses import make_loss as j_make_loss  # noqa: E402
from repro.fed.losses import make_quadratic_loss as j_quad  # noqa: E402
from repro.fed.robust import attacks as jattacks  # noqa: E402
from repro.fed.robust import guards as jguards  # noqa: E402
from repro.fed.robust.aggregators import _krum_scores as j_krum_scores  # noqa: E402
from repro.fed.rounds import as_device_batch as j_as_device  # noqa: E402
from repro.fed.rounds import build_round_step as j_build_step  # noqa: E402
from repro.fed.server import ServerState as JState  # noqa: E402
from repro.fed.strategy import bind_strategy as j_bind  # noqa: E402
from repro.fed.strategy import strategy_for as j_strategy_for  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig  # noqa: E402
from repro_torch.data.federated import ClientMeta, FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import CharLMTask, DuplicatedQuadraticTask  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.losses import make_loss, make_quadratic_loss  # noqa: E402
from repro_torch.fed.robust import (ATTACKS, GUARDS, ROBUST_AGGS, adversary_mask,  # noqa: E402
                                    attack_round_keys, build_attack, build_robust_aggregate,
                                    register_attack, register_robust_agg, robust_active,
                                    scrub_deltas, validate_robust_config)
from repro_torch.fed.robust.aggregators import _krum_scores, _pairwise_sqdists  # noqa: E402
from repro_torch.fed.robust.guards import (GROWTH_LIMIT, SPIKE_MULT, params_ok,  # noqa: E402
                                           quarantine_masks, renormalize_coeffs, select_state,
                                           suspicion_ratio)
from repro_torch.fed.rounds import build_round_step  # noqa: E402
from repro_torch.fed.server import ServerState  # noqa: E402
from repro_torch.fed.strategy import bind_strategy, strategy_for, weighted_sum  # noqa: E402
from repro_torch.fed.train_loop import train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils.pytree import tree_map, wire_layout  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402

TASK = DuplicatedQuadraticTask(copies=(1, 2, 3))
JTASK = JDup(copies=(1, 2, 3))
LOSS = make_quadratic_loss(3)
X0 = np.array([0.3, -0.1, 0.2], np.float32)
N_ROUNDS = 3
ATOL = 1e-6
BASE_KEYS = {"local_loss", "delta_norm", "cohort"}
ROBUST_KEYS = {"quarantined_clients", "suspected_adversaries", "rounds_rejected"}
UNDER_ATTACK = dict(attack="sign_flip", attack_frac=0.4, attack_scale=5.0,
                    aggregator="trimmed_mean", trim_frac=0.3, guard="full")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (the suite runs a test process on each of several
    cores at once), and TF32 off for krum's Gram products."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(n)
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _ufl(**kw):
    kw = dict(num_clients=8, cohort_size=4, sampling="uniform", epochs=1, local_batch=2) | kw
    return FLConfig(**kw), JFL(**kw)


def _meta(valid, ids=None):
    valid = np.asarray(valid, np.float32)
    C = valid.shape[0]
    ids = np.arange(C) if ids is None else np.asarray(ids)
    one = np.ones(C, np.float32)
    port = ClientMeta(*[torch.from_numpy(a.copy()) for a in
                        (one / C, one, one, one, one, one, valid)],
                      client_id=torch.from_numpy(ids.astype(np.int64)))
    jax_meta = JMeta(weight=jnp.asarray(one / C), prob=jnp.asarray(one),
                     num_samples=jnp.asarray(one), epochs=jnp.asarray(one),
                     num_steps=jnp.asarray(one), num_steps_planned=jnp.asarray(one),
                     valid=jnp.asarray(valid), client_id=jnp.asarray(ids.astype(np.int32)))
    return port, jax_meta


def _stack(values):
    """A one-leaf [C, 2] delta dict where each client ships a constant."""
    v = np.asarray(values, np.float32)
    return {"x": torch.from_numpy(np.stack([v, v], axis=1))}


def _agg(name, deltas, coeff, meta, **fl_kw):
    fl, _ = _ufl(aggregator=name, **fl_kw)
    return build_robust_aggregate(fl)(deltas, torch.as_tensor(np.asarray(coeff, np.float32)),
                                      meta)


def _jagg(name, deltas, coeff, meta, **fl_kw):
    _, jfl = _ufl(aggregator=name, **fl_kw)
    return jrobust.build_robust_aggregate(jfl)(
        {k: jnp.asarray(v.numpy()) for k, v in deltas.items()},
        jnp.asarray(np.asarray(coeff, np.float32)), meta)


# ---------------------------------------------------------------------------
# adversary draws and attack keys: bitwise equal to JAX's
# ---------------------------------------------------------------------------


def test_adversary_mask_matches_jax_and_replays():
    ids = np.arange(64)
    m = adversary_mask(7, torch.from_numpy(ids), 0.3).numpy()
    np.testing.assert_array_equal(m, jattacks.adversary_mask(7, ids.astype(np.uint32), 0.3, xp=np))
    np.testing.assert_array_equal(m, np.asarray(jattacks.adversary_mask(7, jnp.asarray(ids), 0.3)))
    assert set(np.unique(m)) <= {0.0, 1.0}
    np.testing.assert_array_equal(adversary_mask(7, [3, 17, 42], 0.3).numpy(), m[[3, 17, 42]])
    assert adversary_mask(7, ids, 0.0).sum() == 0
    wider = adversary_mask(7, ids, 0.9).numpy()
    assert np.all(wider >= m) and wider.sum() > m.sum()
    assert not np.array_equal(m, adversary_mask(8, ids, 0.3).numpy())
    # padding slots (-1) hash as 0xFFFFFFFF, as JAX's uint32 cast does
    pad = np.array([-1, 5, -1], np.int64)
    np.testing.assert_array_equal(adversary_mask(3, pad, 0.5).numpy(),
                                  np.asarray(jattacks.adversary_mask(3, jnp.asarray(pad, jnp.int32),
                                                                     0.5)))


def test_attack_round_keys_match_jax_and_vary_by_round():
    ids = np.array([0, 1, 2, 7, -1, 2**20])
    k0 = attack_round_keys(3, ids, 0).numpy()
    assert not np.array_equal(k0, attack_round_keys(3, ids, 1).numpy())
    for rnd in (0, 1, 2**31 - 1):
        want = np.asarray(jattacks.attack_round_keys(3, jnp.asarray(ids, jnp.int32),
                                                     jnp.asarray(rnd, jnp.int32)))
        np.testing.assert_array_equal(attack_round_keys(3, ids, rnd).numpy(), want.astype(np.int64))


@settings(max_examples=15, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1), frac=st.floats(0.05, 0.95))
def test_adversary_mask_frequency(seed, frac):
    ids = np.arange(2048)
    m = adversary_mask(seed, ids, frac).numpy()
    assert abs(m.mean() - frac) < 0.08
    np.testing.assert_array_equal(m, jattacks.adversary_mask(seed, ids.astype(np.uint32), frac,
                                                             xp=np))


# ---------------------------------------------------------------------------
# attacks over a hand-built stack
# ---------------------------------------------------------------------------


def _apply(name, deltas, adv, scale=1.0, rnd=0, seed=0, valid=None):
    fl, jfl = _ufl(attack=name, attack_frac=0.5, attack_scale=scale, seed=seed)
    C = len(adv)
    meta, jmeta = _meta(np.ones(C) if valid is None else valid)
    keys = attack_round_keys(fl.seed, meta.client_id, rnd)
    out = ATTACKS[name](deltas, torch.as_tensor(np.asarray(adv, np.float32)), meta, keys, fl)
    jkeys = jattacks.attack_round_keys(jfl.seed, jmeta.client_id, jnp.uint32(rnd))
    # the [C] stack in JAX's layout: a stacked leaf [C, L, ...]
    jdeltas = params_to_jax(deltas, axis=1)
    jout = jattacks.ATTACKS[name](jax.tree.map(jnp.asarray, jdeltas),
                                  jnp.asarray(np.asarray(adv, np.float32)), jmeta, jkeys, jfl)
    return out, params_from_jax(jax.tree.map(np.asarray, jout), None, "cpu", axis=1)


def test_sign_flip_and_zero_update_match_jax():
    vals, adv = [1.0, 2.0, 3.0, 4.0], [0, 1, 0, 1]
    out, want = _apply("sign_flip", _stack(vals), adv, scale=2.0)
    np.testing.assert_array_equal(out["x"][:, 0].numpy(), [1.0, -4.0, 3.0, -8.0])
    assert torch.equal(out["x"], want["x"])
    out, want = _apply("zero_update", _stack(vals), adv)
    np.testing.assert_array_equal(out["x"][:, 0].numpy(), [1.0, 0.0, 3.0, 0.0])
    assert torch.equal(out["x"], want["x"])


def _layered_stack(C=6, seed=0):
    """A [C]-stacked tree with stacked-layer leaves (blocks/{i}/...), as the
    port keys a model: the noise must follow JAX's leaf order and layout."""
    rng = np.random.default_rng(seed)
    shapes = {"blocks/0/attn/wq": (3, 4), "blocks/1/attn/wq": (3, 4), "blocks/0/norm": (4,),
              "blocks/1/norm": (4,), "embed": (5, 4), "lm_head": (4, 5)}
    return {k: torch.from_numpy(rng.standard_normal((C, *s)).astype(np.float32))
            for k, s in shapes.items()}


def test_scaled_noise_matches_jax_bounded_and_round_keyed():
    deltas = _layered_stack()
    assert [p for p, _ in wire_layout(deltas)][0] == "blocks/attn/wq"
    adv = np.ones(6, np.float32)
    n0, want0 = _apply("scaled_noise", deltas, adv, scale=3.0, rnd=0, seed=1)
    n1, want1 = _apply("scaled_noise", deltas, adv, scale=3.0, rnd=1, seed=1)
    for k in deltas:
        assert torch.equal(n0[k], want0[k]) and torch.equal(n1[k], want1[k]), k
        assert n0[k].abs().max() <= 3.0
    assert not torch.equal(n0["embed"], n1["embed"])
    again, _ = _apply("scaled_noise", deltas, adv, scale=3.0, rnd=0, seed=1)
    assert all(torch.equal(n0[k], again[k]) for k in deltas)


def test_ipm_ships_negated_honest_mean():
    out, want = _apply("ipm", _stack([1.0, 3.0, 100.0]), [0, 0, 1], scale=0.5)
    np.testing.assert_allclose(out["x"][0, 0].item(), 1.0)
    np.testing.assert_allclose(out["x"][2, 0].item(), -0.5 * 2.0)
    np.testing.assert_allclose(out["x"].numpy(), want["x"].numpy(), rtol=1e-6)


def test_build_attack_none_and_unknown():
    assert build_attack(_ufl()[0]) is None
    with pytest.raises(ValueError, match="unknown attack"):
        build_attack(_ufl(attack="bogus")[0])


def test_build_attack_masks_adversaries_by_validity():
    fl, _ = _ufl(attack="sign_flip", attack_frac=0.9, attack_scale=2.0, seed=3)
    meta, _ = _meta([1, 1, 0, 1, 0, 1], ids=[4, 9, -1, 2, 7, 5])
    out = build_attack(fl)(_stack([1.0] * 6), meta, 0)["x"][:, 0].numpy()
    adv = adversary_mask(fl.seed, meta.client_id, fl.attack_frac).numpy() * meta.valid.numpy()
    np.testing.assert_array_equal(out, np.where(adv > 0, -2.0, 1.0))
    assert out[2] == 1.0 and out[4] == 1.0                    # invalid slots untouched


# ---------------------------------------------------------------------------
# aggregators: against JAX, and the breakdown-point properties
# ---------------------------------------------------------------------------


def _random_stack(C, seed, outliers=()):
    rng = np.random.default_rng(seed)
    d = {"a": rng.standard_normal((C, 7)).astype(np.float32),
         "b": rng.standard_normal((C, 3, 4)).astype(np.float32)}
    for c in outliers:
        d["a"][c] *= 50.0
        d["b"][c] *= -50.0
    # ties across slots: equal values with unequal weights test the stable sort
    d["a"][:, 0] = 0.25
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("name", sorted(ROBUST_AGGS))
def test_aggregators_match_jax_on_weighted_stacks(name):
    for seed, C, valid in ((0, 8, [1] * 8), (1, 6, [1, 1, 0, 1, 1, 1]), (2, 5, [1] * 5)):
        deltas = _random_stack(C, seed, outliers=(1,))
        rng = np.random.default_rng(seed + 10)
        coeff = rng.uniform(0.2, 2.0, C).astype(np.float32) * np.asarray(valid, np.float32)
        meta, jmeta = _meta(valid)
        out = _agg(name, deltas, coeff, meta, trim_frac=0.25)
        want = _jagg(name, deltas, coeff, jmeta, trim_frac=0.25)
        for k in deltas:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}/{seed}/{k}")
            if name in ("coordinate_median", "krum"):
                # a selected value times W: identical selections
                W = np.float32(coeff.sum())
                np.testing.assert_allclose(out[k].numpy() / W, np.asarray(want[k]) / W,
                                           rtol=1e-6, err_msg=f"{name}/{seed}/{k}")


@pytest.mark.parametrize("seed", range(6))
def test_krum_scores_and_selections_equal_jax(seed):
    """The reference's threshold search wraps at its first int32 midpoint,
    so each score is the sum over every valid partner; the port's scores,
    neighbor count and selections are JAX's."""
    C = 8
    valid = np.ones(C, np.float32)
    valid[seed % C] = 0.0 if seed % 2 else 1.0
    deltas = _random_stack(C, seed, outliers=(seed % 3, 5))
    coeff = torch.from_numpy(valid * np.linspace(0.5, 1.5, C).astype(np.float32))
    scores, k = _krum_scores(deltas, coeff, 0.25)
    jd = {kk: jnp.asarray(v.numpy()) for kk, v in deltas.items()}
    jscores, jk = j_krum_scores(jd, jnp.asarray(coeff.numpy()), 0.25)
    assert int(k) == int(jk)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5)
    assert int(torch.argmin(scores)) == int(jnp.argmin(jscores))
    order = torch.sort(scores, stable=True).indices[:int(k)].tolist()
    assert order == np.asarray(jnp.argsort(jscores))[:int(jk)].tolist()
    dist = _pairwise_sqdists(deltas).double().numpy()
    m = valid > 0
    want = np.where(m, (dist * np.outer(m, m) * (1 - np.eye(C))).sum(axis=1), np.inf)
    np.testing.assert_allclose(np.where(m, scores.numpy(), np.inf), want, rtol=1e-5)


@settings(max_examples=20, deadline=None, database=None)
@given(v=st.floats(-5.0, 5.0), bad=st.floats(50.0, 1e4), n_honest=st.integers(3, 10),
       n_adv=st.integers(1, 3), low_side=st.booleans())
def test_median_recovers_honest_value_under_minority(v, bad, n_honest, n_adv, low_side):
    if n_adv * 2 >= n_honest + n_adv:
        n_adv = (n_honest - 1) // 2
    vals = [v] * n_honest + [(-bad if low_side else bad)] * n_adv
    n = len(vals)
    out = _agg("coordinate_median", _stack(vals), np.ones(n), _meta(np.ones(n))[0])
    np.testing.assert_allclose(out["x"].numpy(), v * n, rtol=1e-5, atol=1e-5)


@settings(max_examples=20, deadline=None, database=None)
@given(v=st.floats(-5.0, 5.0), bad=st.floats(100.0, 1e4), n=st.integers(6, 12),
       trim=st.floats(0.15, 0.4), low_side=st.booleans())
def test_trimmed_mean_recovers_honest_value_below_trim(v, bad, n, trim, low_side):
    """Adversarial coefficient mass strictly below trim_frac * W lands
    outside the central window.  n_adv < trim * n strictly; where trim * n
    <= 1 that allows no adversary, and the honest value must come back."""
    n_adv = int(np.ceil(trim * n)) - 1                   # the largest n_adv < trim * n
    assert n_adv < trim * n
    vals = [v] * (n - n_adv) + [(-bad if low_side else bad)] * n_adv
    out = _agg("trimmed_mean", _stack(vals), np.ones(n), _meta(np.ones(n))[0], trim_frac=trim)
    np.testing.assert_allclose(out["x"].numpy(), v * n, rtol=1e-4, atol=1e-4)


@settings(max_examples=20, deadline=None, database=None)
@given(v=st.floats(-3.0, 3.0), spread=st.floats(0.0, 0.1), bad=st.floats(50.0, 1e4),
       n_honest=st.integers(5, 10), n_adv=st.integers(1, 2))
def test_krum_selects_an_honest_client(v, spread, bad, n_honest, n_adv):
    rng = np.random.default_rng(0)
    honest = v + spread * rng.standard_normal(n_honest)
    vals = list(honest) + [bad * (i + 1) for i in range(n_adv)]
    n = len(vals)
    meta, _ = _meta(np.ones(n))
    out = _agg("krum", _stack(vals), np.ones(n), meta, trim_frac=0.25)
    got = out["x"][0].item() / n
    assert np.min(np.abs(got - honest)) < 1e-5
    mk = _agg("multi_krum", _stack(vals), np.ones(n), meta, trim_frac=0.25)["x"][0].item() / n
    assert honest.min() - 1e-4 <= mk <= honest.max() + 1e-4


def test_mean_is_canonical_weighted_sum():
    rng = np.random.default_rng(1)
    deltas = {"a": torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal((5, 2, 2)).astype(np.float32))}
    coeff = rng.uniform(0, 2, 5).astype(np.float32)
    out = _agg("mean", deltas, coeff, _meta(np.ones(5))[0])
    ref = weighted_sum(deltas, torch.from_numpy(coeff))
    assert all(torch.equal(out[k], ref[k]) for k in deltas)


def test_aggregators_respect_zero_coefficient_slots():
    vals = [1.0, 1.0, 1.0, 1e8]
    coeff = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    meta = _meta([1, 1, 1, 0])[0]
    for name in sorted(ROBUST_AGGS):
        out = _agg(name, _stack(vals), coeff, meta, trim_frac=0.2)
        np.testing.assert_allclose(out["x"].numpy(), 3.0, rtol=1e-5, err_msg=name)


def test_scrub_then_aggregate_neutralizes_nonfinite():
    deltas, (meta, jmeta) = _stack([1.0, 1.0, 1.0, np.nan]), _meta(np.ones(4))
    healthy, _ = quarantine_masks(deltas, meta)
    np.testing.assert_array_equal(healthy.numpy(), [1, 1, 1, 0])
    coeff = renormalize_coeffs(torch.ones(4), healthy)
    scrubbed = scrub_deltas(deltas, healthy)
    assert torch.isfinite(scrubbed["x"]).all()
    for name in sorted(ROBUST_AGGS):
        out = build_robust_aggregate(_ufl(aggregator=name, trim_frac=0.2)[0])(
            scrubbed, coeff, meta)
        np.testing.assert_allclose(out["x"].numpy(), 4.0, rtol=1e-5, err_msg=name)


def test_norm_clip_bounds_outlier_influence():
    out = _agg("norm_clip", _stack([1.0, 1.0, 1.0, 1000.0]), np.ones(4), _meta(np.ones(4))[0])
    assert (out["x"] <= 4.0 + 1e-4).all()


def test_centered_clip_tracks_honest_center():
    out = _agg("centered_clip", _stack([2.0, 2.0, 2.0, 2.0, 1e4]), np.ones(5),
               _meta(np.ones(5))[0])
    assert abs(out["x"][0].item() / 5.0 - 2.0) < 1.0


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_quarantine_flags_nonfinite_and_spikes():
    vals = [1.0, 1.1, 0.9, 100.0, np.nan]
    deltas = _stack(vals)
    meta, jmeta = _meta(np.ones(5))
    healthy, suspected = quarantine_masks(deltas, meta)
    np.testing.assert_array_equal(healthy.numpy(), [1, 1, 1, 0, 0])
    np.testing.assert_array_equal(suspected.numpy(), [0, 0, 0, 1, 0])
    ratio = suspicion_ratio(deltas, meta).numpy()
    assert ratio[3] > SPIKE_MULT and ratio[4] == 1e9 and np.all(ratio[:3] < SPIKE_MULT)
    jd = {"x": jnp.asarray(deltas["x"].numpy())}
    jh, js = jguards.quarantine_masks(jd, jmeta)
    np.testing.assert_array_equal(healthy.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(suspected.numpy(), np.asarray(js))
    np.testing.assert_allclose(ratio, np.asarray(jguards.suspicion_ratio(jd, jmeta)), rtol=1e-6)


@settings(max_examples=20, deadline=None, database=None)
@given(coeffs=st.lists(st.floats(0.01, 5.0), min_size=2, max_size=12), drop=st.integers(0, 10))
def test_renormalize_preserves_total_mass(coeffs, drop):
    cf = np.asarray(coeffs, np.float32)
    healthy = np.ones(len(cf), np.float32)
    healthy[: min(drop, len(cf) - 1)] = 0.0
    out = renormalize_coeffs(torch.from_numpy(cf), torch.from_numpy(healthy)).numpy()
    np.testing.assert_allclose(out.sum(), cf.sum(), rtol=1e-5)
    assert np.all(out[healthy == 0] == 0.0)
    # the totals are fp32 sums in other orders: within rtol 1e-6
    np.testing.assert_allclose(
        out, np.asarray(jguards.renormalize_coeffs(jnp.asarray(cf), jnp.asarray(healthy))),
        rtol=1e-6)


def test_renormalize_all_quarantined_degrades_to_zero():
    np.testing.assert_array_equal(renormalize_coeffs(torch.ones(4), torch.zeros(4)).numpy(),
                                  np.zeros(4))


def test_params_ok_and_select_state():
    prev = ServerState(params={"x": torch.ones(3)}, opt={"m": {"x": torch.zeros(3)}}, rnd=4)
    good = ServerState(params={"x": torch.full((3,), 2.0)}, opt={"m": {"x": torch.full((3,), 0.5)}},
                       rnd=5)
    blown = good._replace(params={"x": torch.full((3,), GROWTH_LIMIT * 10)})
    naned = good._replace(params={"x": torch.tensor([1.0, float("nan"), 1.0])})
    assert bool(params_ok(prev.params, good.params))
    assert not bool(params_ok(prev.params, blown.params))
    assert not bool(params_ok(prev.params, naned.params))
    for p in (good, blown, naned):
        want = jguards.params_ok({"x": jnp.asarray(prev.params["x"].numpy())},
                                 {"x": jnp.asarray(p.params["x"].numpy())})
        assert bool(params_ok(prev.params, p.params)) == bool(want)
    kept = select_state(params_ok(prev.params, blown.params), blown, prev)
    assert torch.equal(kept.params["x"], torch.ones(3))
    assert torch.equal(kept.opt["m"]["x"], torch.zeros(3)) and kept.rnd == 5
    took = select_state(params_ok(prev.params, good.params), good, prev)
    assert torch.equal(took.params["x"], torch.full((3,), 2.0))
    jkept = jguards.select_state(jnp.asarray(False), JState(
        params={"x": jnp.full(3, 7.0)}, opt={}, rnd=jnp.asarray(5)), JState(
        params={"x": jnp.ones(3)}, opt={}, rnd=jnp.asarray(4)))
    assert int(jkept.rnd) == kept.rnd


# ---------------------------------------------------------------------------
# config surface + registries
# ---------------------------------------------------------------------------


def test_robust_active_and_validate():
    assert not robust_active(_ufl()[0])
    assert robust_active(_ufl(attack="sign_flip", attack_frac=0.2)[0])
    assert robust_active(_ufl(aggregator="krum")[0])
    assert robust_active(_ufl(guard="full")[0])
    validate_robust_config(_ufl(attack="ipm", attack_frac=0.3, aggregator="trimmed_mean",
                                trim_frac=0.35, guard="full")[0])
    for bad in (dict(attack="bogus", attack_frac=0.2), dict(attack="sign_flip", attack_frac=0.0),
                dict(attack="sign_flip", attack_frac=1.5),
                dict(attack="sign_flip", attack_frac=0.2, attack_scale=0.0),
                dict(aggregator="bogus"), dict(aggregator="trimmed_mean", trim_frac=0.0),
                dict(aggregator="krum", trim_frac=0.5), dict(guard="bogus")):
        fl, jfl = _ufl(**bad)
        with pytest.raises(ValueError):
            validate_robust_config(fl)
        with pytest.raises(ValueError):
            jrobust.validate_robust_config(jfl)
    assert "off" in GUARDS and "mean" in ROBUST_AGGS and "ipm" in ATTACKS


def test_bind_strategy_validates_robust():
    fl, _ = _ufl(aggregator="trimmed_mean", trim_frac=0.9, algorithm="fedavg")
    with pytest.raises(ValueError, match="trim_frac"):
        bind_strategy(strategy_for(fl), fl, LOSS, num_clients=fl.num_clients)


def test_robust_registrars_refuse_duplicates():
    with pytest.raises(ValueError, match="overwrite=True"):
        register_attack("sign_flip", object())
    with pytest.raises(ValueError, match="overwrite=True"):
        register_robust_agg("mean", object())
    register_attack("sign_flip", ATTACKS["sign_flip"], overwrite=True)
    register_robust_agg("mean", ROBUST_AGGS["mean"], overwrite=True)


# ---------------------------------------------------------------------------
# rounds on the quadratic
# ---------------------------------------------------------------------------


def _qkw(preset="fedshuffle", mode="vmapped", **kw):
    kw.setdefault("seed", 11)
    kw.setdefault("server_lr", 0.8)
    return dict(num_clients=3, cohort_size=2, sampling="uniform", epochs=2, local_batch=1,
                algorithm=preset, local_lr=0.05, mvr_a=0.2, cohort_mode=mode,
                drop_last_steps=1, buckets=2) | kw


def _port_rounds(kw, rounds=N_ROUNDS, engine=False, collect=False):
    fl = FLConfig(**kw)
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=fl.num_clients)
    pop = Population.build(fl, sizes=TASK.sizes())
    state = strat.init({"x": torch.from_numpy(X0.copy())})
    rows = []
    if engine:
        eng = CohortEngine.build(TASK, pop, fl, device="cpu")
        step = build_round_step(LOSS, strat, fl, plane=eng.plane, device="cpu")
        with eng.round_plans(rounds, prefetch=2) as it:
            for _, plan in it:
                state, mets = step(state, plan)
        return state, mets
    pipe = FederatedPipeline(TASK, pop, fl)
    step = build_round_step(LOSS, strat, fl, device="cpu")
    for r in range(rounds):
        state, mets = step(state, pipe.round_batch(r))
        rows.append({k: float(v) for k, v in mets.items()})
    return (state, rows) if collect else (state, mets)


def _jax_rounds(kw, rounds=N_ROUNDS, collect=False):
    jfl = JFL(**kw)
    jl = j_quad(3)
    pipe = JPipe(JTASK, JPop.build(jfl, sizes=JTASK.sizes()), jfl)
    strat = j_bind(j_strategy_for(jfl), jfl, jl, num_clients=jfl.num_clients)
    step = j_build_step(jl, strat, jfl, num_clients=jfl.num_clients)
    state = strat.init({"x": jnp.asarray(X0)})
    rows = []
    for r in range(rounds):
        state, mets = step(state, j_as_device(pipe.round_batch(r)))
        rows.append({k: float(v) for k, v in mets.items()})
    return (state, rows) if collect else (state, mets)


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


def _close_to_jax(run, jrun, what):
    (state, mets), (jstate, jmets) = run, jrun
    np.testing.assert_allclose(state.params["x"].numpy(), np.asarray(jstate.params["x"]),
                               rtol=0, atol=ATOL, err_msg=what)
    assert set(mets) == set(jmets), what
    for k in jmets:
        np.testing.assert_allclose(float(mets[k]), float(jmets[k]), rtol=1e-6, atol=ATOL,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
@pytest.mark.parametrize("exec_mode", ["padded", "bucketed"])
def test_robust_off_matches_jax_and_adds_no_keys(mode, exec_mode):
    """Both planes off is one configuration: tests/test_torch_fleet.py holds
    it against JAX over the preset grid; here FedShuffle."""
    kw = _qkw("fedshuffle", mode, exec_mode=exec_mode)
    run = _port_rounds(kw)
    assert set(run[1]) == BASE_KEYS
    _close_to_jax(run, _jax_rounds(kw), f"{mode}/{exec_mode}")


def test_robust_metric_keys():
    _, mets = _port_rounds(_qkw(**UNDER_ATTACK))
    assert set(mets) == BASE_KEYS | ROBUST_KEYS
    _, mets = _port_rounds(_qkw(aggregator="coordinate_median"))
    assert set(mets) == BASE_KEYS | ROBUST_KEYS
    assert float(mets["quarantined_clients"]) == 0.0 and float(mets["rounds_rejected"]) == 0.0


@pytest.mark.parametrize("aggregator", sorted(set(ROBUST_AGGS) - {"mean"}))
@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_robust_agg_padded_matches_bucketed_bitwise(aggregator, mode):
    kw = dict(attack="sign_flip", attack_frac=0.4, attack_scale=5.0, aggregator=aggregator,
              trim_frac=0.3, guard="quarantine")
    padded = _port_rounds(_qkw("fedshuffle", mode, exec_mode="padded", **kw))
    _runs_equal(padded, _port_rounds(_qkw("fedshuffle", mode, exec_mode="bucketed", **kw)),
                f"{aggregator}/{mode}")
    _close_to_jax(padded, _jax_rounds(_qkw("fedshuffle", mode, **kw)), f"{aggregator}/{mode}")


@pytest.mark.parametrize("exec_mode", ["padded", "bucketed"])
def test_robust_engine_matches_legacy_bitwise(exec_mode):
    kw = _qkw(exec_mode=exec_mode, engine="cohort", **UNDER_ATTACK)
    _runs_equal(_port_rounds(kw), _port_rounds(kw, engine=True), exec_mode)


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_robust_composes_with_codec_and_buffered_fleet(mode):
    kw = dict(uplink="qsgd", uplink_bits=8, fleet="zipf_latency", server_mode="buffered",
              buffer_size=2, staleness="poly", staleness_power=0.5, **UNDER_ATTACK)
    padded = _port_rounds(_qkw("fedshuffle", mode, exec_mode="padded", **kw))
    _runs_equal(padded, _port_rounds(_qkw("fedshuffle", mode, exec_mode="bucketed", **kw)),
                "stack")
    for key in ROBUST_KEYS | {"mean_staleness", "uplink_mbytes"}:
        assert key in padded[1], key
    _close_to_jax(padded, _jax_rounds(_qkw("fedshuffle", mode, **kw)), f"stack/{mode}")


def test_train_loop_carries_the_plane_counters():
    kw = _qkw(**UNDER_ATTACK)
    fl = FLConfig(**kw)
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    rows = train(LOSS, {"x": torch.from_numpy(X0.copy())}, pipe, fl, N_ROUNDS, log_every=0,
                 device="cpu").metrics.rows
    _, jrows = _jax_rounds(kw, collect=True)
    for r, jr in zip(rows, jrows):
        for k in ROBUST_KEYS:
            assert r[k] == jr[k], k


def test_quarantine_heals_scaled_attack_round():
    kw = _qkw(attack="sign_flip", attack_frac=0.35, attack_scale=200.0, guard="quarantine", seed=7)
    _, rows = _port_rounds(kw, collect=True)
    assert sum(r["quarantined_clients"] for r in rows) > 0
    assert all(r["suspected_adversaries"] == r["quarantined_clients"] for r in rows)
    _, jrows = _jax_rounds(kw, collect=True)
    assert [r["quarantined_clients"] for r in rows] == [r["quarantined_clients"] for r in jrows]


def test_reject_guard_skips_blown_round_and_advances():
    kw = _qkw(attack="sign_flip", attack_frac=0.99, attack_scale=1e8, aggregator="mean",
              guard="reject", server_lr=1.0)
    state, rows = _port_rounds(kw, collect=True)
    assert all(r["rounds_rejected"] == 1.0 for r in rows)
    assert torch.equal(state.params["x"], torch.from_numpy(X0)) and state.rnd == N_ROUNDS
    state_ng, _ = _port_rounds(kw | dict(guard="off"))
    assert state_ng.params["x"].abs().max() > 1e3
    _, jrows = _jax_rounds(kw, collect=True)
    assert [r["rounds_rejected"] for r in jrows] == [r["rounds_rejected"] for r in rows]


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_reject_guard_restores_the_bank_rows(mode):
    """The port commits the bank in place: a rejected round writes the
    cohort's gathered rows back (EF residuals, SCAFFOLD's variates and the
    fleet counters of a buffered run), bitwise the round's input."""
    kw = _qkw("fedavg", mode, attack="sign_flip", attack_frac=0.99, attack_scale=1e8,
              aggregator="mean", guard="reject", server_lr=1.0, server_opt="scaffold",
              uplink="topk", uplink_frac=0.5, fleet="zipf_latency", server_mode="buffered",
              buffer_size=2)
    fl = FLConfig(**kw)
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=3)
    step = build_round_step(LOSS, strat, fl, device="cpu")
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    state = strat.init({"x": torch.from_numpy(X0.copy())})
    before = tree_map(torch.clone, {"p": state.params, "o": state.opt, "b": state.clients})
    bank = state.clients
    state, mets = step(state, pipe.round_batch(0))
    assert float(mets["rounds_rejected"]) == 1.0 and state.rnd == 1
    assert state.clients is bank
    _tree_equal({"p": state.params, "o": state.opt, "b": state.clients}, before, "rejected")


# ---------------------------------------------------------------------------
# CharLM-tiny under attack through the cohort engine vs JAX
# ---------------------------------------------------------------------------

TINY_FL = dict(num_clients=8, cohort_size=4, sampling="uniform", epochs=1, local_batch=2,
               algorithm="fedshuffle", local_lr=0.05, imbalance="lognormal", mean_samples=3,
               seed=1, engine="cohort", rr_backend="device_ref", prefetch=0,
               cohort_mode="vmapped", attack="sign_flip", attack_frac=0.3, attack_scale=4.0,
               aggregator="trimmed_mean", trim_frac=0.25, guard="full")


def test_charlm_tiny_under_attack_matches_jax():
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
    for k in ROBUST_KEYS:
        assert float(mets[k]) == float(jm[k]), k
