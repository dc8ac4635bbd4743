"""The PyTorch port's fleet plane (``repro_torch.fed.fleet``) against the JAX
package and within the port.

* twins of ``tests/test_fleet.py``: every extension registry's
  ``overwrite=True`` escape hatch; the fleet models' arrays, the counter-based
  draws, wall times and deadline caps, and the three fault scenarios bitwise
  equal to JAX's (numpy both sides); the bind-time refusals; the buffered
  virtual clock's ticks (ids, probs, staleness, arrival offsets, dropped
  records, clocks) bitwise equal to JAX's over hypothesis-drawn seeds, plus
  its invariants (monotone events, every event an arrival or a drop,
  concurrency M kept, replay in any order) and a stress test of the lock
  that guards it (threads asking for ticks at once get the sequential
  schedule's ticks); staleness weights within rtol 1e-6 of JAX's (fp32
  powers), buffered coefficients discounted;
* the pipeline's fleet hooks bitwise equal to JAX's: index plans (meta
  fields, masks) of the sync fleet and of buffered ticks, and the bucket
  layout with the abort caps folded in;
* twins of ``tests/test_fleet_equivalence.py`` on the duplicated quadratic:
  the plane off keeps the metric keys and matches JAX (every grid preset x
  both modes x both layouts, atol 1e-6); with a sync fleet or the buffered
  server, padded == bucketed and engine (prefetch on) == legacy bitwise
  within the port, the fleet bank included, and each run against JAX
  (atol 1e-6; the counters exactly); scaffold + topk EF + the fleet
  counters share one bank; the metric keys; the train loop's cumulative
  ``virtual_time``; a buffered run saved after 2 ticks in the JAX file
  format and resumed is bitwise the 4-tick run, and JAX's file loads; the
  cohort engine's ``fleet``;
* CharLM-tiny, the buffered server over a zipf-latency fleet with dropout,
  through the cohort engine against JAX (each leaf within atol 1e-6 + rtol 1e-4 of its
  largest magnitude).

JAX's ``test_single_compilation_buffered`` waits for compiled round steps
(ROADMAP item 2): the port runs its rounds eagerly and has no compile to
count.
"""
import dataclasses
import sys
import threading

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
from repro.fed import fleet as jfleet  # noqa: E402
from repro.fed.cohort import CohortEngine as JEngine  # noqa: E402
from repro.fed.losses import make_loss as j_make_loss  # noqa: E402
from repro.fed.losses import make_quadratic_loss as j_quad  # noqa: E402
from repro.fed.rounds import as_device_batch as j_as_device  # noqa: E402
from repro.fed.rounds import build_round_step as j_build_step  # noqa: E402
from repro.fed.strategy import bind_strategy as j_bind  # noqa: E402
from repro.fed.strategy import strategy_for as j_strategy_for  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.utils import checkpoint as j_ckpt  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig  # noqa: E402
from repro_torch.core.algorithms import agg_coeff  # noqa: E402
from repro_torch.data.federated import ClientMeta, FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import CharLMTask, DuplicatedQuadraticTask  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.fleet import (FAULTS, FLEET_STATE_KEY, FLEETS, BufferedSchedule,  # noqa: E402
                                   apply_faults, build_fleet, fleet_active, fleet_uniform,
                                   staleness_weights, validate_fleet_config)
from repro_torch.fed.fleet.model import SUB_DROPOUT, SUB_STRAGGLER  # noqa: E402
from repro_torch.fed.losses import make_loss, make_quadratic_loss  # noqa: E402
from repro_torch.fed.rounds import build_round_step  # noqa: E402
from repro_torch.fed.strategy import bind_strategy, strategy_for  # noqa: E402
from repro_torch.fed.train_loop import train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils.checkpoint import load_server_state, save_server_state  # noqa: E402
from repro_torch.weights import params_from_jax, server_state_from_jax  # noqa: E402

TASK = DuplicatedQuadraticTask(copies=(1, 2, 3))
JTASK = JDup(copies=(1, 2, 3))
LOSS = make_quadratic_loss(3)
X0 = np.array([0.3, -0.1, 0.2], np.float32)
N_ROUNDS = 3
ATOL = 1e-6
GRID_PRESETS = ["fedshuffle", "fednova", "fedavg_min"]

# a sync fleet configuration exercising every built-in fault scenario
SYNC_FLEET = dict(fleet="tiered", fleet_tiers=3, tier_spread=4.0, tier_latency=1.0,
                  faults="dropout,straggler,abort", drop_prob=0.25, straggler_prob=0.3,
                  straggler_factor=4.0, round_deadline=12.0)
BUFFERED = dict(fleet="zipf_latency", server_mode="buffered", buffer_size=2,
                staleness="poly", staleness_power=0.5, faults="dropout", drop_prob=0.2)
FLEET_KEYS = {"round_virtual_time", "arrived_clients", "dropped_clients", "mean_staleness"}
BASE_KEYS = {"local_loss", "delta_norm", "cohort"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ufl(**kw):
    """The unit tests' config (tests/test_fleet.py's ``_fl``)."""
    kw = dict(num_clients=16, cohort_size=4, sampling="uniform", epochs=2, local_batch=2) | kw
    return FLConfig(**kw), JFL(**kw)


def _qkw(preset="fedshuffle", mode="vmapped", **kw):
    """The quadratic rounds' config (tests/test_fleet_equivalence.py's)."""
    return dict(num_clients=3, cohort_size=2, sampling="uniform", epochs=2, local_batch=1,
                algorithm=preset, local_lr=0.05, server_lr=0.8, mvr_a=0.2, cohort_mode=mode,
                drop_last_steps=1, seed=11, buckets=2) | kw


def _port_rounds(kw, rounds=N_ROUNDS, engine=False, prefetch=2, state=None, start=0):
    fl = FLConfig(**kw)
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=fl.num_clients)
    pop = Population.build(fl, sizes=TASK.sizes())
    if engine:
        eng = CohortEngine.build(TASK, pop, fl, device="cpu")
        step = build_round_step(LOSS, strat, fl, plane=eng.plane, device="cpu")
    else:
        pipe = FederatedPipeline(TASK, pop, fl)
        step = build_round_step(LOSS, strat, fl, device="cpu")
    if state is None:
        state = strat.init({"x": torch.from_numpy(X0.copy())})
    mets = None
    if engine:
        with eng.round_plans(rounds - start, prefetch=prefetch, start=start) as it:
            for _, plan in it:
                state, mets = step(state, plan)
    else:
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


def _states_equal(a, b, what):
    _tree_equal(a.params, b.params, f"{what}: params")
    _tree_equal(a.opt, b.opt, f"{what}: opt")
    assert (a.clients is None) == (b.clients is None), what
    if a.clients is not None:
        _tree_equal(a.clients, b.clients, f"{what}: bank")
    assert a.rnd == b.rnd, what


def _mets_equal(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def _close_to_jax(state, mets, jstate, jmets, what, bank=True):
    np.testing.assert_allclose(state.params["x"].numpy(), np.asarray(jstate.params["x"]),
                               rtol=0, atol=ATOL, err_msg=what)
    for k, tree in jstate.opt.items():
        np.testing.assert_allclose(state.opt[k]["x"].numpy(), np.asarray(tree["x"]), rtol=0,
                                   atol=ATOL, err_msg=f"{what}: {k}")
    assert set(mets) == set(jmets), what
    for k in jmets:
        np.testing.assert_allclose(float(mets[k]), float(jmets[k]), rtol=1e-6, atol=ATOL,
                                   err_msg=f"{what}: {k}")
    if bank and jstate.clients is not None and "fleet" in jstate.clients:
        for f in ("arrivals", "stale_sum"):
            np.testing.assert_array_equal(state.clients["fleet"][f].numpy(),
                                          np.asarray(jstate.clients["fleet"][f]), err_msg=f)


# ---------------------------------------------------------------------------
# registrars: every registry refuses duplicates and accepts overwrite=True
# ---------------------------------------------------------------------------


def _registrar_cases():
    from repro_torch.core.algorithms import (C_KINDS, Q_KINDS, W_KINDS, register_c_kind,
                                             register_q_kind, register_w_kind)
    from repro_torch.core.local import CLIENT_TRANSFORMS, register_client_transform
    from repro_torch.fed.cohort.scheduler import PARTICIPATION, register_participation
    from repro_torch.fed.comm.codecs import CODECS, register_codec
    from repro_torch.fed.fleet import register_fault, register_fleet
    from repro_torch.fed.strategy import LOCAL_UPDATES, register_local_update

    dummy = object()
    return [
        ("fleet", FLEETS, lambda n, o: register_fleet(n, dummy, overwrite=o)),
        ("fault", FAULTS, lambda n, o: register_fault(n, dummy, overwrite=o)),
        ("participation", PARTICIPATION, lambda n, o: register_participation(n, dummy, overwrite=o)),
        ("codec", CODECS, lambda n, o: register_codec(n, dummy, overwrite=o)),
        ("client_transform", CLIENT_TRANSFORMS,
         lambda n, o: register_client_transform(n, dummy, overwrite=o)),
        ("local_update", LOCAL_UPDATES, lambda n, o: register_local_update(n, dummy, overwrite=o)),
        ("c_kind", C_KINDS, lambda n, o: register_c_kind(n, dummy, overwrite=o)),
        ("w_kind", W_KINDS, lambda n, o: register_w_kind(n, dummy, overwrite=o)),
        ("q_kind", Q_KINDS, lambda n, o: register_q_kind(n, dummy, overwrite=o)),
    ]


@pytest.mark.parametrize("kind,registry,reg", _registrar_cases(),
                         ids=[c[0] for c in _registrar_cases()])
def test_registrar_overwrite_escape_hatch(kind, registry, reg):
    name = f"_test_overwrite_{kind}"
    assert name not in registry
    try:
        reg(name, False)
        with pytest.raises(ValueError, match="overwrite=True"):
            reg(name, False)
        reg(name, True)
    finally:
        registry.pop(name, None)


def test_register_server_opt_and_strategy_overwrite():
    from repro_torch.core.algorithms import GenSpec
    from repro_torch.fed.strategy import (SERVER_OPTS, STRATEGIES, FedStrategy, ServerOpt,
                                          register_server_opt, register_strategy)

    opt = ServerOpt("_test_overwrite_opt", lambda fl, p: {}, lambda *a: None)
    try:
        register_server_opt(opt)
        with pytest.raises(ValueError, match="overwrite=True"):
            register_server_opt(opt)
        register_server_opt(opt, overwrite=True)
    finally:
        SERVER_OPTS.pop(opt.name, None)
    strat = FedStrategy(name="_test_overwrite_strat", gen=GenSpec(c="one", w="w", q="p"))
    try:
        register_strategy(strat)
        with pytest.raises(ValueError, match="overwrite=True"):
            register_strategy(strat)
        register_strategy(strat, overwrite=True)
    finally:
        STRATEGIES.pop(strat.name, None)


# ---------------------------------------------------------------------------
# fleet models, draws and faults: bitwise equal to JAX's
# ---------------------------------------------------------------------------


def _fleets(**kw):
    fl, jfl = _ufl(**kw)
    return build_fleet(fl, Population.build(fl)), jfleet.build_fleet(jfl, JPop.build(jfl)), fl, jfl


def _same_fleet(a, b):
    for f in ("tier", "speed", "latency"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f


def test_fleet_off_by_default():
    fl, _ = _ufl()
    assert not fleet_active(fl)
    assert build_fleet(fl, Population.build(fl)) is None
    # the cohort engine exposes its pipeline's fleet (None with the plane off)
    kw = _qkw(engine="cohort")
    pop = Population.build(FLConfig(**kw), sizes=TASK.sizes())
    assert CohortEngine.build(TASK, pop, FLConfig(**kw), device="cpu").fleet is None
    eng = CohortEngine.build(TASK, pop, FLConfig(**kw, **SYNC_FLEET), device="cpu")
    assert eng.fleet is eng.pipeline.fleet and eng.fleet.name == "tiered"


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_fleet_models_match_jax_and_are_deterministic(name):
    m, jm, fl, _ = _fleets(fleet=name, faults="dropout", drop_prob=0.1)
    n = fl.num_clients
    assert m.tier.shape == m.speed.shape == m.latency.shape == (n,)
    assert (m.speed > 0).all() and (m.latency >= 0).all()
    _same_fleet(m, jm)
    _same_fleet(m, build_fleet(fl, Population.build(fl)))


def test_tiered_fleet_ranges():
    m, jm, _, _ = _fleets(fleet="tiered", fleet_tiers=4, tier_spread=8.0)
    assert m.tier.min() >= 0 and m.tier.max() <= 3
    assert m.speed.max() <= 1.0 and m.speed.min() >= 1.0 / 8.0
    _same_fleet(m, jm)


def test_zipf_latency_tail_capped():
    m, jm, _, _ = _fleets(fleet="zipf_latency", zipf_alpha=0.5, tier_latency=2.0)
    assert (m.latency >= 2.0).all() and (m.latency <= 2.0 * 256.0).all()
    assert (m.speed == 1.0).all()
    _same_fleet(m, jm)


def test_fleet_uniform_matches_jax_stateless_and_domain_separated():
    ids = np.arange(10)
    a = fleet_uniform(7, ids, 3, SUB_DROPOUT)
    np.testing.assert_array_equal(a, fleet_uniform(7, ids, 3, SUB_DROPOUT))
    assert (a != fleet_uniform(7, ids, 3, SUB_STRAGGLER)).any()
    assert (a >= 0).all() and (a < 1).all()
    for seed, rnd, sub in ((7, 3, SUB_DROPOUT), (2**31 - 1, 2**32 - 1, SUB_STRAGGLER), (0, 0, 0)):
        np.testing.assert_array_equal(fleet_uniform(seed, np.arange(64), rnd, sub),
                                      jfleet.fleet_uniform(seed, np.arange(64), rnd, sub))


def test_wall_time_and_deadline_caps_inverse():
    m, jm, fl, _ = _fleets(fleet="tiered", fleet_tiers=3)
    ids = np.arange(fl.num_clients)
    caps = m.deadline_caps(20.0)
    np.testing.assert_array_equal(caps, jm.deadline_caps(20.0))
    fits = caps >= 1
    assert (m.wall_time(ids[fits], caps[fits]) <= 20.0 + 1e-9).all()
    assert (m.wall_time(ids, caps + 1) > 20.0 - 1e-9).all()
    np.testing.assert_array_equal(m.wall_time(ids, caps), jm.wall_time(ids, caps))


def _same_faults(rf, jrf):
    for f in ("wall", "dropped", "steps_cap"):
        np.testing.assert_array_equal(getattr(rf, f), getattr(jrf, f), err_msg=f)


def test_dropout_marks_expected_fraction():
    m, jm, fl, jfl = _fleets(num_clients=4000, faults="dropout", drop_prob=0.3)
    rf = apply_faults(fl, m, np.arange(4000), 5, np.full(4000, 10))
    assert 0.25 < rf.dropped.mean() < 0.35
    _same_faults(rf, apply_faults(fl, m, np.arange(4000), 5, np.full(4000, 10)))
    _same_faults(rf, jfleet.apply_faults(jfl, jm, np.arange(4000), 5, np.full(4000, 10)))


def test_straggler_multiplies_wall_times():
    m, jm, fl, jfl = _fleets(num_clients=2000, faults="straggler", straggler_prob=0.5,
                             straggler_factor=8.0)
    base = m.wall_time(np.arange(2000), np.full(2000, 10))
    rf = apply_faults(fl, m, np.arange(2000), 0, np.full(2000, 10))
    hit = rf.wall > base * 4.0
    assert 0.4 < hit.mean() < 0.6
    np.testing.assert_allclose(rf.wall[hit], base[hit] * 8.0)
    np.testing.assert_allclose(rf.wall[~hit], base[~hit])
    _same_faults(rf, jfleet.apply_faults(jfl, jm, np.arange(2000), 0, np.full(2000, 10)))


def test_abort_caps_steps_and_drops_unreachable():
    m, jm, fl, jfl = _fleets(fleet="tiered", fleet_tiers=4, tier_spread=16.0, tier_latency=8.0,
                             faults="abort", round_deadline=10.0)
    ids = np.arange(fl.num_clients)
    rf = apply_faults(fl, m, ids, 0, np.full(len(ids), 100))
    caps = m.deadline_caps(10.0)
    np.testing.assert_array_equal(rf.dropped, caps < 1)
    assert (rf.wall <= 10.0).all()
    np.testing.assert_array_equal(rf.steps_cap, np.maximum(caps, 1))
    _same_faults(rf, jfleet.apply_faults(jfl, jm, ids, 0, np.full(len(ids), 100)))


def test_validate_fleet_config_rejects_bad_knobs():
    for kw, msg in [
        (dict(fleet="nope"), "unknown fleet"),
        (dict(faults="dropout", drop_prob=0.0), "drop_prob"),
        (dict(faults="straggler", straggler_prob=0.5, straggler_factor=0.5), "straggler_factor"),
        (dict(faults="abort"), "round_deadline"),
        (dict(faults="nope"), "unknown fault"),
        (dict(server_mode="async"), "server_mode"),
        (dict(staleness="exp"), "staleness"),
        (dict(server_mode="buffered", buffer_size=8, cohort_size=4), "cannot exceed"),
        (dict(server_mode="buffered", buffer_size=2, cohort_size=16, num_clients=16),
         "cohort_size [+] buffer_size - 1"),
        (dict(server_mode="buffered", buffer_size=2, sampling="full"), "sampling='full'"),
        (dict(server_mode="buffered", buffer_size=2, algorithm="fedavg_min"), "equalized"),
    ]:
        fl, jfl = _ufl(**kw)
        with pytest.raises(ValueError, match=msg):
            validate_fleet_config(fl)
        with pytest.raises(ValueError, match=msg):
            jfleet.validate_fleet_config(jfl)
    # binding validates the plane too, before any round runs
    fl = FLConfig(**_qkw(fleet="nope", server_mode="buffered"))
    with pytest.raises(ValueError, match="unknown fleet"):
        bind_strategy(strategy_for(fl), fl, LOSS, num_clients=3)


# ---------------------------------------------------------------------------
# the buffered virtual clock
# ---------------------------------------------------------------------------


def _schedules(num_clients=24, cohort_size=8, buffer_size=4, fleet="zipf_latency", faults="",
               seed=3, **kw):
    fl, jfl = _ufl(num_clients=num_clients, cohort_size=cohort_size, buffer_size=buffer_size,
                   server_mode="buffered", fleet=fleet, faults=faults, seed=seed, **kw)
    probs = np.full(num_clients, cohort_size / num_clients)

    def steps(cid, rnd):
        return 5 + (cid % 3)

    pop, jpop = Population.build(fl), JPop.build(jfl)
    return (fl, BufferedSchedule(fl, pop, build_fleet(fl, pop), probs=probs, steps_fn=steps),
            jfleet.BufferedSchedule(jfl, jpop, jfleet.build_fleet(jfl, jpop), probs=probs,
                                    steps_fn=steps))


def _same_tick(a, b, what=""):
    for f in ("ids", "probs", "staleness", "arrive", "dropped_ids", "dropped_arrive"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{what}{f}")
    assert (a.duration, a.clock) == (b.duration, b.clock), what


@settings(max_examples=12, deadline=None, database=None)
@given(seed=st.integers(0, 1000), buffer_size=st.integers(1, 8), drop=st.booleans())
def test_clock_ticks_match_jax_and_event_times_monotone(seed, buffer_size, drop):
    fl, sched, jsched = _schedules(buffer_size=buffer_size, seed=seed,
                                   faults="dropout" if drop else "",
                                   drop_prob=0.25 if drop else 0.0)
    for t in range(6):
        _same_tick(sched.tick(t), jsched.tick(t), f"tick {t}: ")
    assert sched.events == jsched.events
    times = [t for t, *_ in sched.events]
    assert all(a <= b for a, b in zip(times, times[1:]))
    clocks = [sched.tick(t).clock for t in range(6)]
    assert all(a <= b for a, b in zip(clocks, clocks[1:]))
    assert all(sched.tick(t).duration >= 0 for t in range(6))


@settings(max_examples=12, deadline=None, database=None)
@given(seed=st.integers(0, 1000), drop=st.booleans())
def test_clock_every_event_arrives_or_drops(seed, drop):
    fl, sched, _ = _schedules(seed=seed, faults="dropout" if drop else "",
                              drop_prob=0.3 if drop else 0.0, fleet="tiered")
    T = 5
    ticks = [sched.tick(t) for t in range(T)]
    for tk in ticks:
        assert len(tk.ids) == fl.buffer_size
        assert (tk.staleness >= 0).all()
        assert len(set(tk.ids.tolist())) == len(tk.ids)
    n_events = sum(len(t.ids) + len(t.dropped_ids) for t in ticks)
    kinds = [k for _, k, *_ in sched.events[:n_events]]
    assert kinds.count("arrive") == T * fl.buffer_size
    assert kinds.count("drop") == sum(len(t.dropped_ids) for t in ticks)
    assert len(sched._in_flight) == fl.cohort_size
    assert sched.dispatched == fl.cohort_size + n_events
    if not drop:
        assert all(len(t.dropped_ids) == 0 for t in ticks)


@settings(max_examples=8, deadline=None, database=None)
@given(seed=st.integers(0, 1000))
def test_clock_replay_is_deterministic(seed):
    _, a, _ = _schedules(seed=seed, faults="dropout", drop_prob=0.2)
    _, b, _ = _schedules(seed=seed, faults="dropout", drop_prob=0.2)
    a.tick(4)
    for t in (3, 0, 4, 2):
        _same_tick(a.tick(t), b.tick(t))


def test_clock_lock_serializes_concurrent_ticks():
    """Threads asking for ticks at once (the prefetch thread and the main
    thread) advance the schedule under its lock: every answer is the tick
    the schedule computes alone, in order."""
    _, ref, _ = _schedules(faults="dropout", drop_prob=0.2)
    want = [ref.tick(t) for t in range(40)]
    _, sched, _ = _schedules(faults="dropout", drop_prob=0.2)
    got: dict = {}
    errors = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(w):
            try:
                for t in range(w % 5, 40, 3):
                    got.setdefault(t, []).append(sched.tick(t))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    for t, outs in got.items():
        for out in outs:
            _same_tick(out, want[t], f"tick {t}: ")
    assert sched.dispatched == ref.dispatched


# ---------------------------------------------------------------------------
# staleness weighting and buffered coefficients
# ---------------------------------------------------------------------------


def _meta(staleness, valid=None, cls=ClientMeta, conv=torch.as_tensor):
    C = len(staleness)
    v = np.ones(C) if valid is None else np.asarray(valid, float)
    f32 = lambda a: conv(np.asarray(a, np.float32))  # noqa: E731
    return cls(weight=f32(np.full(C, 1.0 / C)), prob=f32(np.full(C, 0.5)),
               num_samples=f32(np.full(C, 4.0)), epochs=f32(np.full(C, 2.0)),
               num_steps=f32(np.full(C, 3.0)), num_steps_planned=f32(np.full(C, 3.0)),
               valid=f32(v), client_id=conv(np.arange(C)), staleness=f32(staleness),
               arrive_time=f32(np.zeros(C)), dropped=f32(np.zeros(C)))


@settings(max_examples=20, deadline=None, database=None)
@given(power=st.floats(0.0, 3.0), stal=st.lists(st.floats(0.0, 50.0), min_size=1, max_size=8))
def test_staleness_weights_contract(power, stal):
    fl, jfl = _ufl(staleness="constant")
    np.testing.assert_array_equal(staleness_weights(fl, _meta(stal)).numpy(), np.ones(len(stal)))
    fl, jfl = _ufl(staleness="poly", staleness_power=power)
    w = staleness_weights(fl, _meta(stal)).numpy()
    assert ((w > 0) & (w <= 1.0)).all()
    np.testing.assert_allclose(w, (1.0 + np.asarray(stal, np.float32)) ** -power, rtol=1e-5)
    jw = np.asarray(jfleet.staleness_weights(jfl, _meta(stal, cls=JMeta, conv=jnp.asarray)))
    np.testing.assert_allclose(w, jw, rtol=1e-6)
    np.testing.assert_array_equal(staleness_weights(fl, _meta([0.0] * 3)).numpy(), np.ones(3))


def test_staleness_weights_default_for_fleetless_meta():
    fl, _ = _ufl(staleness="poly")
    w = staleness_weights(fl, _meta([5.0, 1.0])._replace(staleness=None))
    np.testing.assert_array_equal(w.numpy(), np.ones(2))


def test_buffered_agg_coeffs_are_staleness_discounted():
    kw = dict(num_clients=16, cohort_size=4, sampling="uniform", epochs=2, local_batch=2,
              server_mode="buffered", buffer_size=4, fleet="zipf_latency",
              algorithm="fedshuffle", staleness="poly", staleness_power=0.5)
    fl = FLConfig(**kw)
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=fl.num_clients)
    meta = _meta([0.0, 2.0, 5.0, 1.0])
    got = strat.agg_coeffs(meta).numpy()
    base = agg_coeff(strat.gen, meta, num_clients=16, cohort_size=fl.buffer_size).numpy()
    np.testing.assert_allclose(got, base * staleness_weights(fl, meta).numpy(), rtol=1e-6)
    assert got[0] == base[0]                             # tau = 0: undiscounted
    jfl = JFL(**kw)
    jstrat = j_bind(j_strategy_for(jfl), jfl, j_quad(3), num_clients=16)
    want = np.asarray(jstrat.agg_coeffs(_meta([0.0, 2.0, 5.0, 1.0], cls=JMeta, conv=jnp.asarray)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the pipeline's fleet hooks, bitwise equal to JAX's
# ---------------------------------------------------------------------------

PLAN_CONFIGS = {
    "sync": dict(num_clients=24, cohort_size=6, epochs=1, epochs_max=3, local_batch=2,
                 buckets=4, **SYNC_FLEET),
    "buffered": dict(num_clients=24, cohort_size=6, epochs=1, epochs_max=3, local_batch=2,
                     buckets=4, fleet="tiered", server_mode="buffered", buffer_size=4,
                     faults="dropout,abort", drop_prob=0.3, round_deadline=8.0),
}


@pytest.mark.parametrize("name", sorted(PLAN_CONFIGS))
def test_index_plans_and_bucket_layout_match_jax(name):
    kw = dict(sampling="uniform", algorithm="fedshuffle", seed=5) | PLAN_CONFIGS[name]
    fl, jfl = FLConfig(**kw), JFL(**kw)
    pipe = FederatedPipeline(None, Population.build(fl), fl)
    jpipe = JPipe(None, JPop.build(jfl), jfl)
    assert pipe.cohort_slots == jpipe.cohort_slots
    assert pipe.bucket_layout == jpipe.bucket_layout
    assert len(pipe.bucket_layout.edges) > 1
    dropped = 0
    for r in range(6):
        p, jp = pipe.index_plan(r, with_idx=True), jpipe.index_plan(r, with_idx=True)
        np.testing.assert_array_equal(p.idx, jp.idx)
        np.testing.assert_array_equal(p.step_mask, jp.step_mask)
        for f in ClientMeta._fields:
            np.testing.assert_array_equal(getattr(p.meta, f), getattr(jp.meta, f), err_msg=f)
        dropped += int(p.meta.dropped.sum())
        b, jb = pipe.bucketize(p), jpipe.bucketize(jp)
        np.testing.assert_array_equal(b.pos, jb.pos)
        for x, y in zip(b.buckets, jb.buckets):
            np.testing.assert_array_equal(x.step_mask, y.step_mask)
            np.testing.assert_array_equal(x.slots, y.slots)
    assert dropped > 0


def test_abort_caps_fold_into_the_bucket_layout():
    kw = dict(num_clients=64, cohort_size=8, sampling="uniform", epochs=4, local_batch=1,
              imbalance="equal", mean_samples=4, buckets=4, fleet="tiered", fleet_tiers=3,
              tier_spread=4.0, faults="abort", round_deadline=9.0, algorithm="fedshuffle")
    fl, jfl = FLConfig(**kw), JFL(**kw)
    pipe = FederatedPipeline(None, Population.build(fl), fl)
    caps = pipe.fleet.deadline_caps(9.0)
    # equal data: without the caps every client runs 16 steps, one bucket
    assert pipe.bucket_layout == JPipe(None, JPop.build(jfl), jfl).bucket_layout
    assert len(pipe.bucket_layout.edges) > 1
    assert pipe.bucket_layout.edges[0] == max(1, int(caps.min()))
    unfolded = FederatedPipeline(None, Population.build(fl), dataclasses.replace(
        fl, faults="", fleet="homogeneous")).bucket_layout
    assert unfolded.edges == (16,)


# ---------------------------------------------------------------------------
# rounds on the quadratic: the plane off, sync faults, the buffered server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
@pytest.mark.parametrize("exec_mode", ["padded", "bucketed"])
def test_fleet_off_matches_jax_and_adds_no_keys(mode, exec_mode):
    for preset in GRID_PRESETS:
        kw = _qkw(preset, mode, exec_mode=exec_mode)
        state, mets = _port_rounds(kw)
        assert set(mets) == BASE_KEYS and state.clients is None, preset
        _close_to_jax(state, mets, *_jax_rounds(kw), f"{preset}/{mode}/{exec_mode}")


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_sync_fleet_padded_matches_bucketed_bitwise(mode):
    for preset in GRID_PRESETS:
        sp, mp = _port_rounds(_qkw(preset, mode, exec_mode="padded", **SYNC_FLEET))
        sb, mb = _port_rounds(_qkw(preset, mode, exec_mode="bucketed", **SYNC_FLEET))
        _states_equal(sp, sb, f"{preset}/{mode}")
        _mets_equal(mp, mb, f"{preset}/{mode}")
        _close_to_jax(sp, mp, *_jax_rounds(_qkw(preset, mode, **SYNC_FLEET)), preset)


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
@pytest.mark.parametrize("exec_mode", ["padded", "bucketed"])
def test_sync_fleet_engine_matches_legacy_bitwise(mode, exec_mode):
    kw = _qkw("fedshuffle", mode, exec_mode=exec_mode, engine="cohort", **SYNC_FLEET)
    ls, lm = _port_rounds(kw)
    es, em = _port_rounds(kw, engine=True)
    _states_equal(ls, es, f"{mode}/{exec_mode}")
    _mets_equal(lm, em, f"{mode}/{exec_mode}")


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_buffered_padded_matches_bucketed_bitwise_and_jax(mode):
    sp, mp = _port_rounds(_qkw("fedshuffle", mode, exec_mode="padded", **BUFFERED))
    sb, mb = _port_rounds(_qkw("fedshuffle", mode, exec_mode="bucketed", **BUFFERED))
    _states_equal(sp, sb, mode)
    _mets_equal(mp, mb, mode)
    _close_to_jax(sp, mp, *_jax_rounds(_qkw("fedshuffle", mode, **BUFFERED)), mode)


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_buffered_engine_matches_legacy_bitwise(mode):
    kw = _qkw("fedshuffle", mode, engine="cohort", **BUFFERED)
    ls, lm = _port_rounds(kw)
    es, em = _port_rounds(kw, engine=True)
    _states_equal(ls, es, mode)
    _mets_equal(lm, em, mode)


def test_buffered_merged_bank_with_stateful_chain_and_ef_codec():
    kw = _qkw("fedavg", "vmapped", server_opt="scaffold", uplink="topk", uplink_frac=0.5,
              **BUFFERED)
    sp, _ = _port_rounds(kw | dict(exec_mode="padded"))
    sb, _ = _port_rounds(kw | dict(exec_mode="bucketed"))
    assert set(sp.clients) == {"scaffold", "uplink", FLEET_STATE_KEY}
    _states_equal(sp, sb, "merged bank")
    arrivals = sp.clients["fleet"]["arrivals"].numpy()
    assert arrivals.sum() == N_ROUNDS * 2 and arrivals[-1] == 0.0
    js, jm = _jax_rounds(kw)
    np.testing.assert_array_equal(arrivals, np.asarray(js.clients["fleet"]["arrivals"]))
    np.testing.assert_allclose(sp.params["x"].numpy(), np.asarray(js.params["x"]), atol=ATOL)


def test_buffered_metrics_surface():
    kw = _qkw("fedshuffle", "vmapped", **BUFFERED)
    state, mets = _port_rounds(kw)
    assert set(mets) == BASE_KEYS | FLEET_KEYS
    assert float(mets["arrived_clients"]) == 2.0 and float(mets["round_virtual_time"]) > 0.0
    assert float(mets["mean_staleness"]) >= 0.0
    _close_to_jax(state, mets, *_jax_rounds(kw), "buffered")


def test_sync_fleet_metrics_surface_and_degenerate_staleness():
    kw = _qkw("fedshuffle", "vmapped", **SYNC_FLEET)
    state, mets = _port_rounds(kw)
    assert set(mets) == BASE_KEYS | FLEET_KEYS and state.clients is None
    assert float(mets["mean_staleness"]) == 0.0
    assert float(mets["arrived_clients"]) + float(mets["dropped_clients"]) <= 2.0
    _close_to_jax(state, mets, *_jax_rounds(kw), "sync fleet")


def test_train_loop_accumulates_virtual_time():
    fl = FLConfig(**_qkw("fedshuffle", "vmapped", **BUFFERED))
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    rows = train(LOSS, {"x": torch.from_numpy(X0.copy())}, pipe, fl, N_ROUNDS, log_every=0,
                 device="cpu").metrics.rows
    vt = [r["virtual_time"] for r in rows]
    np.testing.assert_allclose(vt, np.cumsum([r["round_virtual_time"] for r in rows]), rtol=1e-6)
    assert all(b >= a for a, b in zip(vt, vt[1:]))
    fl0 = FLConfig(**_qkw("fedshuffle", "vmapped"))
    rows0 = train(LOSS, {"x": torch.from_numpy(X0.copy())},
                  FederatedPipeline(TASK, Population.build(fl0, sizes=TASK.sizes()), fl0), fl0,
                  1, log_every=0, device="cpu").metrics.rows
    assert "virtual_time" not in rows0[0]


def test_buffered_resume_is_bitwise_and_reads_jax_files(tmp_path):
    kw = _qkw("fedshuffle", "vmapped", engine="cohort", **BUFFERED)
    full, _ = _port_rounds(kw, rounds=4, engine=True)
    half, _ = _port_rounds(kw, rounds=2, engine=True)
    path = str(tmp_path / "state")
    save_server_state(path, half)
    fl = FLConfig(**kw)
    template = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=3).init(
        {"x": torch.zeros(3)})
    restored = load_server_state(path, template)
    _states_equal(restored, half, "restored")
    resumed, _ = _port_rounds(kw, rounds=4, engine=True, state=restored, start=2)
    _states_equal(resumed, full, "resumed")
    # the JAX package's 2-tick state file, and the port's read back by JAX
    jfl = JFL(**kw)
    jstrat = j_bind(j_strategy_for(jfl), jfl, j_quad(3), num_clients=3)
    jstate, _ = _jax_rounds(kw, rounds=2)
    j_ckpt.save_server_state(str(tmp_path / "jax"), jstate)
    from_jax = load_server_state(str(tmp_path / "jax"), template)
    for f in ("arrivals", "stale_sum"):
        np.testing.assert_array_equal(from_jax.clients["fleet"][f].numpy(),
                                      half.clients["fleet"][f].numpy())
    back = j_ckpt.load_server_state(path, jstrat.init({"x": jnp.zeros(3, jnp.float32)}))
    for f in ("arrivals", "stale_sum"):
        np.testing.assert_array_equal(np.asarray(back.clients["fleet"][f]),
                                      half.clients["fleet"][f].numpy())


# ---------------------------------------------------------------------------
# CharLM-tiny: the buffered server through the cohort engine vs JAX
# ---------------------------------------------------------------------------

TINY_FL = dict(num_clients=8, cohort_size=4, sampling="uniform", epochs=1, local_batch=2,
               algorithm="fedshuffle", local_lr=0.05, imbalance="lognormal", mean_samples=3,
               seed=1, engine="cohort", rr_backend="device_ref", prefetch=0,
               cohort_mode="vmapped", fleet="zipf_latency", server_mode="buffered",
               buffer_size=2, faults="dropout", drop_prob=0.2)


def test_charlm_tiny_buffered_matches_jax():
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
    want = server_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    for k, w in want.params.items():
        g = state.params[k].numpy()
        assert np.abs(g - w.numpy()).max() <= 1e-6 + 1e-4 * np.abs(w.numpy()).max(), k
    for f in ("arrivals", "stale_sum"):
        assert torch.equal(state.clients["fleet"][f], want.clients["fleet"][f]), f
    for k in FLEET_KEYS:
        assert float(mets[k]) == pytest.approx(float(jm[k]), rel=1e-6), k
