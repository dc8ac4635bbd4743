"""The PyTorch port's cohort-engine defaults: the participation schedules,
the round prefetcher and the LR schedules, against the JAX package's.

* twins of ``tests/test_cohort_engine.py``'s scheduler tests (Floyd's
  uniform sampling, the cyclic schedules' coverage and reshuffle, the
  independent-sampling truncation, the slot bound, registration and the
  bind-time refusal of an unknown schedule) and its prefetcher tests (round
  order, running ahead, the producer's error at the consumer, ``close``);
* cohorts equal to JAX's, ids and probabilities bitwise, for all four
  schedules over two periods at n=10/b=3 and n=1,024/b=64; ``cosine`` and
  ``wsd`` equal to JAX's floats exactly for every round of a run;
* within the port, bitwise: ``prefetch=2`` rounds == ``prefetch=0`` rounds,
  padded and bucketed, in both cohort modes (and bucketed == padded under
  prefetch, the ``engine_prefetch`` case of
  ``tests/test_bucketed_equivalence.py:73``); an early stop ends the
  producer thread, and a producer error surfaces through ``train``;
* ``FLConfig(engine="cohort")`` at its defaults binds and runs, and so does
  each participation schedule and each LR schedule through ``train``.
"""
import dataclasses
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.data.federated import Population as JPop  # noqa: E402
from repro.fed.cohort.scheduler import sample_round as j_sample_round  # noqa: E402
from repro.fed.server import cosine_schedule as j_cosine  # noqa: E402
from repro.fed.server import wsd_schedule as j_wsd  # noqa: E402
from repro.fed.train_loop import SCHEDULES as J_SCHEDULES  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.data.federated import FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import DuplicatedQuadraticTask, QuadraticTask  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.cohort.prefetch import RoundPrefetcher  # noqa: E402
from repro_torch.fed.cohort.scheduler import (PARTICIPATION, CohortSample,  # noqa: E402
                                              register_participation, sample_round)
from repro_torch.fed.losses import make_quadratic_loss  # noqa: E402
from repro_torch.fed.rounds import build_round_step  # noqa: E402
from repro_torch.fed.server import cosine_schedule, wsd_schedule  # noqa: E402
from repro_torch.fed.strategy import bind_strategy, strategy_for  # noqa: E402
from repro_torch.fed.train_loop import SCHEDULES, train  # noqa: E402

SCHEDULE_NAMES = ["iid", "uniform_floyd", "cyclic", "cyclic_shuffled"]
COPIES = (1, 4, 9, 2, 6, 3, 1, 8)     # realized K_i spread over several buckets
TASK = DuplicatedQuadraticTask(copies=COPIES)
DIM = len(COPIES)
LOSS = make_quadratic_loss(DIM)
X0 = np.array([0.3, -0.1, 0.2, 0.05, -0.3, 0.1, 0.0, 0.4], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fl(n=10, b=3, **kw):
    return FLConfig(num_clients=n, cohort_size=b, **kw)


# ---------------------------------------------------------------------------
# participation schedules (twins of tests/test_cohort_engine.py:79-166)
# ---------------------------------------------------------------------------


def test_floyd_uniform_is_valid_and_unbiased():
    fl = _fl(20, 5, participation="uniform_floyd")
    pop = Population.build(fl)
    counts = np.zeros(20)
    for r in range(600):
        s = sample_round(fl, pop, r, slots=5)
        assert len(np.unique(s.ids)) == 5 and s.ids.max() < 20
        assert np.allclose(s.probs, 5 / 20)
        counts[s.ids] += 1
    emp = counts / 600
    assert np.all(np.abs(emp - 0.25) < 5 * np.sqrt(0.25 * 0.75 / 600) + 0.02)


@pytest.mark.parametrize("schedule", ["cyclic", "cyclic_shuffled"])
def test_cyclic_covers_population_each_period(schedule):
    """Regularized participation: every client trains exactly once a period."""
    fl = _fl(10, 3, participation=schedule, seed=4)
    pop = Population.build(fl)
    period = -(-10 // 3)
    for p in range(2):
        seen = np.concatenate([sample_round(fl, pop, r, slots=3).ids
                               for r in range(p * period, (p + 1) * period)])
        assert sorted(seen.tolist()) == list(range(10))


def test_cyclic_shuffled_reshuffles_between_periods():
    fl = _fl(64, 8, participation="cyclic_shuffled", seed=4)
    pop = Population.build(fl)
    g0 = [tuple(sample_round(fl, pop, r, slots=8).ids) for r in range(8)]
    g1 = [tuple(sample_round(fl, pop, r + 8, slots=8).ids) for r in range(8)]
    assert g0 != g1


def test_independent_truncation_warns_and_drops_uniformly():
    fl = _fl(12, 4, sampling="independent", seed=9)
    pop = Population.build(fl, sizes=np.full(12, 8))
    probs = np.full(12, 0.9)  # force many realized clients
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s = sample_round(fl, pop, 0, slots=5, probs=probs)
    assert len(s.ids) == 5
    assert any("dropping" in str(w.message) for w in caught)
    # the kept set is NOT simply the 5 lowest ids (the old ordering bias)
    assert s.ids.tolist() != sorted(s.ids.tolist())[:5] or s.ids.max() > 5


def test_independent_slots_grow_with_expected_cohort():
    """The padded slot count covers E|S| + 4 sigma, not just 2b."""
    fl = _fl(100, 40, sampling="independent")
    pipe = FederatedPipeline(QuadraticTask(dim=4, assignment=((0,), (1,), (2,), (3,))),
                             Population.build(fl), fl)
    mu = pipe.inclusion_probs().sum()
    assert pipe.cohort_slots >= min(100, int(mu + 4 * np.sqrt(mu)))


def test_register_participation():
    def everyone(fl, population, rnd, slots, probs):
        return CohortSample(np.arange(population.num_clients), np.ones(population.num_clients))

    register_participation("_test_everyone", everyone)
    try:
        fl = _fl(4, 2, participation="_test_everyone", sampling="full")
        s = sample_round(fl, Population.build(fl), 0, slots=4)
        assert s.ids.tolist() == [0, 1, 2, 3]
        with pytest.raises(ValueError):
            register_participation("_test_everyone", everyone)
        # a schedule that realizes more clients than slots is refused
        with pytest.raises(ValueError, match="realized 4 clients for 3 slots"):
            sample_round(fl, Population.build(fl), 0, slots=3)
    finally:
        PARTICIPATION.pop("_test_everyone", None)


def test_unknown_participation_fails_at_bind_time():
    fl = _fl(4, 2, engine="cohort", participation="nope")
    with pytest.raises(ValueError, match="participation"):
        bind_strategy(strategy_for(fl), fl, make_quadratic_loss(3), num_clients=4)


@pytest.mark.parametrize("n,b", [(10, 3), (1024, 64)])
@pytest.mark.parametrize("schedule", SCHEDULE_NAMES)
def test_cohorts_match_jax(schedule, n, b):
    """Each schedule's cohorts (ids and probabilities) equal the JAX
    package's bitwise over two periods."""
    kw = dict(num_clients=n, cohort_size=b, participation=schedule, seed=7)
    fl, jfl = FLConfig(**kw), JFL(**kw)
    pop, jpop = Population.build(fl), JPop.build(jfl)
    for r in range(2 * -(-n // b)):
        got, want = sample_round(fl, pop, r, slots=b), j_sample_round(jfl, jpop, r, slots=b)
        np.testing.assert_array_equal(got.ids, want.ids, err_msg=f"{schedule} round {r}")
        np.testing.assert_array_equal(got.probs, want.probs, err_msg=f"{schedule} round {r}")


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total", [1, 7, 20, 100])
@pytest.mark.parametrize("name,fn,jfn", [("cosine", cosine_schedule, j_cosine),
                                         ("wsd", wsd_schedule, j_wsd)])
def test_lr_schedules_match_jax_exactly(name, fn, jfn, total):
    for r in range(total + 1):
        assert fn(r, total) == jfn(r, total), (name, r)
        assert SCHEDULES[name](r, total) == J_SCHEDULES[name](r, total), (name, r)


@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
def test_train_runs_each_lr_schedule(schedule):
    fl = FLConfig(**_kw())
    res = train(LOSS, {"x": torch.from_numpy(X0.copy())}, _pipe(fl), fl, 6, schedule=schedule,
                log_every=0, device="cpu")
    assert [r["lr_mult"] for r in res.metrics.rows] == [J_SCHEDULES[schedule](r, 6)
                                                        for r in range(6)]
    assert all(np.isfinite(r["local_loss"]) for r in res.metrics.rows)


# ---------------------------------------------------------------------------
# the prefetcher (twins of tests/test_cohort_engine.py:175-207)
# ---------------------------------------------------------------------------


def test_prefetcher_preserves_round_order():
    out = list(RoundPrefetcher(lambda r: r * r, rounds=7, depth=3))
    assert out == [(r, r * r) for r in range(7)]
    assert list(RoundPrefetcher(lambda r: r, rounds=3, depth=2, start=5)) == \
        [(5, 5), (6, 6), (7, 7)]


def test_prefetcher_runs_ahead():
    produced = []

    def make(r):
        produced.append(r)
        return r

    pf = RoundPrefetcher(make, rounds=10, depth=3)
    it = iter(pf)
    next(it)
    deadline = time.time() + 2.0
    while len(produced) < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 3  # the producer filled the queue ahead of consumption
    pf.close()


def test_prefetcher_propagates_producer_error():
    def boom(r):
        if r == 2:
            raise RuntimeError("producer failed")
        return r

    with pytest.raises(RuntimeError, match="producer failed"):
        list(RoundPrefetcher(boom, rounds=5, depth=2))


def test_prefetcher_close_stops_thread():
    pf = RoundPrefetcher(lambda r: time.sleep(0.01) or r, rounds=1000, depth=2)
    next(iter(pf))
    pf.close()
    assert not pf._thread.is_alive()
    assert threading.active_count() < 50


# ---------------------------------------------------------------------------
# prefetched rounds within the port
# ---------------------------------------------------------------------------


def _kw(**kw):
    return dict(num_clients=DIM, cohort_size=4, sampling="uniform", epochs=2, local_batch=2,
                algorithm="fedshuffle", local_lr=0.05, server_lr=0.8, cohort_mode="vmapped",
                drop_last_steps=1, seed=11, buckets=3, engine="cohort", rr_backend="device",
                prefetch=0) | kw


def _pipe(fl):
    return FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)


def _rounds(kw, rounds=4):
    fl = FLConfig(**kw)
    res = train(LOSS, {"x": torch.from_numpy(X0.copy())}, _pipe(fl), fl, rounds, log_every=0,
                device="cpu")
    return res.state, res.metrics.rows


def _same(a, b, what):
    (sa, ra), (sb, rb) = a, b
    assert sa.rnd == sb.rnd, what
    for k in sa.params:
        assert torch.equal(sa.params[k], sb.params[k]), f"{what}: {k}"
    strip = [{k: v for k, v in r.items() if k != "elapsed_s"} for r in ra]
    assert strip == [{k: v for k, v in r.items() if k != "elapsed_s"} for r in rb], what


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
@pytest.mark.parametrize("preset", ["fedshuffle", "fednova", "fedavg_min"])
def test_prefetched_rounds_equal_unprefetched_bitwise(preset, mode):
    kw = _kw(algorithm=preset, cohort_mode=mode)
    pad0 = _rounds(kw)
    pad2 = _rounds(kw | dict(prefetch=2))
    _same(pad0, pad2, f"{preset}/{mode} padded: prefetch 2 vs 0")
    buck0 = _rounds(kw | dict(exec_mode="bucketed"))
    buck2 = _rounds(kw | dict(exec_mode="bucketed", prefetch=2))
    _same(buck0, buck2, f"{preset}/{mode} bucketed: prefetch 2 vs 0")
    _same(pad2, buck2, f"{preset}/{mode} prefetch 2: bucketed vs padded")


def test_engine_prefetch_keeps_bucketed_pos_on_the_host():
    fl = FLConfig(**_kw(exec_mode="bucketed", prefetch=2))
    eng = CohortEngine.build(TASK, Population.build(fl, sizes=TASK.sizes()), fl, device="cpu")
    with eng.round_plans(3, start=1) as it:
        got = list(it)
    assert [r for r, _ in got] == [1, 2, 3]
    for r, plan in got:
        want = eng.device_plan(r)
        assert isinstance(plan.pos, np.ndarray)
        np.testing.assert_array_equal(plan.pos, want.pos)
        assert torch.equal(plan.meta.client_id, want.meta.client_id)


def test_default_cohort_config_binds_and_runs():
    """FLConfig(engine="cohort") at its defaults (prefetch=2, iid, the
    vmapped mode) binds and runs through the engine."""
    fl = FLConfig(num_clients=DIM, cohort_size=4, local_batch=2, engine="cohort")
    assert fl.prefetch == 2 and fl.participation == "iid"
    eng = CohortEngine.build(TASK, Population.build(fl, sizes=TASK.sizes()), fl, device="cpu")
    strat = bind_strategy(None, fl, LOSS, num_clients=DIM)
    step = build_round_step(LOSS, strat, fl, plane=eng.plane, device="cpu")
    state = strat.init({"x": torch.from_numpy(X0.copy())})
    with eng.round_plans(3) as it:
        for r, plan in it:
            state, mets = step(state, plan)
    assert state.rnd == 3 and np.isfinite(float(mets["local_loss"]))


@pytest.mark.parametrize("schedule", SCHEDULE_NAMES)
def test_each_participation_schedule_trains(schedule):
    kw = _kw(participation=schedule, prefetch=2)
    state, rows = _rounds(kw, rounds=3)
    assert state.rnd == 3 and all(np.isfinite(r["local_loss"]) for r in rows)
    # the same cohorts as the JAX package's, round by round
    fl, jfl = FLConfig(**kw), JFL(**kw)
    pipe = _pipe(fl)
    jpop = JPop.build(jfl, sizes=TASK.sizes())
    for r in range(3):
        want = j_sample_round(jfl, jpop, r, slots=pipe.cohort_slots)
        np.testing.assert_array_equal(pipe._sample(r).ids, want.ids)


def _prefetch_threads() -> int:
    return sum(t.name == "cohort-prefetch" and t.is_alive() for t in threading.enumerate())


def test_early_stop_ends_the_producer_thread():
    fl = FLConfig(**_kw(prefetch=2))
    before = _prefetch_threads()

    def eval_fn(params):
        raise KeyboardInterrupt("stop")

    with pytest.raises(KeyboardInterrupt):
        train(LOSS, {"x": torch.from_numpy(X0.copy())}, _pipe(fl), fl, 50, eval_fn=eval_fn,
              eval_every=1, log_every=0, device="cpu")
    deadline = time.time() + 5.0
    while _prefetch_threads() > before and time.time() < deadline:
        time.sleep(0.01)
    assert _prefetch_threads() == before


def test_producer_error_surfaces_in_train():
    def flaky(fl, population, rnd, slots, probs):
        if rnd == 2:
            raise RuntimeError("schedule failed")
        return PARTICIPATION["iid"](fl, population, rnd, slots, probs)

    register_participation("_test_flaky", flaky)
    try:
        fl = FLConfig(**_kw(participation="_test_flaky", prefetch=2))
        with pytest.raises(RuntimeError, match="schedule failed"):
            train(LOSS, {"x": torch.from_numpy(X0.copy())}, _pipe(fl), fl, 4, log_every=0,
                  device="cpu")
    finally:
        PARTICIPATION.pop("_test_flaky", None)


def test_prefetch_depth_must_be_nonnegative():
    fl = FLConfig(**_kw(prefetch=-1))
    with pytest.raises(ValueError, match="prefetch"):
        build_round_step(LOSS, None, fl, device="cpu")
    assert dataclasses.replace(fl, prefetch=3).prefetch == 3


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("exec_mode", ["padded", "bucketed"])
def test_cuda_prefetch_equals_unprefetched(exec_mode):
    """On a card the producer thread copies the plans to the card: the
    rounds equal the unprefetched ones bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the producer's copies to the card have no CPU mode")
    runs = []
    for prefetch in (0, 2):
        fl = FLConfig(**_kw(exec_mode=exec_mode, prefetch=prefetch))
        runs.append(train(LOSS, {"x": torch.from_numpy(X0.copy()).cuda()}, _pipe(fl), fl, 4,
                          log_every=0, device="cuda").state)
    assert torch.equal(runs[0].params["x"], runs[1].params["x"])
