"""The PyTorch port's observability plane (``repro_torch.obs``, the log
levels of ``repro_torch.utils.logging``) against the JAX package and within
the port.

* twins of ``tests/test_obs.py``: the edge builders and the round's edge
  table equal to JAX's; ``fixed_histogram`` bitwise JAX's (hypothesis) and
  numpy's, its clamping and weights; ``slot_sqnorms`` bitwise
  ``tree_sqnorm`` of each slot and within rtol 1e-6 of JAX's (fp32 sums in
  another order); sinks, registry instruments, summaries; the tracer (no-op
  off, threads, Chrome / JSONL export, reentrant capture); log levels;
  ``MetricLogger``'s CSV union; validation at bind; failing sinks dropped,
  not fatal, in the train loop too;
* twins of ``tests/test_obs_equivalence.py`` on the duplicated quadratic:
  ``telemetry="off"`` adds no key and ``"full"`` is a pure observer
  (state bitwise the off run's, only ``hist_*`` keys added, each counting
  every valid slot once) over presets x cohort modes x layouts, under
  compression and the buffered fleet; the histograms layout-invariant
  (padded == bucketed == engine with prefetch on) and bitwise JAX's; the
  bins knob; ``train()``'s histogram routing, with its row keys JAX's but
  ``jax_compiles``;
* ``train(telemetry_dir=)``: ``metrics.jsonl``, ``summary.json``,
  ``trace.json`` / ``events.jsonl`` with every ``round/*`` span and the
  producer thread's ``prefetch/*`` spans and queue-depth counter; the
  robust plane's suspicion histogram and run counters (JAX's
  ``test_robust_telemetry_histogram_and_counters``).

JAX's ``test_sentinel_counts_backend_compiles``,
``test_compile_guard_passes_and_raises``,
``test_compile_observed_as_trace_span`` and
``test_single_compilation_telemetry_full`` count XLA compiles; the port's
``obs`` has no ``sentinels`` until compiled round steps (ROADMAP item 2),
so its rows carry no ``jax_compiles``.
"""
import dataclasses
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.data.federated import FederatedPipeline as JPipe  # noqa: E402
from repro.data.federated import Population as JPop  # noqa: E402
from repro.data.tasks import DuplicatedQuadraticTask as JDup  # noqa: E402
from repro.fed.losses import make_quadratic_loss as j_quad  # noqa: E402
from repro.fed.rounds import as_device_batch as j_as_device  # noqa: E402
from repro.fed.rounds import build_round_step as j_build_step  # noqa: E402
from repro.fed.strategy import bind_strategy as j_bind  # noqa: E402
from repro.fed.strategy import strategy_for as j_strategy_for  # noqa: E402
from repro.fed.train_loop import train as j_train  # noqa: E402
from repro.obs import hist as j_hist  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.data.federated import FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import DuplicatedQuadraticTask  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.losses import make_quadratic_loss  # noqa: E402
from repro_torch.fed.rounds import build_round_step  # noqa: E402
from repro_torch.fed.strategy import bind_strategy, strategy_for  # noqa: E402
from repro_torch.fed.train_loop import train  # noqa: E402
from repro_torch.obs import hist as obs_hist  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.obs.hist import HIST_PREFIX  # noqa: E402
from repro_torch.utils.logging import (LOG_LEVELS, MetricLogger, debug, log,  # noqa: E402
                                       set_log_level, warn)

TASK = DuplicatedQuadraticTask(copies=(1, 2, 3))
JTASK = JDup(copies=(1, 2, 3))
LOSS = make_quadratic_loss(3)
X0 = np.array([0.3, -0.1, 0.2], np.float32)
N_ROUNDS = 3
PRESETS = ("fedshuffle", "fednova", "fedavg_min")
BASE_KEYS = {"local_loss", "delta_norm", "cohort"}
ROUND_SPANS = {"round/plan_wait", "round/step_dispatch", "round/metrics_fetch", "round/eval",
               "round/log", "round/checkpoint"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of
    several cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# edge builders + in-round histograms
# ---------------------------------------------------------------------------


def test_pow2_edges_shape_and_values():
    e = obs_hist.pow2_edges(6)
    assert e.shape == (7,) and np.array_equal(e, j_hist.pow2_edges(6))
    assert list(e[:-1]) == [0.0, 1.0, 2.0, 4.0, 8.0, 16.0] and np.isinf(e[-1])
    with pytest.raises(ValueError):
        obs_hist.pow2_edges(1)


def test_log_edges_monotone():
    e = obs_hist.log_edges(1e-3, 1e3, 12)
    assert e.shape == (13,) and np.array_equal(e, j_hist.log_edges(1e-3, 1e3, 12))
    assert np.all(np.diff(e) > 0)
    assert np.isclose(e[0], 1e-3) and np.isclose(e[-1], 1e3)
    with pytest.raises(ValueError):
        obs_hist.log_edges(1.0, 0.5, 4)


@settings(max_examples=30, deadline=None)
@given(vals=st.lists(st.floats(min_value=0.0, max_value=100.0), min_size=1, max_size=64),
       bins=st.integers(min_value=2, max_value=12))
def test_fixed_histogram_matches_numpy(vals, bins):
    """Counts == np.histogram on in-range data (right-open bins) and == JAX's."""
    edges = np.linspace(0.0, 100.0 + 1e-6, bins + 1)
    got = obs_hist.fixed_histogram(torch.tensor(vals), edges).numpy()
    want, _ = np.histogram(np.asarray(vals, np.float32), bins=edges)
    assert got.sum() == len(vals)
    np.testing.assert_allclose(got, want)
    assert np.array_equal(got, np.asarray(j_hist.fixed_histogram(jnp.asarray(vals), edges)))


def test_fixed_histogram_clamps_out_of_range():
    edges = np.asarray([0.0, 1.0, 2.0, 4.0])
    got = obs_hist.fixed_histogram(torch.tensor([-5.0, 0.5, 3.0, 100.0]), edges)
    np.testing.assert_allclose(got.numpy(), [2.0, 0.0, 2.0])


def test_fixed_histogram_weights_drop_padding():
    edges = obs_hist.pow2_edges(4)
    got = obs_hist.fixed_histogram(torch.tensor([1.0, 2.0, 2.0, 7.0]), edges,
                                   weights=torch.tensor([1.0, 1.0, 0.0, 1.0]))
    assert float(got.sum()) == 3.0


def test_slot_sqnorms_and_tree_sqnorm_agree():
    rng = np.random.default_rng(0)
    tree = {"head": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
            "blocks/1/w": torch.from_numpy(rng.normal(size=(3, 2, 2)).astype(np.float32)),
            "blocks/0/w": torch.from_numpy(rng.normal(size=(3, 2, 2)).astype(np.float32))}
    stacked = obs_hist.slot_sqnorms(tree)
    for i in range(3):
        assert torch.equal(stacked[i], obs_hist.tree_sqnorm({k: v[i] for k, v in tree.items()}))
    jtree = {"head": jnp.asarray(tree["head"].numpy()),
             "blocks": {"w": jnp.stack([jnp.asarray(tree[f"blocks/{i}/w"].numpy())
                                        for i in range(2)], axis=1)}}
    np.testing.assert_allclose(stacked.numpy(), np.asarray(j_hist.slot_sqnorms(jtree)), rtol=1e-6)


def test_round_hist_edges_keys():
    kw = dict(num_clients=4, cohort_size=2, telemetry_bins=8)
    fl, jfl = FLConfig(**kw), JFL(**kw)
    base = obs_hist.round_hist_edges(fl, with_staleness=False, with_uplink=False)
    assert set(base) == {"hist_steps", "hist_update_norm"}
    flags = dict(with_staleness=True, with_uplink=True, with_robust=True, with_dp=True,
                 with_downlink=True)
    allh = obs_hist.round_hist_edges(fl, **flags)
    jall = j_hist.round_hist_edges(jfl, **flags)
    assert list(allh) == list(jall)
    assert all(np.array_equal(allh[k], jall[k]) and allh[k].shape == (9,) for k in allh)


# ---------------------------------------------------------------------------
# sinks + registry
# ---------------------------------------------------------------------------


def test_sink_round_trip_memory_jsonl_csv(tmp_path):
    jl, cs = str(tmp_path / "m.jsonl"), str(tmp_path / "m.csv")
    reg = obs_metrics.MetricRegistry("t", sinks=[
        obs_metrics.InMemorySink(), obs_metrics.JSONLSink(jl), obs_metrics.CSVSink(cs)])
    reg.emit_row({"round": 0, "loss": 1.5})
    reg.emit_row({"round": 1, "loss": 1.25, "eval_acc": 0.5})
    reg.close()
    assert reg.sinks[0].records[1]["eval_acc"] == 0.5
    assert [json.loads(line) for line in open(jl)] == reg.sinks[0].records
    lines = open(cs).read().strip().splitlines()
    assert lines[0] == "round,loss,eval_acc"
    assert lines[1].endswith(",") and lines[2].endswith("0.5")


def test_build_sink_and_register(tmp_path):
    assert isinstance(obs_metrics.build_sink("memory"), obs_metrics.InMemorySink)
    obs_metrics.build_sink(f"jsonl:{tmp_path / 'x.jsonl'}").close()
    with pytest.raises(ValueError, match="unknown metric sink"):
        obs_metrics.build_sink("bogus")
    with pytest.raises(ValueError, match="overwrite=True"):
        obs_metrics.register_sink("memory", obs_metrics.InMemorySink)
    obs_metrics.register_sink("memory", obs_metrics.InMemorySink, overwrite=True)


def test_registry_instruments():
    reg = obs_metrics.MetricRegistry("t")
    reg.counter("n").inc()
    reg.counter("n").inc(2.0)
    reg.gauge("depth").set(3)
    h = reg.histogram("h", edges=[0.0, 1.0, 2.0])
    h.observe([0.5, 1.5, 1.7], weights=[1.0, 1.0, 2.0])
    h.merge_counts([1.0, 0.0])
    snap = reg.snapshot()
    assert snap["counters"]["n"] == 3.0 and snap["gauges"]["depth"] == 3.0
    assert snap["histograms"]["h"]["counts"] == [2.0, 3.0]
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("n")
    with pytest.raises(ValueError, match="must pass edges"):
        reg.histogram("h2")
    with pytest.raises(ValueError, match="merge of"):
        h.merge_counts([1.0, 2.0, 3.0])


def test_registry_dump_summary(tmp_path):
    reg = obs_metrics.MetricRegistry("t")
    reg.histogram("h", edges=obs_hist.pow2_edges(4)).observe([1.0, 2.0])
    p = str(tmp_path / "summary.json")
    reg.dump_summary(p)
    assert json.load(open(p))["histograms"]["h"]["total"] == 2.0


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_span_is_noop_without_tracer():
    assert trace.active() is None
    s1, s2 = trace.span("x"), trace.span("y", a=1)
    assert s1 is s2
    with s1:
        pass
    trace.counter("c", depth=1)


def test_tracer_spans_threads_and_chrome_export(tmp_path):
    with trace.capture(chrome=str(tmp_path / "t.json"), jsonl=str(tmp_path / "t.jsonl")) as tr:
        with trace.span("round/step_dispatch", round=0):
            pass
        trace.counter("prefetch/queue_depth", depth=2)
        trace.instant("marker")

        def worker():
            with trace.span("prefetch/plan_build", round=1):
                pass

        t = threading.Thread(target=worker, name="cohort-prefetch")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert trace.active() is None and len(tr) == 4
    evs = json.load(open(tmp_path / "t.json"))["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"round/step_dispatch", "prefetch/plan_build"}
    assert all("dur" in e and "ts" in e for e in xs)
    assert "cohort-prefetch" in {e["args"]["name"] for e in evs if e["name"] == "thread_name"}
    tids = {e["tid"] for e in xs}
    assert len(tids) == 2 and all(t < 16 for t in tids)
    lines = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    assert len(lines) == 4 and lines[0]["thread"]


def test_capture_is_reentrant():
    with trace.capture() as outer:
        with trace.span("outer"):
            pass
        with trace.capture() as inner:
            with trace.span("inner"):
                pass
        assert trace.active() is outer
        with trace.span("outer2"):
            pass
    assert len(inner) == 1 and len(outer) == 2


# ---------------------------------------------------------------------------
# log levels + MetricLogger
# ---------------------------------------------------------------------------


def test_log_levels(capsys):
    try:
        set_log_level("debug")
        debug("dbg", a=1)
        log("inf")
        warn("wrn")
        out = capsys.readouterr()
        assert "DEBUG dbg a=1" in out.out and "inf" in out.out and "WARN wrn" in out.err
        set_log_level("warn")
        debug("hidden")
        log("hidden-too")
        warn("visible")
        out = capsys.readouterr()
        assert out.out == "" and "visible" in out.err
        set_log_level("quiet")
        warn("gone")
        out = capsys.readouterr()
        assert out.out == "" and out.err == ""
    finally:
        set_log_level(None)
    with pytest.raises(ValueError):
        set_log_level("loud")


def test_log_level_env(monkeypatch, capsys):
    monkeypatch.setenv("FEDSHUFFLE_LOG", "quiet")
    log("suppressed")
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("FEDSHUFFLE_LOG", "bogus")
    with pytest.raises(ValueError, match="FEDSHUFFLE_LOG"):
        log("boom")
    assert "quiet" in LOG_LEVELS


def test_metric_logger_csv_union_of_keys():
    ml = MetricLogger(name="t")
    ml.append(round=0, local_loss=2.0)
    ml.append(round=1, local_loss=1.5, eval_acc=0.75)
    lines = ml.csv().splitlines()
    assert lines == ["round,local_loss,eval_acc", "0,2.0,", "1,1.5,0.75"]
    assert ml.last()["eval_acc"] == 0.75 and len(ml.rows) == 2


def test_metric_logger_print_csv_and_dump(tmp_path):
    ml = MetricLogger()
    ml.append(a=1)
    ml.append(a=2, b=3)
    buf = io.StringIO()
    ml.print_csv(file=buf)
    out = buf.getvalue().splitlines()
    assert out[0] == "a,b" and out[1] == "1,"
    p = str(tmp_path / "rows.jsonl")
    ml.dump(p)
    assert [json.loads(line)["a"] for line in open(p)] == [1, 2]


def test_metric_logger_device_values():
    ml = MetricLogger()
    ml.append(loss=torch.tensor(1.5), n=2)
    assert ml.rows[0] == {"loss": 1.5, "n": 2} and isinstance(ml.rows[0]["loss"], float)


# ---------------------------------------------------------------------------
# config validation
# ---------------------------------------------------------------------------


def test_validate_telemetry_config():
    fl = FLConfig(num_clients=4, cohort_size=2)
    obs.validate_telemetry_config(fl)
    for bad, msg in ((dataclasses.replace(fl, telemetry="verbose"), "unknown telemetry mode"),
                     (dataclasses.replace(fl, telemetry_bins=1), "telemetry_bins")):
        with pytest.raises(ValueError, match=msg):
            obs.validate_telemetry_config(bad)


def test_bind_strategy_validates_telemetry():
    fl = FLConfig(num_clients=4, cohort_size=2, telemetry="everything")
    with pytest.raises(ValueError, match="unknown telemetry mode"):
        bind_strategy(None, fl, make_quadratic_loss(4), num_clients=4)


# ---------------------------------------------------------------------------
# sink failure isolation
# ---------------------------------------------------------------------------


class _BoomSink:
    """Raises from emit after ``ok_rows`` successes (and from close)."""

    def __init__(self, ok_rows=0):
        self.ok_rows, self.emitted, self.closed = ok_rows, 0, False

    def emit(self, record):
        if self.emitted >= self.ok_rows:
            raise OSError("disk full")
        self.emitted += 1

    def close(self):
        self.closed = True
        raise OSError("disk full")


def test_failing_sink_is_disabled_not_fatal(capsys):
    mem = obs_metrics.InMemorySink()
    boom = _BoomSink(ok_rows=1)
    reg = obs_metrics.MetricRegistry("t", sinks=[boom, mem])
    try:
        set_log_level("warn")
        for r in range(3):
            reg.emit_row({"round": r})
        err = capsys.readouterr().err
    finally:
        set_log_level(None)
    assert err.count("metric sink failed") == 1 and "OSError" in err and "_BoomSink" in err
    assert boom.emitted == 1 and boom.closed and reg.sinks == [mem]
    assert [r["round"] for r in mem.records] == [0, 1, 2]


def test_failing_sink_close_is_disabled_not_fatal(capsys):
    mem = obs_metrics.InMemorySink()
    reg = obs_metrics.MetricRegistry("t", sinks=[_BoomSink(ok_rows=0), mem])
    try:
        set_log_level("warn")
        reg.close()
        err = capsys.readouterr().err
    finally:
        set_log_level(None)
    assert err.count("metric sink failed") == 1 and reg.sinks == [mem]


def test_train_loop_survives_failing_sink():
    fl = FLConfig(num_clients=3, cohort_size=2, sampling="uniform", epochs=1, local_batch=1,
                  algorithm="fedavg", local_lr=0.05, seed=3)
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    res = train(LOSS, {"x": torch.zeros(3)}, pipe, fl, 3, log_every=0, device="cpu")
    reg = res.registry
    reg.add_sink(_BoomSink(ok_rows=0))
    n = len(reg.sinks)
    reg.emit_row({"round": 99})
    assert len(reg.sinks) == n - 1
    assert [r["round"] for r in res.metrics.rows[:3]] == [0, 1, 2]


# ---------------------------------------------------------------------------
# rounds on the quadratic
# ---------------------------------------------------------------------------


def _qkw(preset="fedshuffle", mode="vmapped", **kw):
    for k, v in (("uplink_chunk", 8), ("uplink_bits", 4), ("uplink_frac", 0.5)):
        kw.setdefault(k, v)
    return dict(num_clients=3, cohort_size=2, sampling="uniform", epochs=2, local_batch=1,
                algorithm=preset, local_lr=0.05, server_lr=0.8, mvr_a=0.2, cohort_mode=mode,
                drop_last_steps=1, seed=11, buckets=2) | kw


def _port_rounds(kw, rounds=N_ROUNDS, engine=False):
    fl = FLConfig(**kw)
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=fl.num_clients)
    pop = Population.build(fl, sizes=TASK.sizes())
    state = strat.init({"x": torch.from_numpy(X0.copy())})
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
    return state, mets


def _jax_mets(kw, rounds=N_ROUNDS):
    jfl = JFL(**kw)
    jl = j_quad(3)
    pipe = JPipe(JTASK, JPop.build(jfl, sizes=JTASK.sizes()), jfl)
    strat = j_bind(j_strategy_for(jfl), jfl, jl, num_clients=jfl.num_clients)
    step = j_build_step(jl, strat, jfl, num_clients=jfl.num_clients)
    state = strat.init({"x": jnp.asarray(X0)})
    for r in range(rounds):
        state, mets = step(state, j_as_device(pipe.round_batch(r)))
    return mets


def _tree_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _tree_equal(a[k], b[k], f"{what}/{k}")
    else:
        assert torch.equal(a, b), what


def _split(mets):
    hists = {k: v for k, v in mets.items() if k.startswith(HIST_PREFIX)}
    return {k: v for k, v in mets.items() if k not in hists}, hists


def _observer(kw, engine=False):
    """off vs full: the state bitwise, the scalars bitwise, only hist_* keys
    added, each counting every valid slot once; -> (off mets, full hists)."""
    s_off, m_off = _port_rounds(kw, engine=engine)
    s_full, m_full = _port_rounds(kw | dict(telemetry="full"), engine=engine)
    _tree_equal(s_off.params, s_full.params, "params")
    _tree_equal(s_off.opt, s_full.opt, "opt")
    if s_off.clients is not None:
        _tree_equal(s_off.clients, s_full.clients, "bank")
    scalars, hists = _split(m_full)
    _tree_equal(m_off, scalars, "scalar metrics")
    for k, h in hists.items():
        assert h.shape == (FLConfig(**kw).telemetry_bins,), k
        assert float(h.sum()) == float(m_full["cohort"]), k
    return m_off, hists


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
@pytest.mark.parametrize("exec_mode", ["padded", "bucketed"])
def test_telemetry_off_is_frozen_and_full_is_pure_observer(mode, exec_mode):
    for preset in PRESETS:
        kw = _qkw(preset, mode, exec_mode=exec_mode)
        m_off, hists = _observer(kw)
        assert set(m_off) == BASE_KEYS, preset
        assert set(hists) == {"hist_steps", "hist_update_norm"}, preset


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_full_histograms_are_layout_invariant(mode):
    """Static edges + slot-order inputs: padded, bucketed and the engine
    (prefetch on) report the same counts, and JAX's."""
    kw = _qkw("fedshuffle", mode, telemetry="full", engine="cohort")
    _, hp = _split(_port_rounds(kw | dict(exec_mode="padded"))[1])
    _, hb = _split(_port_rounds(kw | dict(exec_mode="bucketed"))[1])
    _, he = _split(_port_rounds(kw, engine=True)[1])
    _tree_equal(hp, hb, f"{mode}: padded vs bucketed")
    _tree_equal(hp, he, f"{mode}: legacy vs engine")
    _, jh = _split(_jax_mets(kw))
    assert hp.keys() == jh.keys()
    for k in hp:
        assert np.array_equal(hp[k].numpy(), np.asarray(jh[k])), k


@pytest.mark.parametrize("uplink", ["qsgd", "topk"])
@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_telemetry_off_frozen_under_compression(uplink, mode):
    kw = _qkw("fedshuffle", mode, uplink=uplink)
    m_off, hists = _observer(kw)
    assert set(m_off) == BASE_KEYS | {"uplink_mbytes", "uplink_compression", "total_comm_mbytes"}
    assert "hist_uplink_mbytes" in hists


def test_telemetry_off_frozen_under_buffered_fleet():
    kw = _qkw("fedavg", "vmapped", fleet="zipf_latency", server_mode="buffered", buffer_size=2,
              staleness="poly", staleness_power=0.5, engine="cohort")
    _, hists = _observer(kw, engine=True)
    assert "hist_staleness" in hists


def test_telemetry_bins_knob_changes_shape_only():
    kw = _qkw("fedshuffle", telemetry="metrics", telemetry_bins=5)
    s5, m5 = _port_rounds(kw)
    s16, m16 = _port_rounds(kw | dict(telemetry_bins=16))
    assert m5["hist_steps"].shape == (5,) and m16["hist_steps"].shape == (16,)
    _tree_equal(s5.params, s16.params, "bins: params")


def test_train_loop_telemetry_routes_histograms():
    """train() with telemetry='metrics': rows never see hist_* keys, the
    registry accumulates the device counts, the trajectory is the off run's
    bitwise, and the row keys are JAX's but ``jax_compiles`` (XLA compile
    counting, not ported) and ``elapsed_s`` (the port's wall clock)."""
    kw = _qkw("fedshuffle", "vmapped")
    fl, fl_t = FLConfig(**kw), FLConfig(**kw | dict(telemetry="metrics"))

    def run(f):
        pipe = FederatedPipeline(TASK, Population.build(f, sizes=TASK.sizes()), f)
        return train(LOSS, {"x": torch.from_numpy(X0.copy())}, pipe, f, N_ROUNDS, log_every=0,
                     device="cpu")

    res_off, res = run(fl), run(fl_t)
    _tree_equal(res_off.state.params, res.state.params, "train: params")
    assert not any(k.startswith(HIST_PREFIX) for k in res.metrics.last())
    snap = res.registry.snapshot()
    assert snap["histograms"]["hist_steps"]["total"] == sum(r["cohort"] for r in res.metrics.rows)
    jfl = JFL(**kw | dict(telemetry="metrics"))
    jres = j_train(j_quad(3), {"x": jnp.asarray(X0)},
                   JPipe(JTASK, JPop.build(jfl, sizes=JTASK.sizes()), jfl), jfl, N_ROUNDS,
                   log_every=0)
    for row, jrow in zip(res.metrics.rows, jres.metrics.rows):
        assert set(row) - {"elapsed_s"} == set(jrow) - {"jax_compiles"}
    jsnap = jres.registry.snapshot()
    assert snap["histograms"] == jsnap["histograms"]


def test_robust_telemetry_histogram_and_counters():
    kw = _qkw("fedshuffle", "vmapped", telemetry="metrics", attack="sign_flip", attack_frac=0.4,
              attack_scale=5.0, aggregator="trimmed_mean", trim_frac=0.3, guard="full")
    fl = FLConfig(**kw)
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    res = train(LOSS, {"x": torch.from_numpy(X0.copy())}, pipe, fl, N_ROUNDS, log_every=0,
                device="cpu")
    insts = res.registry.instruments()
    assert insts["hist_suspicion"].total == N_ROUNDS * fl.cohort_size
    for k in ("rounds_rejected", "quarantined_clients"):
        assert insts[k].value == sum(r[k] for r in res.metrics.rows), k


def test_telemetry_dir_outputs_and_engine_spans(tmp_path):
    """train(telemetry_dir=) under "full" on the cohort engine with its
    prefetch thread: the four files, every round/* span on the caller's
    thread, the producer's prefetch/* spans and queue depth on its own."""
    kw = _qkw("fedshuffle", "vmapped", telemetry="full", engine="cohort", prefetch=2, dp="on",
              dp_clip=0.5, dp_noise_mult=0.6)
    fl = FLConfig(**kw)
    eng = CohortEngine.build(TASK, Population.build(fl, sizes=TASK.sizes()), fl, device="cpu")
    out = tmp_path / "tele"
    res = train(LOSS, {"x": torch.from_numpy(X0.copy())}, eng, fl, N_ROUNDS, log_every=1,
                eval_fn=lambda p: {"x0": p["x"][0]}, eval_every=1, device="cpu",
                telemetry_dir=str(out), checkpoint_path=str(tmp_path / "ck"), checkpoint_every=1)
    assert trace.active() is None
    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert rows == res.metrics.rows and "dp_epsilon" in rows[-1]
    summary = json.load(open(out / "summary.json"))
    assert summary["gauges"]["dp_epsilon"] == rows[-1]["dp_epsilon"]
    assert summary["histograms"]["hist_dp_scale"]["total"] == N_ROUNDS * fl.cohort_size
    evs = json.load(open(out / "trace.json"))["traceEvents"]
    names = {e["name"] for e in evs if e["ph"] == "X"}
    assert ROUND_SPANS <= names, ROUND_SPANS - names
    assert {"prefetch/plan_build", "prefetch/backpressure", "plan/assemble",
            "plan/h2d_commit"} <= names
    threads = {e["tid"]: e["args"]["name"] for e in evs if e["name"] == "thread_name"}
    build = [e for e in evs if e["name"] == "prefetch/plan_build"]
    assert len(build) == N_ROUNDS and {threads[e["tid"]] for e in build} == {"cohort-prefetch"}
    step = [e for e in evs if e["name"] == "round/step_dispatch"]
    assert len(step) == N_ROUNDS and threads[step[0]["tid"]] != "cohort-prefetch"
    assert any(e["ph"] == "C" and e["name"] == "prefetch/queue_depth" for e in evs)
    assert len(open(out / "events.jsonl").read().splitlines()) == len(evs) - len(threads) - 1
