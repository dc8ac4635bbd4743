"""The PyTorch port's comm plane (``repro_torch.fed.comm``) against the JAX
package, and its contracts within the port.

* each codec on the same numpy trees and keys: the port's ``tree_roundtrip``
  / ``uplink_apply`` / ``downlink_apply`` vs the JAX package's, BITWISE (a
  stacked leaf whose per-layer size is not a multiple of the chunk, so
  chunks straddle layers; topk on tie-free inputs);
* the wire view: leaf order and flat values equal
  ``jax.tree_util.tree_flatten_with_path`` of JAX CharLM-tiny params;
  ``wire_bits_total`` / ``dense_bits`` equal JAX's for the CharLM-tiny and
  CharLM-100M shapes (shapes only);
* rounds on the quadratic: fedshuffle / fedavg x uplink {qsgd, ef_qsgd,
  diana_qsgd} x downlink {identity, qsgd}, 3 rounds, legacy and engine,
  vs JAX at atol 1e-6 with the comm metrics; and a run continued in the port
  from a JAX state taken mid-run;
* CharLM-tiny, 2 rounds with qsgd both ways vs JAX at rtol 1e-4, except
  the elements whose stochastic level flipped because the inputs differ by
  an ulp: at most one level (coefficient * scale / L) each per round, under
  0.1 % of elements, counted;
* within the port, bitwise: identity == the no-comm path, engine == legacy,
  the bank's masked commit; bind-time errors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.paper_tasks import CHARLM_100M as J_100M  # noqa: E402
from repro.configs.paper_tasks import CHARLM_TINY as J_TINY  # noqa: E402
from repro.data.federated import FederatedPipeline as JPipe  # noqa: E402
from repro.data.federated import Population as JPop  # noqa: E402
from repro.data.tasks import CharLMTask as JCharLM  # noqa: E402
from repro.data.tasks import DuplicatedQuadraticTask as JDup  # noqa: E402
from repro.fed import comm as jcomm  # noqa: E402
from repro.fed.cohort import CohortEngine as JEngine  # noqa: E402
from repro.fed.losses import make_loss as j_make_loss  # noqa: E402
from repro.fed.losses import make_quadratic_loss as j_quad  # noqa: E402
from repro.fed.rounds import as_device_batch as j_as_device  # noqa: E402
from repro.fed.rounds import build_round_step as j_build_step  # noqa: E402
from repro.fed.strategy import bind_strategy as j_bind  # noqa: E402
from repro.fed.strategy import strategy_for as j_strategy_for  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig  # noqa: E402
from repro_torch.core.local import ClientChain, ClientTransform  # noqa: E402
from repro_torch.data.federated import FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import CharLMTask, DuplicatedQuadraticTask  # noqa: E402
from repro_torch.fed import comm  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.losses import make_loss, make_quadratic_loss  # noqa: E402
from repro_torch.fed.rounds import build_round_step  # noqa: E402
from repro_torch.fed.strategy import LOCAL_UPDATES, bind_strategy, strategy_for  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils.pytree import from_wire, to_wire, wire_layout  # noqa: E402
from repro_torch.weights import params_from_jax, server_state_from_jax  # noqa: E402

C = 3
LAYERS = 3
CFG3 = ArchConfig(n_layers=LAYERS)
KNOBS = dict(uplink_bits=4, uplink_chunk=16, uplink_frac=0.25, downlink_bits=2,
             downlink_chunk=8, downlink_frac=0.5, shift_alpha=0.5, rr_rounds=5)
BACKENDS = {"kernel": "pallas", "ref": "ref"}        # port uplink_backend -> JAX's


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jfl(**kw):
    """The JAX config of a port keyword dict (backend names mapped)."""
    if "uplink_backend" in kw:
        kw = kw | {"uplink_backend": BACKENDS[kw["uplink_backend"]]}
    return JFL(**kw)


def _tree(seed, scale=1.0):
    """A JAX-layout [C]-stacked tree: a stacked leaf of 35 values a layer
    (chunks of 16 or 8 straddle layers), a small stacked leaf, and two
    plain leaves; tie-free values."""
    r = np.random.default_rng(seed)
    f = lambda *s: (r.normal(size=(C, *s)) * scale).astype(np.float32)  # noqa: E731
    return {"blocks": {"w": f(LAYERS, 5, 7), "s": f(LAYERS, 4)}, "embed": f(6, 4),
            "head": f(9)}


def _port(tree):
    return params_from_jax(tree, CFG3, "cpu", axis=1)


def _assert_tree_bitwise(got: dict, want_jax_tree):
    want = _port(jax.tree.map(np.asarray, want_jax_tree))
    assert got.keys() == want.keys()
    for k in want:
        g = got[k].contiguous().numpy().view(np.uint32)
        np.testing.assert_array_equal(g, want[k].numpy().view(np.uint32), err_msg=k)


def _keys(seed=5, rnd=7):
    clients = np.array([0, 9, -1], np.int64)
    jk = jcomm.round_keys(seed, jnp.asarray(clients, jnp.int32), jnp.int32(rnd), jnp)
    pk = comm.round_keys(seed, torch.from_numpy(clients), rnd)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk).astype(np.int64))
    return jk, pk


def test_round_keys_match_jax():
    clients = np.array([0, 1, 12345, 0x7FFFFFFF, -1], np.int64)
    for rnd in (0, 3, 0xFFFFFFF0):
        for j, p in ((jcomm.round_keys, comm.round_keys),
                     (jcomm.downlink_round_keys, comm.downlink_round_keys)):
            want = j(0xFFFFFFFF, jnp.asarray(clients, jnp.int32), jnp.uint32(rnd), jnp)
            got = p(0xFFFFFFFF, torch.from_numpy(clients), rnd)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


UPLINK_CODECS = ["identity", "qsgd", "topk", "randk", "ef_qsgd", "ef_randk", "diana_qsgd",
                 "diana_randk", "diana_topk"]


@pytest.mark.parametrize("name,backend", [(n, "ref") for n in UPLINK_CODECS]
                         + [(n, "kernel") for n in ("qsgd", "ef_qsgd", "diana_qsgd")])
def test_uplink_apply_matches_jax_bitwise(name, backend):
    """Port backend "kernel" (the plain version on the CPU) is held against
    JAX's Pallas kernel in interpret mode, "ref" against its jnp version."""
    kw = KNOBS | {"uplink": name, "uplink_backend": backend}
    jc, pc = jcomm.CODECS[name](_jfl(**kw)), comm.CODECS[name](FLConfig(**kw))
    delta = _tree(1)
    jst, pst = {}, {}
    if jc.client_init is not None:
        # nonzero EF residuals / DIANA shifts, as a bank would hold mid-run
        names = jc.client_init(jax.tree.map(lambda t: t[0], delta)).keys()
        jst = {n: _tree(10 + i, 0.3) for i, n in enumerate(sorted(names))}
        pst = {n: _port(t) for n, t in jst.items()}
    jk, pk = _keys()
    jd, jst2 = jax.vmap(jcomm.uplink_apply(jc))(jax.tree.map(jnp.asarray, delta),
                                               jax.tree.map(jnp.asarray, jst), jk)
    pd, pst2 = comm.uplink_apply(pc)(_port(delta), pst, pk)
    _assert_tree_bitwise(pd, jd)
    assert sorted(pst2) == sorted(jst2)
    for n in jst2:
        _assert_tree_bitwise(pst2[n], jst2[n])


@pytest.mark.parametrize("name", ["identity", "qsgd", "randk"])
def test_downlink_apply_matches_jax_bitwise(name):
    kw = KNOBS | {"downlink": name, "uplink_backend": "kernel"}
    jc = jcomm.build_codec(_jfl(**kw), "downlink")
    pc = comm.build_codec(FLConfig(**kw), "downlink")
    params = jax.tree.map(lambda t: t[0], _tree(2))
    ref = _tree(3)
    jk = jcomm.downlink_round_keys(5, jnp.asarray([0, 9, -1], jnp.int32), jnp.int32(7), jnp)
    pk = comm.downlink_round_keys(5, torch.tensor([0, 9, -1]), 7)
    want = jax.vmap(jcomm.downlink_apply(jc), in_axes=(None, 0, 0))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, ref), jk)
    got = comm.downlink_apply(pc)(params_from_jax(params, CFG3, "cpu"), _port(ref), pk)
    _assert_tree_bitwise(got, want)


def test_wire_view_walks_jax_leaves_in_order():
    jparams = j_build_model(J_TINY).init(jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    cfg = _port_arch(J_TINY)
    port = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    stacked = {k: v[None] for k, v in port.items()}                 # a cohort of one
    wire = list(to_wire(stacked))
    assert len(wire) == len(flat) == 12
    for (path, v), (jpath, jleaf) in zip(wire, flat):
        assert path == "/".join(k.key for k in jpath)
        np.testing.assert_array_equal(v[0].numpy(), np.asarray(jleaf).reshape(-1))
    back = from_wire(wire, stacked)
    assert list(back) == list(stacked)
    assert all(torch.equal(back[k], stacked[k]) for k in stacked)
    assert [p for p, _ in wire_layout(port)][:2] == ["blocks/attn/wk", "blocks/attn/wo"]


def _port_arch(jcfg):
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})


@pytest.mark.parametrize("jcfg", [J_TINY, J_100M], ids=["charlm-tiny", "charlm-100m"])
def test_wire_accounting_matches_jax_on_model_shapes(jcfg):
    jcfg = dataclasses.replace(jcfg, vocab=min(jcfg.vocab, 512))
    jshapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    pshapes = build_model(_port_arch(jcfg)).init(0, "meta")
    assert comm.dense_bits(pshapes) == jcomm.dense_bits(jshapes)
    for name in UPLINK_CODECS:
        for chunk, frac in ((256, 0.1), (24, 0.37)):
            kw = dict(uplink=name, uplink_chunk=chunk, uplink_frac=frac)
            assert (comm.wire_bits_total(comm.build_codec(FLConfig(**kw)), pshapes)
                    == jcomm.wire_bits_total(jcomm.build_codec(_jfl(**kw)), jshapes)), kw


# ---------------------------------------------------------------------------
# rounds on the quadratic
# ---------------------------------------------------------------------------

TASK = DuplicatedQuadraticTask(copies=(1, 2, 3))
LOSS = make_quadratic_loss(3)
X0 = np.array([0.3, -0.1, 0.2], np.float32)
COMM_KEYS = ("uplink_mbytes", "uplink_compression", "downlink_mbytes",
             "downlink_compression", "total_comm_mbytes")


def _quad_kw(preset, **kw):
    return dict(num_clients=3, cohort_size=2, sampling="uniform", epochs=2, local_batch=1,
                algorithm=preset, local_lr=0.05, server_lr=0.8, server_opt="sgd",
                cohort_mode="sequential", drop_last_steps=1, seed=11, uplink_bits=4,
                uplink_chunk=2, downlink_bits=8, downlink_chunk=2) | kw


def _jax_quad(kw, rounds, *, keep=None):
    jfl = _jfl(**kw)
    jpipe = JPipe(JDup(copies=(1, 2, 3)), JPop.build(jfl, sizes=JDup(copies=(1, 2, 3)).sizes()), jfl)
    jl = j_quad(3)
    jstrat = j_bind(j_strategy_for(jfl), jfl, jl, num_clients=3)
    jstate = jstrat.init({"x": jnp.asarray(X0)})
    jstep = jax.jit(j_build_step(jl, jstrat, jfl, num_clients=3))
    kept = None
    for r in range(rounds):
        if r == keep:
            kept = jax.tree.map(np.asarray, jstate)
        jstate, jm = jstep(jstate, j_as_device(jpipe.round_batch(r)))
    return jstate, jm, kept


def _port_quad(kw, rounds, *, engine=None, state=None, start=0):
    fl = FLConfig(**kw)
    pop = Population.build(fl, sizes=TASK.sizes())
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=3)
    if state is None:
        state = strat.init({"x": torch.from_numpy(X0.copy())})
    if engine is None:
        step = build_round_step(LOSS, strat, fl, device="cpu")
        next_batch = FederatedPipeline(TASK, pop, fl).round_batch
    else:
        eng = CohortEngine.build(TASK, pop, fl, rr_backend=engine, device="cpu")
        step = build_round_step(LOSS, strat, fl, plane=eng.plane, device="cpu")
        next_batch = eng.device_plan
    for r in range(start, start + rounds):
        state, mets = step(state, next_batch(r))
    return state, mets


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=1e-6, rtol=0, err_msg=what)


def _check_state(state, mets, jstate, jm):
    _close(state.params["x"].numpy(), jstate.params["x"], "params")
    assert state.rnd == int(jstate.rnd)
    assert set(mets) == set(jm)
    for k in mets:
        _close(float(mets[k]), float(jm[k]), k)
    if jstate.clients is None:
        assert state.clients is None
        return
    assert sorted(state.clients) == sorted(jstate.clients)
    for name, entry in jstate.clients.items():
        for field, tree in entry.items():
            _close(state.clients[name][field]["x"].numpy(), tree["x"], f"{name}/{field}")


@pytest.mark.parametrize("downlink", ["identity", "qsgd"])
@pytest.mark.parametrize("uplink", ["qsgd", "ef_qsgd", "diana_qsgd"])
@pytest.mark.parametrize("preset", ["fedshuffle", "fedavg"])
def test_quadratic_rounds_match_jax(preset, uplink, downlink):
    kw = _quad_kw(preset, uplink=uplink, downlink=downlink, engine="cohort", prefetch=0)
    jstate, jm, _ = _jax_quad(kw, 3)
    for engine in (None, "host"):
        state, mets = _port_quad(kw, 3, engine=engine)
        _check_state(state, mets, jstate, jm)
    assert all(k in mets for k in ("uplink_mbytes", "total_comm_mbytes"))
    assert ("downlink_mbytes" in mets) == (downlink == "qsgd")


@pytest.mark.parametrize("uplink,downlink", [("ef_qsgd", "qsgd"), ("diana_qsgd", "randk")])
def test_port_continues_a_jax_state_taken_mid_run(uplink, downlink):
    """Independent sampling (padding slots included): JAX's state after
    round 1, EF / DIANA bank and downlink references included, carried into
    the port, which runs rounds 1 and 2 and lands where JAX does."""
    kw = _quad_kw("fedshuffle", uplink=uplink, downlink=downlink, sampling="independent",
                  num_clients=3, cohort_size=2)
    jstate, jm, kept = _jax_quad(kw, 3, keep=1)
    state = server_state_from_jax(kept, None, "cpu")
    assert state.rnd == 1 and sorted(state.clients) == ["downlink", "uplink"]
    state, mets = _port_quad(kw, 2, state=state, start=1)
    _check_state(state, mets, jstate, jm)


# ---------------------------------------------------------------------------
# CharLM-tiny, qsgd both ways
# ---------------------------------------------------------------------------

TINY_FL = dict(num_clients=4, cohort_size=2, sampling="uniform", epochs=1, local_batch=2,
               algorithm="fedshuffle", local_lr=0.05, imbalance="lognormal", mean_samples=3,
               cohort_mode="sequential", seed=1, engine="cohort", rr_backend="device_ref",
               prefetch=0, uplink="qsgd", downlink="qsgd", uplink_backend="ref")


def test_charlm_tiny_qsgd_both_ways_matches_jax(monkeypatch):
    rounds = 2
    jfl = _jfl(**TINY_FL)
    jtask = JCharLM(vocab=J_TINY.vocab, seq_len=16, num_clients=4)
    jmodel = j_build_model(J_TINY)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jloss = j_make_loss(jmodel)
    jeng = JEngine.build(jtask, JPop.build(jfl), jfl)
    jstrat = j_bind(j_strategy_for(jfl), jfl, jloss, num_clients=4)
    jstep = jax.jit(j_build_step(jloss, jstrat, jfl, num_clients=4, plane=jeng.plane))
    jstate = jstrat.init(jparams)
    with jeng.round_plans(rounds) as it:
        for _, plan in it:
            jstate, jm = jstep(jstate, plan)

    scales = []
    pack = qops.quantize_pack

    def recording(*a, **k):
        out = pack(*a, **k)
        scales.append(float(out[1].max()))
        return out

    monkeypatch.setattr(qops, "quantize_pack", recording)
    cfg = _port_arch(J_TINY)
    fl = FLConfig(**TINY_FL | {"uplink_backend": "kernel"})
    model = build_model(cfg)
    eng = CohortEngine.build(CharLMTask(vocab=cfg.vocab, seq_len=16, num_clients=4),
                             Population.build(fl), fl, device="cpu")
    loss_fn = make_loss(model)
    strat = bind_strategy(strategy_for(fl), fl, loss_fn, num_clients=4)
    step = build_round_step(loss_fn, strat, fl, plane=eng.plane, device="cpu")
    state = strat.init(params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    coeff = 0.0
    for r in range(rounds):
        plan = eng.device_plan(r)
        coeff = max(coeff, float(strat.agg_coeffs(plan.meta).abs().max()))
        state, mets = step(state, plan)
    assert len(scales) == 2 * 12 * rounds          # 12 wire leaves, both directions

    # one uplink level a round: server_lr * coefficient * scale / L
    L = 2 ** (fl.uplink_bits - 1) - 1
    level = fl.server_lr * coeff * max(scales) / L
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg, "cpu")
    flipped = total = 0
    for k, w in want.items():
        g = state.params[k].numpy()
        d = np.abs(g - w.numpy())
        off = d > 1e-6 + 1e-4 * np.abs(w.numpy())
        assert (d[off] <= rounds * level * (1 + 1e-3)).all(), k
        flipped += int(off.sum())
        total += d.size
    assert flipped < 1e-3 * total, (flipped, total)
    for k in ("uplink_mbytes", "downlink_mbytes", "total_comm_mbytes", "uplink_compression",
              "downlink_compression"):
        assert float(mets[k]) == float(jm[k]), k
    np.testing.assert_allclose(float(mets["local_loss"]), float(jm["local_loss"]), rtol=1e-4)


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["fedshuffle", "fednova"])
def test_identity_equals_the_no_comm_path_bitwise(preset):
    """Identity both ways binds no bank and adds no metric keys, and runs
    the ops of a strategy without codecs (the round driver's dense path)."""
    kw = _quad_kw(preset, sampling="independent")
    fl = FLConfig(**kw)
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=3)
    assert strat.codec.name == strat.down_codec.name == "identity" and strat.client_state is None
    bare = strat._replace(codec=None, down_codec=None)
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    out = []
    for s in (strat, bare):
        step = build_round_step(LOSS, s, fl, device="cpu")
        state = s.init({"x": torch.from_numpy(X0.copy())})
        for r in range(3):
            state, mets = step(state, pipe.round_batch(r))
        assert state.clients is None
        out.append((state.params["x"], mets))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1].keys() == out[1][1].keys() == {"local_loss", "delta_norm", "cohort"}
    assert all(torch.equal(out[0][1][k], out[1][1][k]) for k in out[0][1])


@pytest.mark.parametrize("uplink,downlink", [("qsgd", "qsgd"), ("diana_qsgd", "identity"),
                                             ("ef_randk", "randk")])
def test_engine_equals_legacy_bitwise(uplink, downlink):
    kw = _quad_kw("fedshuffle", uplink=uplink, downlink=downlink, sampling="independent",
                  engine="cohort", prefetch=0)
    legacy, lm = _port_quad(kw, 3)
    eng, em = _port_quad(kw, 3, engine="host")
    assert torch.equal(legacy.params["x"], eng.params["x"])
    for name, entry in legacy.clients.items():
        for field, tree in entry.items():
            assert torch.equal(tree["x"], eng.clients[name][field]["x"]), (name, field)
    assert lm.keys() == em.keys() and all(torch.equal(lm[k], em[k]) for k in lm)


def test_bank_commits_reconstruction_for_valid_slots_and_read_row_for_padding():
    kw = _quad_kw("fedshuffle", uplink="ef_qsgd", downlink="qsgd", sampling="independent",
                  num_clients=3, cohort_size=1, seed=3)
    fl = FLConfig(**kw)
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=3)
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    step = build_round_step(LOSS, strat, fl, device="cpu")
    state = strat.init({"x": torch.from_numpy(X0.copy())})
    down = comm.downlink_apply(strat.down_codec)
    seen_padding = False
    for r in range(6):
        rb = pipe.round_batch(r)
        valid = rb.meta.valid > 0
        seen_padding |= not valid.all()
        ids = torch.from_numpy(np.where(valid, rb.meta.client_id, 3))
        before = {n: {f: t["x"].clone() for f, t in e.items()} for n, e in state.clients.items()}
        keys = comm.downlink_round_keys(fl.seed, torch.from_numpy(rb.meta.client_id), state.rnd)
        recon = down(state.params, {"x": before["downlink"]["ref"][ids]}, keys)["x"]
        state, _ = step(state, rb)
        bank = state.clients["downlink"]["ref"]["x"]
        for c in range(len(ids)):
            row = int(ids[c])
            want = recon[c] if valid[c] else before["downlink"]["ref"][row]
            assert torch.equal(bank[row], want), (r, c)
        untouched = [i for i in range(4) if i not in set(ids[torch.from_numpy(valid)].tolist())]
        for name in before:
            for f, old in before[name].items():
                for i in untouched:
                    assert torch.equal(state.clients[name][f]["x"][i], old[i]), (name, f, i)
    assert seen_padding


def _bind(**kw):
    fl = FLConfig(**_quad_kw("fedshuffle", **kw))
    return bind_strategy(strategy_for(fl), fl, LOSS, num_clients=3)


def test_unknown_uplink_rejected_at_bind():
    with pytest.raises(ValueError, match="unknown uplink codec"):
        _bind(uplink="zip")


@pytest.mark.parametrize("bad", [
    dict(uplink="qsgd", uplink_bits=3),
    dict(uplink="qsgd", uplink_chunk=0),
    dict(uplink="qsgd", uplink_chunk=3),        # not a multiple of 8//bits
    dict(uplink="qsgd", uplink_backend="cuda"),
    dict(uplink="topk", uplink_frac=0.0),
    dict(uplink="randk", uplink_frac=1.5),
    dict(downlink="ef_qsgd"),                   # keeps client state: uplink-only
    dict(downlink="qsgd", downlink_bits=5),
])
def test_bad_knobs_rejected_at_bind(bad):
    with pytest.raises(ValueError):
        _bind(**bad)


@pytest.mark.parametrize("key", ["uplink", "downlink"])
def test_comm_state_keys_reserved(key):
    """A stateful client transform named like a comm bank would collide with
    it — binding must refuse it."""
    t = ClientTransform(name=key, init=lambda p: {}, update=lambda s, d, c, cs: (d, c),
                        client_init=lambda p: {"z": p}, finalize=lambda end, c, cs: cs)
    LOCAL_UPDATES["_collide"] = ClientChain("_collide", (lambda loss_fn, fl: t,))
    try:
        with pytest.raises(ValueError, match="reserved"):
            _bind(local_update="_collide")
    finally:
        del LOCAL_UPDATES["_collide"]


def test_register_codec_rejects_duplicates_and_stateful_downlink():
    with pytest.raises(ValueError, match="already registered"):
        comm.register_codec("identity", comm.CODECS["identity"])
    with pytest.raises(ValueError, match="direction"):
        comm.register_codec("_ef_both", comm.CODECS["ef_qsgd"], direction="both")
    assert "_ef_both" not in comm.CODECS


def test_with_error_feedback_rejects_stateful():
    with pytest.raises(ValueError):
        comm.with_error_feedback(comm.CODECS["topk"](FLConfig(**KNOBS)))
