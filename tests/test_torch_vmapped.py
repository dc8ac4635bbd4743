"""The PyTorch port's vmapped cohort mode (``cohort_mode="vmapped"``, the
JAX package's default) against the JAX package's, and its contracts within
the port.

* the batched local step (``BoundStrategy.cohort_step``), with the empty
  chain and with ``("mvr",)``, against the per-client step slot by slot,
  bitwise on the quadratic and within atol 1e-6 + rtol 1e-5 of each leaf's
  largest magnitude on CharLM-tiny (batched matrix products may sum in
  another order); the batched full local gradient the same way;
* all 8 presets x {sgd, momentum, mvr} and ``mvr_exact``: 3 vmapped rounds
  on the duplicated quadratic, port vs JAX on the same ``round_batch``
  stream, atol 1e-6; the comm plane's hooks on the batched stack the same
  way (qsgd, ef_qsgd, diana_qsgd up, qsgd down);
* port vmapped vs port sequential: bitwise on the quadratic, and on
  CharLM-tiny within atol 1e-6 + rtol 1e-5 of each leaf's largest
  magnitude (the sequential mode sums the cohort in slot order, the
  vmapped one in an einsum);
* the paper claim in vmapped mode: FedAvg goes to the biased point,
  FedShuffle and FedNova to x*;
* CharLM-tiny through the cohort engine, vmapped, port vs JAX: dense and
  MVR App. F at rtol 1e-4 (each leaf within atol 1e-6 + rtol 1e-4 of its
  largest magnitude), qsgd both ways and ef_qsgd up with qsgd down at rtol
  1e-4 except the elements whose stochastic level flipped (at most one
  level a round each, under 0.1 % of them, counted);
* within the port, bitwise: engine == legacy, the cipher RR backends agree;
  ``FLConfig()`` at its defaults binds and runs a round on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.paper_tasks import CHARLM_TINY as J_TINY  # noqa: E402
from repro.data.federated import FederatedPipeline as JPipe  # noqa: E402
from repro.data.federated import Population as JPop  # noqa: E402
from repro.data.tasks import CharLMTask as JCharLM  # noqa: E402
from repro.data.tasks import DuplicatedQuadraticTask as JDup  # noqa: E402
from repro.fed.cohort import CohortEngine as JEngine  # noqa: E402
from repro.fed.losses import make_loss as j_make_loss  # noqa: E402
from repro.fed.losses import make_quadratic_loss as j_quad  # noqa: E402
from repro.fed.rounds import as_device_batch as j_as_device  # noqa: E402
from repro.fed.rounds import build_round_step as j_build_step  # noqa: E402
from repro.fed.strategy import bind_strategy as j_bind  # noqa: E402
from repro.fed.strategy import strategy_for as j_strategy_for  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig  # noqa: E402
from repro_torch.core.local import cohort_full_local_gradient, full_local_gradient  # noqa: E402
from repro_torch.data.federated import FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import CharLMTask, DuplicatedQuadraticTask  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.losses import make_loss, make_quadratic_loss  # noqa: E402
from repro_torch.fed.rounds import as_device_batch, build_round_step  # noqa: E402
from repro_torch.fed.strategy import bind_strategy, strategy_for  # noqa: E402
from repro_torch.fed.train_loop import train  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

PRESETS = ["fedshuffle", "fedavg", "fedavg_so", "fedshuffle_so", "fednova",
           "fedavg_min", "fedavg_mean", "gen"]
TASK = DuplicatedQuadraticTask(copies=(1, 2, 3))
LOSS = make_quadratic_loss(3)
X0 = np.array([0.3, -0.1, 0.2], np.float32)
A = 0.2


def _quad_kw(preset, opt, **kw):
    return dict(num_clients=3, cohort_size=2, sampling="uniform", epochs=2, local_batch=1,
                algorithm=preset, local_lr=0.05, server_lr=0.8, server_opt=opt, mvr_a=A,
                cohort_mode="vmapped", drop_last_steps=1, seed=11, uplink_bits=4,
                uplink_chunk=2, downlink_bits=8, downlink_chunk=2) | kw


def _jax_quad(kw, rounds):
    jfl = JFL(**kw)
    jtask = JDup(copies=(1, 2, 3))
    jpipe = JPipe(jtask, JPop.build(jfl, sizes=jtask.sizes()), jfl)
    jl = j_quad(3)
    jstrat = j_bind(j_strategy_for(jfl), jfl, jl, num_clients=3)
    jstate = jstrat.init({"x": jnp.asarray(X0)})
    jstep = jax.jit(j_build_step(jl, jstrat, jfl, num_clients=3))
    for r in range(rounds):
        jstate, jm = jstep(jstate, j_as_device(jpipe.round_batch(r)))
    return jstate, jm


def _port_quad(kw, rounds, *, engine=None):
    fl = FLConfig(**kw)
    pop = Population.build(fl, sizes=TASK.sizes())
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=3)
    state = strat.init({"x": torch.from_numpy(X0.copy())})
    if engine is None:
        step = build_round_step(LOSS, strat, fl, device="cpu")
        next_batch = FederatedPipeline(TASK, pop, fl).round_batch
    else:
        eng = CohortEngine.build(TASK, pop, fl, rr_backend=engine, device="cpu")
        step = build_round_step(LOSS, strat, fl, plane=eng.plane, device="cpu")
        next_batch = eng.device_plan
    for r in range(rounds):
        state, mets = step(state, next_batch(r))
    return state, mets


def _check_quad(state, mets, jstate, jm):
    """Params, every opt-state tree, bank and metric within atol 1e-6."""
    close = lambda got, want, what: np.testing.assert_allclose(  # noqa: E731
        np.asarray(got, np.float64), np.asarray(want, np.float64), atol=1e-6, rtol=0,
        err_msg=what)
    assert state.rnd == int(jstate.rnd)
    close(state.params["x"].numpy(), jstate.params["x"], "params")
    assert sorted(state.opt) == sorted(jstate.opt)
    for k, tree in jstate.opt.items():
        close(state.opt[k]["x"].numpy(), tree["x"], f"opt[{k}]")
    assert set(mets) == set(jm)
    for k in mets:
        close(float(mets[k]), float(jm[k]), k)
    if jstate.clients is None:
        assert state.clients is None
        return
    for name, entry in jstate.clients.items():
        for field, tree in entry.items():
            close(state.clients[name][field]["x"].numpy(), tree["x"], f"{name}/{field}")


# ---------------------------------------------------------------------------
# the batched local step against the per-client step
# ---------------------------------------------------------------------------


def _quad_round(kw):
    fl = FLConfig(**kw)
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    return fl, as_device_batch(pipe.round_batch(0), "cpu")


@pytest.mark.parametrize("opt", ["sgd", "mvr"])
def test_cohort_step_equals_per_client_step_bitwise_quadratic(opt):
    fl, rb = _quad_round(_quad_kw("fedshuffle", opt, sampling="full", cohort_size=3))
    strat = bind_strategy(None, fl, LOSS, num_clients=3)
    assert strat.local_update == opt
    params = {"x": torch.from_numpy(X0.copy())}
    mom = {"x": torch.tensor([0.05, -0.2, 0.15])}
    eta = torch.tensor([0.05, 0.02, 0.0125])
    deltas, losses = strat.cohort_step(params, rb.data, rb.step_mask, eta, mom)
    assert deltas["x"].shape == (3, 3) and losses.shape == (3,)
    assert (rb.step_mask.sum(1) != rb.step_mask.shape[1]).any()   # masked steps included
    for c in range(3):
        d, loss = strat.local_step(params, {k: v[c] for k, v in rb.data.items()},
                                   rb.step_mask[c], eta[c], mom)
        assert torch.equal(deltas["x"][c], d["x"]) and torch.equal(losses[c], loss), c
    # per-slot start points (the compressed downlink's): the same, slot by slot
    starts = {"x": torch.from_numpy(np.stack([X0, -X0, 2 * X0]))}
    deltas, _ = strat.cohort_step(starts, rb.data, rb.step_mask, eta, mom, stacked=True)
    for c in range(3):
        d, _ = strat.local_step({"x": starts["x"][c]}, {k: v[c] for k, v in rb.data.items()},
                                rb.step_mask[c], eta[c], mom)
        assert torch.equal(deltas["x"][c], d["x"]), c


def _port_tiny_cfg():
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in dataclasses.asdict(J_TINY).items() if k in fields})


def _leafwise_close(got: dict, want: dict, what: str, rtol: float = 1e-4):
    """Each leaf within atol 1e-6 + rtol of that leaf's largest magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        assert np.abs(g - w).max() <= 1e-6 + rtol * np.abs(w).max(), f"{what}: {k}"


@pytest.mark.parametrize("opt", ["sgd", "mvr"])
def test_cohort_step_equals_per_client_step_charlm_tiny(opt):
    cfg = _port_tiny_cfg()
    model = build_model(cfg)
    loss = make_loss(model)
    fl = FLConfig(server_opt=opt, mvr_a=A)
    strat = bind_strategy(None, fl, loss, num_clients=8)
    r = np.random.default_rng(4)
    C, K, B = 3, 3, 2
    data = {"tokens": torch.from_numpy(r.integers(0, cfg.vocab, (C, K, B, 17)).astype(np.int32))}
    mask = torch.tensor([[1.0, 1.0, 1.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0]])
    eta = torch.tensor([0.05, 0.1, 0.07])
    params = model.init(0, "cpu")
    mom = {k: torch.from_numpy(r.normal(size=v.shape).astype(np.float32) * 0.01)
           for k, v in params.items()}
    deltas, losses = strat.cohort_step(params, data, mask, eta, mom)
    for c in range(C):
        d, l_c = strat.local_step(params, {"tokens": data["tokens"][c]}, mask[c], eta[c], mom)
        _leafwise_close({k: v[c] for k, v in deltas.items()}, d, f"slot {c}", rtol=1e-5)
        np.testing.assert_allclose(float(losses[c]), float(l_c), rtol=1e-6)
    gs = cohort_full_local_gradient(loss, params, data, mask)
    for c in range(C):
        g = full_local_gradient(loss, params, {"tokens": data["tokens"][c]}, mask[c])
        _leafwise_close({k: v[c] for k, v in gs.items()}, g, f"gradient, slot {c}", rtol=1e-5)


# ---------------------------------------------------------------------------
# rounds on the quadratic, vs JAX vmapped
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["sgd", "momentum", "mvr"])
@pytest.mark.parametrize("preset", PRESETS)
def test_vmapped_presets_match_jax(preset, opt):
    kw = _quad_kw(preset, opt)
    jstate, jm = _jax_quad(kw, 3)
    state, mets = _port_quad(kw, 3)
    _check_quad(state, mets, jstate, jm)


@pytest.mark.parametrize("preset", PRESETS)
def test_vmapped_mvr_exact_matches_jax(preset):
    kw = _quad_kw(preset, "mvr", mvr_exact=True)
    jstate, jm = _jax_quad(kw, 3)
    state, mets = _port_quad(kw, 3)
    _check_quad(state, mets, jstate, jm)


@pytest.mark.parametrize("uplink,downlink", [("qsgd", "identity"), ("qsgd", "qsgd"),
                                             ("ef_qsgd", "qsgd"), ("diana_qsgd", "identity")])
@pytest.mark.parametrize("preset", ["fedshuffle", "fedavg"])
def test_vmapped_comm_rounds_match_jax(preset, uplink, downlink):
    """The comm plane's hooks on the batched stack, unchanged: codec, EF /
    DIANA bank and downlink references vs JAX, padding slots included."""
    kw = _quad_kw(preset, "sgd", uplink=uplink, downlink=downlink, sampling="independent")
    jstate, jm = _jax_quad(kw, 3)
    state, mets = _port_quad(kw, 3)
    _check_quad(state, mets, jstate, jm)


@pytest.mark.parametrize("opt,extra", [("momentum", {}), ("mvr", {}),
                                       ("mvr", {"mvr_exact": True}),
                                       ("sgd", {"uplink": "ef_qsgd", "downlink": "qsgd"})])
@pytest.mark.parametrize("preset", ["fedshuffle", "fednova", "gen"])
def test_vmapped_equals_sequential_quadratic(preset, opt, extra):
    """The port's two modes on the same stream: bitwise on the quadratic
    (per element, the same float operations in both)."""
    kw = _quad_kw(preset, opt, sampling="independent", **extra)
    vm, vmets = _port_quad(kw, 3)
    sq, smets = _port_quad(kw | {"cohort_mode": "sequential"}, 3)
    assert torch.equal(vm.params["x"], sq.params["x"])
    for k in vm.opt:
        assert torch.equal(vm.opt[k]["x"], sq.opt[k]["x"]), k
    assert vmets.keys() == smets.keys() and all(torch.equal(vmets[k], smets[k]) for k in vmets)


# ---------------------------------------------------------------------------
# the paper claim, vmapped
# ---------------------------------------------------------------------------


def _run_paper(alg, rounds, lr):
    fl = FLConfig(num_clients=3, cohort_size=3, sampling="full", epochs=1, local_batch=1,
                  algorithm=alg, local_lr=lr, cohort_mode="vmapped")
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    res = train(LOSS, {"x": torch.zeros(3)}, pipe, fl, rounds, log_every=0, device="cpu")
    return res.state.params["x"].numpy()


def test_vmapped_fedavg_converges_to_biased_point():
    x = _run_paper("fedavg", 800, 0.02)
    assert np.allclose(x, TASK.fedavg_biased_point(), atol=0.02)
    assert not np.allclose(x, TASK.optimum(), atol=0.05)


@pytest.mark.parametrize("alg,rounds,lr", [("fedshuffle", 800, 0.05), ("fednova", 1500, 0.02)])
def test_vmapped_consistent_algorithms_converge_to_optimum(alg, rounds, lr):
    x = _run_paper(alg, rounds, lr)
    assert np.allclose(x, TASK.optimum(), atol=0.02 if alg == "fednova" else 0.01)


# ---------------------------------------------------------------------------
# CharLM-tiny through the cohort engine
# ---------------------------------------------------------------------------

TINY_FL = dict(num_clients=4, cohort_size=2, sampling="uniform", epochs=1, local_batch=2,
               algorithm="fedshuffle", local_lr=0.05, imbalance="lognormal", mean_samples=3,
               cohort_mode="vmapped", seed=1, engine="cohort", rr_backend="device_ref",
               prefetch=0, mvr_a=A)
TINY_CASES = {"dense": {}, "qsgd": dict(uplink="qsgd", downlink="qsgd"),
              "ef_qsgd": dict(uplink="ef_qsgd", downlink="qsgd"), "mvr": dict(server_opt="mvr")}


def _jax_tiny(kw, rounds):
    jfl = JFL(**kw | {"uplink_backend": "ref"})
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
    return jparams, jstate, jm


def _port_tiny(kw, jparams, rounds, *, backend="device"):
    """The port's rounds from JAX's initial params; also the largest
    aggregation coefficient and the largest qsgd scale it met."""
    cfg = _port_tiny_cfg()
    fl = FLConfig(**kw | {"rr_backend": backend})
    eng = CohortEngine.build(CharLMTask(vocab=cfg.vocab, seq_len=16, num_clients=4),
                             Population.build(fl), fl, device="cpu")
    loss_fn = make_loss(build_model(cfg))
    strat = bind_strategy(None, fl, loss_fn, num_clients=4)
    step = build_round_step(loss_fn, strat, fl, plane=eng.plane, device="cpu")
    state = strat.init(params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    scales, coeff = [0.0], 0.0
    pack = qops.quantize_pack

    def recording(*a, **k):
        out = pack(*a, **k)
        scales.append(float(out[1].max()))
        return out

    qops.quantize_pack = recording
    try:
        for r in range(rounds):
            plan = eng.device_plan(r)
            coeff = max(coeff, float(strat.agg_coeffs(plan.meta).abs().max()))
            state, mets = step(state, plan)
    finally:
        qops.quantize_pack = pack
    return state, mets, fl, coeff, max(scales)


@pytest.mark.parametrize("case", list(TINY_CASES))
def test_charlm_tiny_vmapped_matches_jax(case):
    rounds = 2
    kw = TINY_FL | TINY_CASES[case]
    jparams, jstate, jm = _jax_tiny(kw, rounds)
    state, mets, fl, coeff, scale = _port_tiny(kw, jparams, rounds)
    cfg = _port_tiny_cfg()
    np_tree = lambda t: params_from_jax(jax.tree.map(np.asarray, t), cfg, "cpu")  # noqa: E731
    want = np_tree(jstate.params)
    if case in ("dense", "mvr"):
        _leafwise_close(state.params, want, "params")
        for k, tree in jstate.opt.items():
            _leafwise_close(state.opt[k], np_tree(tree), f"opt[{k}]")
    else:
        # an element whose inputs differ by an ulp may land on the other side
        # of a stochastic level: at most one uplink level a round
        level = fl.server_lr * coeff * scale / (2 ** (fl.uplink_bits - 1) - 1)
        flipped = total = 0
        for k, w in want.items():
            d = np.abs(state.params[k].numpy() - w.numpy())
            off = d > 1e-6 + 1e-4 * np.abs(w.numpy())
            assert (d[off] <= rounds * level * (1 + 1e-3)).all(), k
            flipped += int(off.sum())
            total += d.size
        assert flipped < 1e-3 * total, (flipped, total)
        for k in ("uplink_mbytes", "downlink_mbytes", "total_comm_mbytes"):
            assert float(mets[k]) == float(jm[k]), k
    np.testing.assert_allclose(float(mets["local_loss"]), float(jm["local_loss"]), rtol=1e-4)


@pytest.mark.parametrize("case", ["dense", "mvr"])
def test_charlm_tiny_vmapped_near_sequential(case):
    """The port's two modes on CharLM-tiny: each leaf within atol 1e-6 +
    rtol 1e-5 of its largest magnitude (batched products and the einsum
    aggregate sum in other orders than the slot loop)."""
    kw = TINY_FL | TINY_CASES[case]
    jparams = j_build_model(J_TINY).init(jax.random.PRNGKey(0))
    vm = _port_tiny(kw, jparams, 2)[0]
    sq = _port_tiny(kw | {"cohort_mode": "sequential"}, jparams, 2)[0]
    _leafwise_close(vm.params, sq.params, "params", rtol=1e-5)


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["momentum", "mvr"])
@pytest.mark.parametrize("sampling,preset", [("uniform", "fedshuffle"), ("independent", "fednova"),
                                             ("uniform", "fedavg_min")])
def test_vmapped_engine_matches_legacy_bitwise(sampling, preset, opt):
    kw = _quad_kw(preset, opt, sampling=sampling, engine="cohort", prefetch=0)
    legacy, lm = _port_quad(kw, 3)
    eng, em = _port_quad(kw, 3, engine="host")
    assert torch.equal(legacy.params["x"], eng.params["x"])
    assert torch.equal(legacy.opt["m"]["x"], eng.opt["m"]["x"])
    assert lm.keys() == em.keys() and all(torch.equal(lm[k], em[k]) for k in lm)


def test_vmapped_rr_backends_agree_bitwise():
    """CharLM-tiny vmapped rounds: the cipher's numpy mirror, its plain
    torch version and the kernel dispatch's CPU route land on the same
    params bit for bit; the host PCG backend runs too (other streams)."""
    kw = TINY_FL | dict(sampling="independent")
    jparams = j_build_model(J_TINY).init(jax.random.PRNGKey(0))
    out = {b: _port_tiny(kw, jparams, 2, backend=b)[0].params
           for b in ("host", "host_feistel", "device_ref", "device")}
    for b in ("device_ref", "device"):
        assert all(torch.equal(out["host_feistel"][k], out[b][k]) for k in out[b]), b
    assert all(torch.isfinite(v).all() for v in out["host"].values())


def test_default_flconfig_binds_and_runs_a_round():
    fl = FLConfig()
    assert fl.cohort_mode == "vmapped" and fl.engine == "legacy"
    task = DuplicatedQuadraticTask(copies=tuple(range(1, fl.num_clients + 1)))
    loss = make_quadratic_loss(fl.num_clients)
    pipe = FederatedPipeline(task, Population.build(fl, sizes=task.sizes()), fl)
    strat = bind_strategy(None, fl, loss, num_clients=fl.num_clients)
    step = build_round_step(loss, strat, fl, device="cpu")
    state, mets = step(strat.init({"x": torch.zeros(fl.num_clients)}), pipe.round_batch(0))
    assert state.rnd == 1 and float(mets["cohort"]) > 0
    assert torch.isfinite(state.params["x"]).all() and bool((state.params["x"] != 0).any())
