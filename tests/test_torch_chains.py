"""The PyTorch port's client-transform chains (``scaffold``, ``fedprox``,
``local_clip``, ``mvr``, custom and legacy raw rules) and the ``scaffold`` /
``adam`` server opts, against the JAX package and within the port.

* twins of ``tests/test_client_transforms.py``: the empty and ``("mvr",)``
  chains bitwise equal to ``local_sgd`` / ``local_mvr`` (and within atol
  1e-6 of JAX's), the bind-time errors (needs / provides, consumes, unknown
  names, ``prox_mu`` / ``clip_norm`` <= 0, pins, a bankless state), every
  preset x {fedprox, local_clip, scaffold, mvr} one round against JAX at
  atol 1e-6, a custom transform after mvr, a legacy raw rule bitwise equal
  to sgd, SCAFFOLD's bank (scratch row untouched) and its convergence win
  over FedAvg under client sampling (400 rounds: error < 0.02 and < 0.25x
  FedAvg's), ``drop_last_steps``, the bound strategy's surface.  JAX's
  single-compilation guard waits for compiled steps (ROADMAP item 2); its
  run is held here by its bank staying finite while the cohorts rotate;
* the cohort step of every new chain equal to the per-client step slot by
  slot, bitwise (per-slot step counts, eta and clip norms);
* adam: 8 presets x both cohort modes, 4 rounds on the quadratic, vs JAX at
  atol 1e-6 (the bias corrections are fp32 tensors, as JAX forms them);
* SCAFFOLD's bank within the port, bitwise: padded == bucketed in both
  modes on the legacy pipeline, the engine and the engine with prefetch;
  engine == legacy; scaffold + topk's EF residual sharing one bank across
  layouts and paths; save / resume in the JAX file format (either package
  writes, the other reads; a stateless or a differently sized template
  refuses the file);
* CharLM-tiny, SCAFFOLD through the cohort engine against JAX in both
  modes: each leaf (params, ``c``, the bank) within atol 1e-6 + rtol 1e-4
  of its largest magnitude (the frameworks' products sum in other orders).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.paper_tasks import CHARLM_TINY as J_TINY  # noqa: E402
from repro.core.local import local_mvr as j_local_mvr  # noqa: E402
from repro.core.local import local_sgd as j_local_sgd  # noqa: E402
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
from repro.utils import checkpoint as j_ckpt  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig  # noqa: E402
from repro_torch.core import local as local_mod  # noqa: E402
from repro_torch.core.algorithms import PRESETS  # noqa: E402
from repro_torch.core.local import (ClientChain, ClientTransform, build_local_step,  # noqa: E402
                                    local_mvr, local_sgd, register_client_transform,
                                    resolve_chain)
from repro_torch.data.federated import BucketedPlan, FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import (CharLMTask, DuplicatedQuadraticTask,  # noqa: E402
                                    PopulationQuadraticTask)
from repro_torch.fed import strategy as strat_mod  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.losses import make_loss, make_quadratic_loss  # noqa: E402
from repro_torch.fed.rounds import as_device_batch, build_round_step  # noqa: E402
from repro_torch.fed.server import init_server  # noqa: E402
from repro_torch.fed.strategy import (FedStrategy, bind_strategy,  # noqa: E402
                                      register_local_update, register_strategy, strategy_for)
from repro_torch.fed.train_loop import train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils.checkpoint import (load_server_state, save_server_state)  # noqa: E402
from repro_torch.weights import params_from_jax, server_state_from_jax  # noqa: E402

TASK = DuplicatedQuadraticTask(copies=(1, 2, 3))
LOSS = make_quadratic_loss(3)
X0 = np.array([0.3, -0.1, 0.2], np.float32)
ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _registry_sandbox():
    registries = (local_mod.CLIENT_TRANSFORMS, strat_mod.LOCAL_UPDATES,
                  strat_mod.SERVER_OPTS, strat_mod.STRATEGIES)
    snapshots = [dict(r) for r in registries]
    yield
    for registry, snapshot in zip(registries, snapshots):
        registry.clear()
        registry.update(snapshot)


def _kw(**kw):
    return dict(num_clients=3, cohort_size=2, sampling="uniform", epochs=2, local_batch=1,
                algorithm="fedshuffle", local_lr=0.05, server_lr=0.8, seed=11) | kw


def _fl(**kw):
    return FLConfig(**_kw(**kw))


def _bind(fl, loss=LOSS):
    return bind_strategy(strategy_for(fl), fl, loss, num_clients=fl.num_clients)


def _pipe(fl):
    return FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)


def _x0():
    return {"x": torch.from_numpy(X0.copy())}


def _port_rounds(kw, rounds, x0=None):
    fl = FLConfig(**kw)
    strat = _bind(fl)
    step = build_round_step(LOSS, strat, fl, device="cpu")
    state = strat.init(_x0() if x0 is None else x0)
    pipe = _pipe(fl)
    mets = None
    for r in range(rounds):
        state, mets = step(state, pipe.round_batch(r))
    return state, mets


def _jax_rounds(kw, rounds):
    jfl = JFL(**kw)
    jtask = JDup(copies=(1, 2, 3))
    jpipe = JPipe(jtask, JPop.build(jfl, sizes=jtask.sizes()), jfl)
    jl = j_quad(3)
    jstrat = j_bind(j_strategy_for(jfl), jfl, jl, num_clients=3)
    jstep = jax.jit(j_build_step(jl, jstrat, jfl, num_clients=3))
    jstate = jstrat.init({"x": jnp.asarray(X0)})
    for r in range(rounds):
        jstate, jm = jstep(jstate, j_as_device(jpipe.round_batch(r)))
    return jstate, jm


def _close(got, want, what, atol=ATOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}", atol)
        return
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=what)


def _check_vs_jax(state, mets, jstate, jm, what):
    assert state.rnd == int(jstate.rnd), what
    _close(state.params, jstate.params, f"{what}: params")
    _close(state.opt, jstate.opt, f"{what}: opt")
    if jstate.clients is not None:
        _close(state.clients, jstate.clients, f"{what}: bank")
    else:
        assert state.clients is None, what
    for k in ("local_loss", "delta_norm", "cohort"):
        _close(mets[k], jm[k], f"{what}: {k}")


def _tree_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _tree_equal(a[k], b[k], f"{what}/{k}")
    elif a is None:
        assert b is None, what
    else:
        assert torch.equal(a, b), what


def _client(fl, slot=0):
    rb = as_device_batch(_pipe(fl).round_batch(0), "cpu")
    return {k: v[slot] for k, v in rb.data.items()}, rb.step_mask[slot]


# ---------------------------------------------------------------------------
# twins of tests/test_client_transforms.py
# ---------------------------------------------------------------------------


def test_empty_chain_is_bitwise_local_sgd():
    fl = _fl()
    data, mask = _client(fl)
    one = build_local_step(resolve_chain(ClientChain("sgd", ()), LOSS, fl), LOSS)
    eta = torch.tensor(0.0125)
    d_new, l_new, cs = one(_x0(), {"x": torch.zeros(3)}, {}, data, mask, eta, {})
    d_ref, l_ref = local_sgd(LOSS, _x0(), data, mask, eta)
    assert torch.equal(d_new["x"], d_ref["x"]) and torch.equal(l_new, l_ref) and cs == {}
    jd, jl = j_local_sgd(j_quad(3), {"x": jnp.asarray(X0)},
                         {k: jnp.asarray(v.numpy()) for k, v in data.items()},
                         jnp.asarray(mask.numpy()), jnp.float32(0.0125))
    _close(d_new["x"], jd["x"], "delta")
    _close(l_new, jl, "loss")


def test_mvr_chain_is_bitwise_local_mvr():
    fl = _fl(server_opt="mvr", mvr_a=0.2)
    data, mask = _client(fl)
    mom = {"x": torch.tensor([0.05, -0.2, 0.15])}
    one = build_local_step(resolve_chain(ClientChain("mvr", ("mvr",)), LOSS, fl), LOSS)
    eta = torch.tensor(0.0125)
    d_new, l_new, _ = one(_x0(), mom, {}, data, mask, eta, {})
    d_ref, l_ref = local_mvr(LOSS, _x0(), mom, data, mask, eta, 0.2)
    assert torch.equal(d_new["x"], d_ref["x"]) and torch.equal(l_new, l_ref)
    jd, _ = j_local_mvr(j_quad(3), {"x": jnp.asarray(X0)}, {"x": jnp.asarray(mom["x"].numpy())},
                        {k: jnp.asarray(v.numpy()) for k, v in data.items()},
                        jnp.asarray(mask.numpy()), jnp.float32(0.0125), 0.2)
    _close(d_new["x"], jd["x"], "delta")


@pytest.mark.parametrize("opt,lu,match", [
    ("sgd", "mvr", r"\['grad_estimate'\].*mvr"),
    ("momentum", "mvr", r"\['grad_estimate'\]"),
    ("momentum", "scaffold", r"\['c'\].*scaffold"),
    ("sgd", "sgdd", "unknown local update"),
    ("scaffold", "sgd", r"consumes.*scaffold"),
], ids=["mvr_without_momentum_server", "mvr_under_heavy_ball",
        "scaffold_local_without_scaffold_server", "unknown_local_update",
        "scaffold_server_with_stateless_chain"])
def test_bind_time_pairing_errors(opt, lu, match):
    fl = _fl(server_opt=opt, local_update=lu)
    with pytest.raises(ValueError, match=match):
        _bind(fl)


@pytest.mark.parametrize("kw,match", [(dict(local_update="local_clip", clip_norm=0.0), "clip_norm"),
                                      (dict(local_update="fedprox", prox_mu=0.0), "prox_mu")])
def test_clip_and_prox_require_positive_knobs(kw, match):
    with pytest.raises(ValueError, match=match):
        _bind(_fl(**kw))


def test_scaffold_server_with_foreign_stateful_chain_raises():
    def make_other_state(loss_fn, fl):
        return ClientTransform(
            name="other_state", init=lambda p: {},
            update=lambda step, d, carry, cstate: (d, carry),
            client_init=lambda p: {"c": {k: torch.zeros_like(v) for k, v in p.items()}},
            finalize=lambda end, carry, cstate: cstate, needs=("c",))

    register_client_transform("other_state", make_other_state)
    register_local_update("other_state_test", ClientChain("other_state_test", ("other_state",)))
    with pytest.raises(ValueError, match=r"consumes.*scaffold"):
        _bind(_fl(server_opt="scaffold", local_update="other_state_test"))


def test_duplicate_stateful_names_raise():
    register_local_update("twice_test", ClientChain("twice_test", ("scaffold", "scaffold")))
    with pytest.raises(ValueError, match="unique names"):
        _bind(_fl(server_opt="scaffold", local_update="twice_test"))


def test_stateful_round_step_rejects_bankless_state():
    fl = _fl(algorithm="fedavg", server_opt="scaffold")
    step = build_round_step(LOSS, _bind(fl), fl, device="cpu")
    legacy_state = init_server(fl, _x0())
    assert legacy_state.clients is None and sorted(legacy_state.opt) == ["c"]
    with pytest.raises(TypeError, match="client state bank"):
        step(legacy_state, _pipe(fl).round_batch(0))


def test_strategy_pinned_local_update_conflicts_raise():
    from repro_torch.core.algorithms import PRESETS as GEN

    pinned = register_strategy(FedStrategy(name="pinned_local_test", gen=GEN["fedshuffle"],
                                           local_update="fedprox"))
    fl = _fl(local_update="local_clip")
    with pytest.raises(ValueError, match="pins local_update"):
        bind_strategy(pinned, fl, LOSS, num_clients=3)
    assert bind_strategy(pinned, _fl(), LOSS, num_clients=3).local_update == "fedprox"


GRID = [("fedprox", "sgd"), ("local_clip", "sgd"), ("scaffold", "scaffold"), ("mvr", "mvr")]


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_cross_new_local_updates_match_jax(preset):
    """Every preset x every client rule: a round that moves, as JAX's does."""
    for lu, opt in GRID:
        kw = _kw(algorithm=preset, local_update=lu, server_opt=opt, cohort_mode="vmapped")
        assert _bind(FLConfig(**kw)).local_update == lu
        state, mets = _port_rounds(kw, 1, x0={"x": torch.zeros(3)})
        assert float(mets["delta_norm"]) > 0, (preset, lu)
        jfl = JFL(**kw)
        jpipe = JPipe(JDup(copies=(1, 2, 3)), JPop.build(jfl, sizes=TASK.sizes()), jfl)
        jl = j_quad(3)
        jstrat = j_bind(j_strategy_for(jfl), jfl, jl, num_clients=3)
        jstate, jm = j_build_step(jl, jstrat, jfl, num_clients=3)(
            jstrat.init({"x": jnp.zeros(3)}), j_as_device(jpipe.round_batch(0)))
        _check_vs_jax(state, mets, jstate, jm, f"{preset}/{lu}")


def test_custom_transform_composes_with_mvr():
    def make_tight_clip(loss_fn, fl):
        def update(step, d, carry, cstate):
            nrm = torch.sqrt(sum(torch.sum(x * x) for x in d.values()))
            s = torch.clamp_max(1e-3 / torch.clamp_min(nrm, 1e-12), 1.0)
            return {k: x * s for k, x in d.items()}, carry

        return ClientTransform(name="tight_clip", init=lambda p: {}, update=update)

    register_client_transform("tight_clip", make_tight_clip)
    register_local_update("mvr_clip_test", ClientChain("mvr_clip_test", ("mvr", "tight_clip")))
    state, _ = _port_rounds(_kw(server_opt="mvr", local_update="mvr_clip_test",
                                cohort_mode="sequential"), 1, x0={"x": torch.zeros(3)})
    assert 0 < float(torch.linalg.norm(state.params["x"])) < 1e-3


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_legacy_raw_local_update_still_works(mode):
    def make(loss_fn, fl):
        def one_client(params, momentum, data_i, mask_i, eta_i):
            return local_sgd(loss_fn, params, data_i, mask_i, eta_i)
        return one_client

    register_local_update("legacy_sgd_test", make)
    s_new, m_new = _port_rounds(_kw(local_update="legacy_sgd_test", cohort_mode=mode), 2)
    s_ref, m_ref = _port_rounds(_kw(cohort_mode=mode), 2)
    _tree_equal(s_new.params, s_ref.params, "params")
    _tree_equal(m_new, m_ref, "metrics")


def test_scaffold_state_bank_shape_and_scratch_row():
    kw = _kw(algorithm="fedavg", server_opt="scaffold")
    strat = _bind(FLConfig(**kw))
    assert strat.init(_x0()).clients["scaffold"]["c"]["x"].shape == (4, 3)
    state, _ = _port_rounds(kw, 4)
    bank = state.clients["scaffold"]["c"]["x"]
    assert not bank[-1].any() and bank[:-1].any()
    jstate, _ = _jax_rounds(kw, 4)
    _close(state.clients, jstate.clients, "bank")
    _close(state.opt["c"], jstate.opt["c"], "server c")


def test_scaffold_beats_fedavg_under_client_sampling():
    errs = {}
    for opt in ("sgd", "scaffold"):
        state, _ = _port_rounds(_kw(algorithm="fedavg", server_opt=opt, server_lr=1.0, seed=3,
                                    cohort_mode="sequential"), 400, x0={"x": torch.zeros(3)})
        errs[opt] = float(np.linalg.norm(state.params["x"].numpy() - TASK.optimum()))
    assert errs["scaffold"] < 0.02, errs
    assert errs["scaffold"] < 0.25 * errs["sgd"], errs


def test_scaffold_bucketed_engine_rotating_cohorts():
    """JAX's single-compilation guard's run: 200 clients, cohorts of 16
    rotating through the bucketed engine; the bank stays finite."""
    n = 200
    rng = np.random.default_rng(0)
    sizes = np.maximum(2, np.round(np.exp(rng.normal(np.log(8), 0.9, n)))).astype(np.int64)
    task = PopulationQuadraticTask(dim=4, num_clients=n, samples_per_client=8)
    fl = FLConfig(num_clients=n, cohort_size=16, sampling="uniform", epochs=2, local_batch=2,
                  algorithm="fedavg", local_lr=0.05, server_opt="scaffold", engine="cohort",
                  exec_mode="bucketed", buckets=4, rr_backend="device_ref", prefetch=0, seed=7)
    eng = CohortEngine.build(task, Population.build(fl, sizes=sizes), fl, device="cpu")
    assert len(eng.pipeline.bucket_layout.edges) > 1
    loss = make_quadratic_loss(4)
    strat = bind_strategy(strategy_for(fl), fl, loss, num_clients=n)
    step = build_round_step(loss, strat, fl, plane=eng.plane, device="cpu")
    state = strat.init({"x": torch.zeros(4)})
    cohorts = set()
    for r in range(8):
        plan = eng.device_plan(r)
        assert isinstance(plan, BucketedPlan)
        cohorts.add(tuple(plan.meta.client_id.tolist()))
        state, _ = step(state, plan)
    assert len(cohorts) > 1
    assert torch.isfinite(state.clients["scaffold"]["c"]["x"]).all()


def test_stateful_chain_respects_drop_last_steps_mask():
    kw = _kw(algorithm="fedavg", server_opt="scaffold", drop_last_steps=1)
    state, mets = _port_rounds(kw, 3)
    assert torch.isfinite(state.clients["scaffold"]["c"]["x"]).all()
    jstate, jm = _jax_rounds(kw, 3)
    _check_vs_jax(state, mets, jstate, jm, "drop_last_steps")


def test_bound_strategy_exposes_chain_and_state():
    strat = _bind(_fl(algorithm="fedavg", server_opt="scaffold"))
    assert strat.local_update == "scaffold" and strat.chain_state == ("scaffold",)
    tmpl = strat.client_state(_x0())
    assert set(tmpl) == {"scaffold"} and set(tmpl["scaffold"]) == {"c"}
    stateless = _bind(_fl())
    assert stateless.client_state is None and stateless.chain_state == ()
    assert stateless.init(_x0()).clients is None


@pytest.mark.parametrize("opt", ["sgd", "momentum", "mvr", "adam", "scaffold"])
def test_legacy_apply_server_matches_jax(opt):
    """``init_server`` / ``apply_server``, the legacy path without a round
    context: each opt's parameter step (and its state) as JAX's, 2 steps."""
    from repro.fed.server import apply_server as j_apply
    from repro.fed.server import init_server as j_init
    from repro_torch.fed.server import apply_server

    kw = _kw(server_opt=opt, server_lr=0.5)
    delta = np.array([0.1, -0.2, 0.05], np.float32)
    state = init_server(FLConfig(**kw), _x0())
    jstate = j_init(JFL(**kw), {"x": jnp.asarray(X0)})
    for _ in range(2):
        state = apply_server(FLConfig(**kw), state, {"x": torch.from_numpy(delta)}, 0.5)
        jstate = j_apply(JFL(**kw), jstate, {"x": jnp.asarray(delta)}, jnp.float32(0.5))
    assert state.rnd == int(jstate.rnd) == 2
    _close(state.params, jstate.params, f"{opt}: params")
    _close(state.opt, jstate.opt, f"{opt}: opt")


def test_bad_chain_transform_name_raises():
    register_local_update("broken_test", ClientChain("broken_test", ("nope",)))
    with pytest.raises(ValueError, match="unknown client transform"):
        _bind(_fl(local_update="broken_test"))


# ---------------------------------------------------------------------------
# the cohort form: every slot as the per-client step, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lu,opt", [("scaffold", "scaffold"), ("fedprox", "sgd"),
                                    ("local_clip", "sgd")])
def test_cohort_step_equals_per_client_step_bitwise(lu, opt):
    """Per-slot arithmetic: scaffold's K_i * eta_i and c_i, prox's y - x,
    clip's norm over each slot's own leaves (a tight bound so that every
    slot clips, each by its own factor)."""
    fl = _fl(local_update=lu, server_opt=opt, sampling="full", cohort_size=3, clip_norm=0.3,
             drop_last_steps=1)
    strat = _bind(fl)
    rb = as_device_batch(_pipe(fl).round_batch(0), "cpu")
    r = np.random.default_rng(5)
    rand = lambda *s: torch.from_numpy(r.normal(size=s).astype(np.float32))  # noqa: E731
    opt_state = {"c": {"x": rand(3)}} if opt == "scaffold" else {}
    cs = {"scaffold": {"c": {"x": rand(3, 3)}}} if lu == "scaffold" else {}
    eta = torch.tensor([0.05, 0.02, 0.0125])
    mom = {"x": torch.zeros(3)}
    starts = {"x": rand(3, 3)}
    assert (rb.step_mask.sum(1) != rb.step_mask.shape[1]).any()
    deltas, losses, cs_out = strat.cohort_step(starts, mom, opt_state, rb.data, rb.step_mask,
                                               eta, cs, stacked=True)
    for c in range(3):
        row = {k: {f: {n: t[c] for n, t in tree.items()} for f, tree in e.items()}
               for k, e in cs.items()}
        d, loss, cs_c = strat.local_step({"x": starts["x"][c]}, mom, opt_state,
                                         {k: v[c] for k, v in rb.data.items()},
                                         rb.step_mask[c], eta[c], row)
        assert torch.equal(deltas["x"][c], d["x"]) and torch.equal(losses[c], loss), (lu, c)
        if cs:
            assert torch.equal(cs_out["scaffold"]["c"]["x"][c], cs_c["scaffold"]["c"]["x"])
    if lu == "local_clip":
        unclipped = bind_strategy(None, _fl(sampling="full", cohort_size=3, drop_last_steps=1),
                                  LOSS, num_clients=3)
        free, _, _ = unclipped.cohort_step(starts, mom, {}, rb.data, rb.step_mask, eta, {},
                                           stacked=True)
        ratio = (deltas["x"].norm(dim=1) / free["x"].norm(dim=1)).tolist()
        assert max(ratio) < 1 and len(set(ratio)) == 3, ratio


# ---------------------------------------------------------------------------
# adam: 8 presets x 2 modes vs JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_adam_presets_match_jax(preset, mode):
    kw = _kw(algorithm=preset, server_opt="adam", cohort_mode=mode, drop_last_steps=1)
    state, mets = _port_rounds(kw, 4)
    jstate, jm = _jax_rounds(kw, 4)
    _check_vs_jax(state, mets, jstate, jm, f"adam/{preset}/{mode}")


# ---------------------------------------------------------------------------
# SCAFFOLD's bank within the port: layouts, paths, files
# ---------------------------------------------------------------------------

SCAF = dict(algorithm="fedavg", server_opt="scaffold")


def _train(kw, path, rounds=3):
    """``train()`` over the legacy pipeline or the engine (prefetch 0 or 2)."""
    fl = FLConfig(**kw)
    pop = Population.build(fl, sizes=TASK.sizes())
    if path == "legacy":
        src = FederatedPipeline(TASK, pop, fl)
    else:
        fl = dataclasses.replace(fl, engine="cohort", rr_backend="device_ref",
                                 prefetch=2 if path == "engine_prefetch" else 0)
        src = CohortEngine.build(TASK, pop, fl, device="cpu")
    res = train(LOSS, _x0(), src, fl, rounds, log_every=0, device="cpu")
    return res.state, [{k: v for k, v in r.items() if k != "elapsed_s"}
                       for r in res.metrics.rows]


def _same(a, b, what):
    (sa, ma), (sb, mb) = a, b
    assert sa.rnd == sb.rnd, what
    for part in ("params", "opt", "clients"):
        _tree_equal(getattr(sa, part), getattr(sb, part), f"{what}: {part}")
    assert ma == mb, what


@pytest.mark.parametrize("path", ["legacy", "engine", "engine_prefetch"])
@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_bucketed_matches_padded_scaffold_state(mode, path):
    kw = _kw(cohort_mode=mode, **SCAF)
    _same(_train(kw | {"exec_mode": "padded"}, path), _train(kw | {"exec_mode": "bucketed"}, path),
          f"scaffold/{mode}/{path}")


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_engine_matches_legacy_scaffold_state_bank(mode):
    kw = _kw(cohort_mode=mode, **SCAF)
    _same(_train(kw, "legacy"), _train(kw, "engine_prefetch"), f"scaffold/{mode}")


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_ef_codec_composes_with_stateful_chain(mode):
    kw = _kw(cohort_mode=mode, uplink="topk", **SCAF)
    pad = _train(kw | {"exec_mode": "padded"}, "legacy")
    assert set(pad[0].clients) == {"scaffold", "uplink"}
    _same(pad, _train(kw | {"exec_mode": "bucketed"}, "legacy"), f"scaffold+topk/{mode}/bucketed")
    _same(pad, _train(kw, "engine"), f"scaffold+topk/{mode}/engine")
    jstate, _ = _jax_rounds(kw, 3)
    _close(pad[0].clients, jstate.clients, "merged bank vs JAX")


def _scaffold_state(rounds=3):
    kw = _kw(seed=5, **SCAF)
    return _port_rounds(kw, rounds)[0], _bind(FLConfig(**kw)), kw


def test_server_state_roundtrip_with_bank(tmp_path):
    """Saved in the JAX file format: the port resumes it bitwise, JAX reads
    the same file, and a JAX-saved scaffold state loads in the port."""
    state, strat, kw = _scaffold_state()
    path = os.path.join(tmp_path, "state.npz")
    save_server_state(path, state, {"round": 2})
    restored = load_server_state(path, strat.init({"x": torch.zeros(3)}))
    for part in ("params", "opt", "clients"):
        _tree_equal(getattr(state, part), getattr(restored, part), part)
    assert restored.rnd == state.rnd == 3
    jfl = JFL(**kw)
    jstrat = j_bind(j_strategy_for(jfl), jfl, j_quad(3), num_clients=3)
    jgot = j_ckpt.load_server_state(path, jstrat.init({"x": jnp.zeros(3)}))
    assert j_ckpt.load_metadata(path)["has_client_state"] is True
    _close(state.clients, jgot.clients, "JAX reads the bank", atol=0)
    _close(state.opt, jgot.opt, "JAX reads c", atol=0)
    jstate, _ = _jax_rounds(kw, 3)
    jpath = os.path.join(tmp_path, "jax.npz")
    j_ckpt.save_server_state(jpath, jstate)
    from_j = load_server_state(jpath, strat.init({"x": torch.zeros(3)}))
    want = server_state_from_jax(jax.tree.map(np.asarray, jstate), None, "cpu")
    for part in ("params", "opt", "clients"):
        _tree_equal(getattr(from_j, part), getattr(want, part), f"JAX file: {part}")
    # and the port continues from it as JAX does
    fl = FLConfig(**kw)
    step = build_round_step(LOSS, strat, fl, device="cpu")
    cont, mets = step(from_j, _pipe(fl).round_batch(3))
    jcont, jm = _jax_rounds(kw, 4)
    _check_vs_jax(cont, mets, jcont, jm, "resumed from JAX")


def test_server_state_template_mismatch_raises(tmp_path):
    state, strat, kw = _scaffold_state(0)
    path = os.path.join(tmp_path, "state.npz")
    save_server_state(path, state)
    plain = _bind(FLConfig(**(kw | dict(server_opt="sgd"))))
    with pytest.raises(ValueError, match="state bank"):
        load_server_state(path, plain.init({"x": torch.zeros(3)}))


def test_server_state_shape_mismatch_raises(tmp_path):
    state, strat, kw = _scaffold_state(0)
    path = os.path.join(tmp_path, "state.npz")
    save_server_state(path, state)
    strat6 = _bind(FLConfig(**(kw | dict(num_clients=6, cohort_size=3))))
    with pytest.raises(ValueError, match="shape"):
        load_server_state(path, strat6.init({"x": torch.zeros(3)}))


# ---------------------------------------------------------------------------
# CharLM-tiny: SCAFFOLD through the cohort engine vs JAX
# ---------------------------------------------------------------------------

TINY_FL = dict(num_clients=6, cohort_size=3, sampling="uniform", epochs=1, local_batch=2,
               algorithm="fedshuffle", local_lr=0.05, imbalance="lognormal", mean_samples=3,
               seed=1, engine="cohort", rr_backend="device_ref", prefetch=0,
               server_opt="scaffold")


def _leafwise_close(got: dict, want: dict, what: str):
    """Each leaf within atol 1e-6 + rtol 1e-4 of that leaf's largest magnitude."""
    assert got.keys() == want.keys(), what
    for k in want:
        g, w = got[k].cpu().numpy(), want[k].cpu().numpy()
        assert np.abs(g - w).max() <= 1e-6 + 1e-4 * np.abs(w).max(), f"{what}: {k}"


@pytest.mark.parametrize("mode", ["vmapped", "sequential"])
def test_charlm_tiny_scaffold_matches_jax(mode):
    rounds = 2
    kw = TINY_FL | dict(cohort_mode=mode)
    jfl = JFL(**kw)
    jtask = JCharLM(vocab=J_TINY.vocab, seq_len=16, num_clients=6)
    jmodel = j_build_model(J_TINY)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jloss = j_make_loss(jmodel)
    jeng = JEngine.build(jtask, JPop.build(jfl), jfl)
    jstrat = j_bind(j_strategy_for(jfl), jfl, jloss, num_clients=6)
    jstep = jax.jit(j_build_step(jloss, jstrat, jfl, num_clients=6, plane=jeng.plane))
    jstate = jstrat.init(jparams)
    for r in range(rounds):
        jstate, _ = jstep(jstate, jeng.device_plan(r))
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    cfg = ArchConfig(**{k: v for k, v in dataclasses.asdict(J_TINY).items() if k in fields})
    loss = make_loss(build_model(cfg))
    fl = FLConfig(**kw)
    eng = CohortEngine.build(CharLMTask(vocab=cfg.vocab, seq_len=16, num_clients=6),
                             Population.build(fl), fl, device="cpu")
    strat = bind_strategy(strategy_for(fl), fl, loss, num_clients=6)
    step = build_round_step(loss, strat, fl, plane=eng.plane, device="cpu")
    state = strat.init(params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    for r in range(rounds):
        state, _ = step(state, eng.device_plan(r))
    want = server_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    _leafwise_close(state.params, want.params, "params")
    _leafwise_close(state.opt["c"], want.opt["c"], "server c")
    bank, jbank = state.clients["scaffold"]["c"], want.clients["scaffold"]["c"]
    assert not any(v[-1].any() for v in bank.values())              # scratch row
    _leafwise_close(bank, jbank, "bank")
