"""The PyTorch port's FedShuffleMVR (``server_opt="mvr"``) against the JAX
package, and its contracts within the port.

* ``local_mvr``, the ``("mvr",)`` chain and ``full_local_gradient`` vs JAX on
  the quadratic (atol 1e-6) and on CharLM-tiny (each leaf within atol 1e-6
  + rtol 1e-4 of its largest magnitude: fp32 on the CPU, the two
  frameworks' matrix products sum in other orders); the chain equals
  ``local_mvr`` BITWISE within the port;
* rounds on the quadratic, 8 presets x ``mvr_exact`` in {False, True}, 4
  rounds, vs JAX: the exact eq. 14 mode at atol 1e-6 (the tolerance of the
  sgd / momentum presets); App. F at rtol 1e-5 + atol 1e-6, because the
  port's server step multiplies by ``1/eta_l`` (the kernel's math, the plain
  version on the CPU) where JAX divides by ``eta_l``, which moves m by an
  ulp and the next rounds' corrected steps with it;
* a qsgd uplink with mvr vs JAX; a run continued in the port from a JAX mvr
  state taken mid-run (``m``, and ``x_prev`` in the exact mode);
* a CharLM-tiny mvr run through the cohort engine vs JAX, both modes;
* within the port, bitwise: engine == legacy with mvr; bind-time errors
  (mvr steps under an opt without a gradient estimate, unported opts);
* on a card (``cuda``-marked, skipped without one): App. F rounds launch the
  CUDA kernel once a round and land where the CPU run does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.paper_tasks import CHARLM_TINY as J_TINY  # noqa: E402
from repro.core.local import full_local_gradient as j_full_grad  # noqa: E402
from repro.core.local import local_mvr as j_local_mvr  # noqa: E402
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
from repro_torch.core.local import (build_local_step, full_local_gradient,  # noqa: E402
                                   local_mvr, resolve_chain)
from repro_torch.data.federated import FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import CharLMTask, DuplicatedQuadraticTask  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.losses import make_loss, make_quadratic_loss  # noqa: E402
from repro_torch.fed.rounds import as_device_batch, build_round_step  # noqa: E402
from repro_torch.fed.strategy import LOCAL_UPDATES, bind_strategy, strategy_for  # noqa: E402
from repro_torch.fed.train_loop import train  # noqa: E402
from repro_torch.kernels.server_update.kernel import server_update_kernel  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.weights import params_from_jax, server_state_from_jax  # noqa: E402

PRESETS = ["fedshuffle", "fedavg", "fedavg_so", "fedshuffle_so", "fednova",
           "fedavg_min", "fedavg_mean", "gen"]
TASK = DuplicatedQuadraticTask(copies=(1, 2, 3))
LOSS = make_quadratic_loss(3)
X0 = np.array([0.3, -0.1, 0.2], np.float32)
A = 0.2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quad_kw(preset, exact, **kw):
    return dict(num_clients=3, cohort_size=2, sampling="uniform", epochs=2, local_batch=1,
                algorithm=preset, local_lr=0.05, server_lr=0.8, server_opt="mvr", mvr_a=A,
                mvr_exact=exact, cohort_mode="sequential", drop_last_steps=1, seed=11) | kw


def _jfl(**kw):
    if kw.get("uplink_backend") == "kernel":
        kw = kw | {"uplink_backend": "pallas"}
    return JFL(**kw)


def _jax_quad(kw, rounds, *, keep=None):
    jfl = _jfl(**kw)
    jtask = JDup(copies=(1, 2, 3))
    jpipe = JPipe(jtask, JPop.build(jfl, sizes=jtask.sizes()), jfl)
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


def _port_quad(kw, rounds, *, engine=None, state=None, start=0, device="cpu"):
    fl = FLConfig(**kw)
    pop = Population.build(fl, sizes=TASK.sizes())
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=3)
    if state is None:
        state = strat.init({"x": torch.from_numpy(X0.copy()).to(device)})
    if engine is None:
        step = build_round_step(LOSS, strat, fl, device=device)
        next_batch = FederatedPipeline(TASK, pop, fl).round_batch
    else:
        eng = CohortEngine.build(TASK, pop, fl, rr_backend=engine, device=device)
        step = build_round_step(LOSS, strat, fl, plane=eng.plane, device=device)
        next_batch = eng.device_plan
    for r in range(start, start + rounds):
        state, mets = step(state, next_batch(r))
    return state, mets


def _check_state(state, mets, jstate, jm, *, rtol, atol):
    assert state.rnd == int(jstate.rnd)
    assert sorted(state.opt) == sorted(jstate.opt)
    np.testing.assert_allclose(state.params["x"].cpu().numpy(), np.asarray(jstate.params["x"]),
                               rtol=rtol, atol=atol, err_msg="params")
    for k, tree in jstate.opt.items():
        np.testing.assert_allclose(state.opt[k]["x"].cpu().numpy(), np.asarray(tree["x"]),
                                   rtol=rtol, atol=atol, err_msg=f"opt[{k}]")
    for k in ("local_loss", "delta_norm", "cohort"):
        np.testing.assert_allclose(float(mets[k]), float(jm[k]), rtol=max(rtol, 1e-6),
                                   atol=atol, err_msg=k)


def _tol(exact):
    # exact eq. 14: the torch math of the JAX package; App. F: 1/eta_l (see top)
    return dict(rtol=0, atol=1e-6) if exact else dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# local steps and the full local gradient
# ---------------------------------------------------------------------------


def _quad_client(slot=0):
    fl = FLConfig(**_quad_kw("fedshuffle", False))
    rb = as_device_batch(FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
                         .round_batch(0), "cpu")
    return {k: v[slot] for k, v in rb.data.items()}, rb.step_mask[slot]


def test_local_mvr_and_chain_match_jax_quadratic():
    data, mask = _quad_client()
    params = {"x": torch.from_numpy(X0.copy())}
    mom = {"x": torch.tensor([0.05, -0.2, 0.15])}
    eta = torch.tensor(0.0125)
    d0, l0 = local_mvr(LOSS, params, mom, data, mask, eta, A)
    one = build_local_step(resolve_chain(LOCAL_UPDATES["mvr"], LOSS, FLConfig(mvr_a=A)), LOSS)
    d1, l1, _ = one(params, mom, {}, data, mask, eta, {})
    assert torch.equal(d0["x"], d1["x"]) and torch.equal(l0, l1)
    jd, jl = j_local_mvr(j_quad(3), {"x": jnp.asarray(X0)}, {"x": jnp.asarray(mom["x"].numpy())},
                         {k: jnp.asarray(v.numpy()) for k, v in data.items()},
                         jnp.asarray(mask.numpy()), jnp.float32(0.0125), A)
    np.testing.assert_allclose(d0["x"].numpy(), np.asarray(jd["x"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(l0), float(jl), rtol=1e-6, atol=1e-6)


def test_full_local_gradient_matches_jax_quadratic():
    data, mask = _quad_client(1)
    got = full_local_gradient(LOSS, {"x": torch.from_numpy(X0.copy())}, data, mask)
    want = j_full_grad(j_quad(3), {"x": jnp.asarray(X0)},
                       {k: jnp.asarray(v.numpy()) for k, v in data.items()}, jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), rtol=0, atol=1e-6)
    assert got["x"].dtype == torch.float32


def _port_tiny_cfg():
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in dataclasses.asdict(J_TINY).items() if k in fields})


def _leafwise_close(got: dict, want: dict, what: str):
    """Each leaf within atol 1e-6 + rtol 1e-4 of that leaf's largest magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        assert np.abs(g - w).max() <= 1e-6 + 1e-4 * np.abs(w).max(), f"{what}: {k}"


def test_local_mvr_chain_and_full_gradient_match_jax_charlm_tiny():
    cfg = _port_tiny_cfg()
    jmodel = j_build_model(J_TINY)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jloss = j_make_loss(jmodel)
    loss = make_loss(build_model(cfg))
    r = np.random.default_rng(3)
    K, B = 3, 2
    toks = r.integers(0, cfg.vocab, size=(K, B, 17)).astype(np.int32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    jmom = jax.tree.map(lambda t: jnp.asarray(r.normal(size=t.shape).astype(np.float32) * 0.01),
                        jparams)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params = params_from_jax(np_tree(jparams), cfg, "cpu")
    mom = params_from_jax(np_tree(jmom), cfg, "cpu")
    data = {"tokens": torch.from_numpy(toks)}
    eta = torch.tensor(0.05)
    d0, l0 = local_mvr(loss, params, mom, data, mask_t := torch.from_numpy(mask), eta, A)
    one = build_local_step(resolve_chain(LOCAL_UPDATES["mvr"], loss, FLConfig(mvr_a=A)), loss)
    d1, l1, _ = one(params, mom, {}, data, mask_t, eta, {})
    assert all(torch.equal(d0[k], d1[k]) for k in d0) and torch.equal(l0, l1)
    jd, jl = j_local_mvr(jloss, jparams, jmom, {"tokens": jnp.asarray(toks)}, jnp.asarray(mask),
                         jnp.float32(0.05), A)
    _leafwise_close(d0, params_from_jax(np_tree(jd), cfg, "cpu"), "local_mvr delta")
    np.testing.assert_allclose(float(l0), float(jl), rtol=1e-5)
    g = full_local_gradient(loss, params, data, mask_t)
    jg = j_full_grad(jloss, jparams, {"tokens": jnp.asarray(toks)}, jnp.asarray(mask))
    _leafwise_close(g, params_from_jax(np_tree(jg), cfg, "cpu"), "full_local_gradient")


# ---------------------------------------------------------------------------
# rounds on the quadratic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exact", [False, True], ids=["appF", "exact"])
@pytest.mark.parametrize("preset", PRESETS)
def test_mvr_rounds_match_jax(preset, exact):
    kw = _quad_kw(preset, exact)
    jstate, jm, _ = _jax_quad(kw, 4)
    state, mets = _port_quad(kw, 4)
    _check_state(state, mets, jstate, jm, **_tol(exact))
    assert not np.allclose(state.opt["m"]["x"].numpy(), 0.0)


@pytest.mark.parametrize("exact", [False, True], ids=["appF", "exact"])
def test_mvr_with_qsgd_uplink_matches_jax(exact):
    """MVR consumes the decoded aggregate; the plain quantize version on the
    CPU (backend "kernel") against JAX's Pallas kernel in interpret mode."""
    kw = _quad_kw("fedshuffle", exact, uplink="qsgd", uplink_bits=4, uplink_chunk=2)
    jstate, jm, _ = _jax_quad(kw, 3)
    state, mets = _port_quad(kw, 3)
    _check_state(state, mets, jstate, jm, **_tol(exact))
    np.testing.assert_allclose(float(mets["uplink_mbytes"]), float(jm["uplink_mbytes"]), rtol=1e-6)


@pytest.mark.parametrize("exact", [False, True], ids=["appF", "exact"])
def test_port_continues_a_jax_mvr_state_taken_mid_run(exact):
    kw = _quad_kw("fednova", exact, sampling="independent")
    jstate, jm, kept = _jax_quad(kw, 4, keep=2)
    state = server_state_from_jax(kept, None, "cpu")
    assert state.rnd == 2 and sorted(state.opt) == (["m", "x_prev"] if exact else ["m"])
    state, mets = _port_quad(kw, 2, state=state, start=2)
    _check_state(state, mets, jstate, jm, **_tol(exact))


@pytest.mark.parametrize("exact", [False, True], ids=["appF", "exact"])
@pytest.mark.parametrize("sampling,preset", [("uniform", "fedshuffle"), ("independent", "fedavg")])
def test_mvr_engine_matches_legacy_bitwise(sampling, preset, exact):
    kw = _quad_kw(preset, exact, sampling=sampling, engine="cohort", prefetch=0)
    legacy, lm = _port_quad(kw, 3)
    eng, em = _port_quad(kw, 3, engine="host")
    assert torch.equal(legacy.params["x"], eng.params["x"])
    assert sorted(legacy.opt) == sorted(eng.opt)
    for k in legacy.opt:
        assert torch.equal(legacy.opt[k]["x"], eng.opt[k]["x"]), k
    for k in lm:
        assert torch.equal(lm[k], em[k]), k


def test_mvr_init_copies_params_and_outputs_are_new():
    """``x_prev`` owns its buffers, and a round leaves the input state as it
    was (the server step writes new tensors)."""
    fl = FLConfig(**_quad_kw("fedshuffle", True))
    strat = bind_strategy(None, fl, LOSS, num_clients=3)
    x = {"x": torch.from_numpy(X0.copy())}
    s0 = strat.init(x)
    assert s0.opt["x_prev"]["x"].data_ptr() != s0.params["x"].data_ptr() != x["x"].data_ptr()
    for exact in (False, True):
        fl = FLConfig(**_quad_kw("fedshuffle", exact))
        strat = bind_strategy(None, fl, LOSS, num_clients=3)
        s0 = strat.init(x)
        keep = {k: v["x"].clone() for k, v in s0.opt.items()}
        step = build_round_step(LOSS, strat, fl, device="cpu")
        s1, _ = step(s0, FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
                     .round_batch(0))
        assert torch.equal(s0.params["x"], torch.from_numpy(X0))
        assert all(torch.equal(s0.opt[k]["x"], v) for k, v in keep.items())
        assert not torch.equal(s1.params["x"], s0.params["x"])


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_mvr_steps_need_a_gradient_estimate(opt):
    """mvr local steps under an opt without ``grad_estimate`` would read
    zeros (sgd) or heavy-ball's delta momentum: the JAX package's bind-time
    ValueError."""
    fl = FLConfig(**_quad_kw("fedshuffle", False, server_opt=opt, local_update="mvr"))
    with pytest.raises(ValueError, match=r"\['grad_estimate'\].*mvr"):
        bind_strategy(strategy_for(fl), fl, LOSS, num_clients=3)
    with pytest.raises(ValueError, match=r"\['grad_estimate'\]"):
        j_bind(j_strategy_for(JFL(**_quad_kw("fedshuffle", False, server_opt=opt,
                                             local_update="mvr"))),
               JFL(**_quad_kw("fedshuffle", False, server_opt=opt, local_update="mvr")),
               j_quad(3), num_clients=3)


def test_server_opt_consuming_absent_client_state_raises():
    """The mirror of the needs/provides check: a server opt that folds in a
    stateful client transform's cohort state refuses a chain without it."""
    from repro_torch.fed import strategy as strat_mod

    strat_mod.SERVER_OPTS["_consumer"] = strat_mod.SERVER_OPTS["sgd"]._replace(
        name="_consumer", consumes=("scaffold",))
    try:
        fl = FLConfig(**_quad_kw("fedshuffle", False, server_opt="_consumer"))
        with pytest.raises(ValueError, match=r"consumes per-client state.*\['scaffold'\]"):
            bind_strategy(None, fl, LOSS, num_clients=3)
    finally:
        del strat_mod.SERVER_OPTS["_consumer"]


@pytest.mark.parametrize("kw,what", [
    (dict(server_opt="adam"), "adam"),
    (dict(server_opt="scaffold"), "scaffold"),
    (dict(server_opt="sgd", local_update="fedprox"), "fedprox"),
    (dict(server_opt="sgd", local_update="local_clip"), "local_clip"),
])
def test_unported_mvr_neighbours_raise(kw, what):
    """The neighbours of mvr once refused as unported now bind (the local
    rule each resolves to) and run 2 rounds as the JAX package does (atol
    1e-6, the sgd presets' tolerance)."""
    kw = _quad_kw("fedshuffle", False) | kw
    strat = bind_strategy(None, FLConfig(**kw), LOSS, num_clients=3)
    assert strat.local_update == {"adam": "sgd"}.get(what, what)
    state, mets = _port_quad(kw, 2)
    jstate, jm, _ = _jax_quad(kw, 2)
    _check_state(state, mets, jstate, jm, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# CharLM-tiny through the cohort engine
# ---------------------------------------------------------------------------

TINY_FL = dict(num_clients=4, cohort_size=2, sampling="uniform", epochs=1, local_batch=2,
               algorithm="fedshuffle", local_lr=0.05, imbalance="lognormal", mean_samples=3,
               cohort_mode="sequential", seed=1, engine="cohort", rr_backend="device_ref",
               prefetch=0, server_opt="mvr", mvr_a=A)


@pytest.mark.parametrize("exact", [False, True], ids=["appF", "exact"])
def test_charlm_tiny_mvr_matches_jax(exact):
    rounds = 2
    kw = TINY_FL | {"mvr_exact": exact}
    jfl = JFL(**kw)
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

    cfg = _port_tiny_cfg()
    model = build_model(cfg)
    fl = FLConfig(**kw | {"rr_backend": "device"})
    eng = CohortEngine.build(CharLMTask(vocab=cfg.vocab, seq_len=16, num_clients=4),
                             Population.build(fl), fl, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    res = train(make_loss(model), params, eng, fl, rounds, log_every=0, device="cpu")
    np_tree = lambda t: params_from_jax(jax.tree.map(np.asarray, t), cfg, "cpu")  # noqa: E731
    _leafwise_close(res.state.params, np_tree(jstate.params), "params")
    for k, tree in jstate.opt.items():
        _leafwise_close(res.state.opt[k], np_tree(tree), f"opt[{k}]")
    np.testing.assert_allclose(res.metrics.last()["local_loss"], float(jm["local_loss"]),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["fedshuffle", "fedavg"])
def test_cuda_mvr_rounds_launch_the_kernel_and_match_cpu(preset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = _quad_kw(preset, False)
    cpu, _ = _port_quad(kw, 4)
    before = server_update_kernel.launches
    gpu, _ = _port_quad(kw, 4, device="cuda")
    assert server_update_kernel.launches - before == 4
    for got, want in ((gpu.params["x"], cpu.params["x"]), (gpu.opt["m"]["x"], cpu.opt["m"]["x"])):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
