"""The PyTorch port's round step, cohort engine and train loop.

* all 8 presets x {sgd, momentum}: 3 sequential rounds on the duplicated
  quadratic, port vs JAX on the same ``round_batch`` stream, atol 1e-6;
* the paper claim (twin of ``test_objective_consistency.py``): FedAvg goes
  to the biased point, FedShuffle and FedNova to x*;
* a CharLM-tiny round through the cohort engine, JAX ``device_ref`` vs the
  port on the CPU, rtol 1e-4 (fp32, summation order differs);
* within the port, bitwise: engine == legacy, the four RR backends agree,
  the empty chain == ``local_sgd``;
* hygiene: the port imports neither JAX nor ``repro``, and its entry points
  raise without CUDA unless asked for the CPU.
"""
import dataclasses
import pathlib
import re
import subprocess
import sys

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
from repro.fed.strategy import weighted_sum as j_weighted_sum  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig  # noqa: E402
from repro_torch.core.local import ClientTransform, build_local_step, local_sgd  # noqa: E402
from repro_torch.data.federated import FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import CharLMTask, DuplicatedQuadraticTask  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.losses import make_loss, make_quadratic_loss  # noqa: E402
from repro_torch.fed.rounds import as_device_batch, build_round_step  # noqa: E402
from repro_torch.fed.strategy import bind_strategy, strategy_for, weighted_sum  # noqa: E402
from repro_torch.fed.train_loop import train  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

PRESETS = ["fedshuffle", "fedavg", "fedavg_so", "fedshuffle_so", "fednova",
           "fedavg_min", "fedavg_mean", "gen"]
TASK = DuplicatedQuadraticTask(copies=(1, 2, 3))
LOSS = make_quadratic_loss(3)
X0 = np.array([0.3, -0.1, 0.2], np.float32)
PORT_SRC = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quad_kw(preset, opt, **kw):
    return dict(num_clients=3, cohort_size=2, sampling="uniform", epochs=2, local_batch=1,
                algorithm=preset, local_lr=0.05, server_lr=0.8, server_opt=opt,
                cohort_mode="sequential", drop_last_steps=1, seed=11) | kw


def _port_quad(kw, rounds, *, engine=None):
    fl = FLConfig(**kw)
    pop = Population.build(fl, sizes=TASK.sizes())
    strat = bind_strategy(strategy_for(fl), fl, LOSS, num_clients=3)
    state = strat.init({"x": torch.from_numpy(X0.copy())})
    if engine is None:
        pipe = FederatedPipeline(TASK, pop, fl)
        step = build_round_step(LOSS, strat, fl, device="cpu")
        next_batch = pipe.round_batch
    else:
        eng = CohortEngine.build(TASK, pop, fl, rr_backend=engine, device="cpu")
        step = build_round_step(LOSS, strat, fl, plane=eng.plane, device="cpu")
        next_batch = eng.device_plan
    for r in range(rounds):
        state, mets = step(state, next_batch(r))
    return state, mets


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
@pytest.mark.parametrize("preset", PRESETS)
def test_presets_match_jax(preset, opt):
    kw = _quad_kw(preset, opt)
    jfl = JFL(**kw)
    jpop = JPop.build(jfl, sizes=JDup(copies=(1, 2, 3)).sizes())
    jpipe = JPipe(JDup(copies=(1, 2, 3)), jpop, jfl)
    jl = j_quad(3)
    jstrat = j_bind(j_strategy_for(jfl), jfl, jl, num_clients=3)
    jstate = jstrat.init({"x": jnp.asarray(X0)})
    jstep = jax.jit(j_build_step(jl, jstrat, jfl, num_clients=3))
    for r in range(3):
        jstate, jm = jstep(jstate, j_as_device(jpipe.round_batch(r)))
    state, mets = _port_quad(kw, 3)
    np.testing.assert_allclose(state.params["x"].numpy(), np.asarray(jstate.params["x"]),
                               atol=1e-6, rtol=0)
    if opt == "momentum":
        np.testing.assert_allclose(state.opt["m"]["x"].numpy(),
                                   np.asarray(jstate.opt["m"]["x"]), atol=1e-6, rtol=0)
    assert state.rnd == int(jstate.rnd) == 3
    for k in ("local_loss", "delta_norm", "cohort"):
        np.testing.assert_allclose(float(mets[k]), float(jm[k]), atol=1e-6, rtol=1e-6)


def _run_paper(alg, rounds, lr):
    fl = FLConfig(num_clients=3, cohort_size=3, sampling="full", epochs=1, local_batch=1,
                  algorithm=alg, local_lr=lr, cohort_mode="sequential")
    pipe = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)
    res = train(LOSS, {"x": torch.zeros(3)}, pipe, fl, rounds, log_every=0, device="cpu")
    return res.state.params["x"].numpy()


def test_fedavg_converges_to_biased_point():
    x = _run_paper("fedavg", 800, 0.02)
    assert np.allclose(x, TASK.fedavg_biased_point(), atol=0.02)
    assert not np.allclose(x, TASK.optimum(), atol=0.05)


@pytest.mark.parametrize("alg,rounds,lr", [("fedshuffle", 800, 0.05), ("fednova", 1500, 0.02)])
def test_consistent_algorithms_converge_to_optimum(alg, rounds, lr):
    x = _run_paper(alg, rounds, lr)
    assert np.allclose(x, TASK.optimum(), atol=0.02 if alg == "fednova" else 0.01)


TINY_FL = dict(num_clients=4, cohort_size=2, sampling="uniform", epochs=1, local_batch=2,
               algorithm="fedshuffle", local_lr=0.05, imbalance="lognormal", mean_samples=3,
               cohort_mode="sequential", seed=1, engine="cohort", rr_backend="device_ref",
               prefetch=0)


def _port_charlm_cfg():
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in dataclasses.asdict(J_TINY).items() if k in fields})


@pytest.mark.parametrize("sampling", ["uniform", "independent"])
def test_charlm_tiny_cohort_round_matches_jax(sampling):
    """Independent sampling leaves padding slots (client -1), which gather
    the table bank's last client like the JAX package's ``jnp.take``."""
    rounds = 2
    tiny_fl = TINY_FL | {"sampling": sampling}
    jfl = JFL(**tiny_fl)
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

    cfg = _port_charlm_cfg()
    model = build_model(cfg)
    for backend in ("device_ref", "device"):
        fl = FLConfig(**tiny_fl | {"rr_backend": backend})
        task = CharLMTask(vocab=cfg.vocab, seq_len=16, num_clients=4)
        eng = CohortEngine.build(task, Population.build(fl), fl, device="cpu")
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
        res = train(make_loss(model), params, eng, fl, rounds, log_every=0, device="cpu")
        want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg, "cpu")
        for k in want:
            np.testing.assert_allclose(res.state.params[k].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{backend}: {k}")
        np.testing.assert_allclose(res.metrics.last()["local_loss"], float(jm["local_loss"]),
                                   rtol=1e-4)


@pytest.mark.parametrize("sampling,preset", [("uniform", "fedshuffle"), ("independent", "fednova"),
                                             ("uniform", "fedavg_min")])
def test_engine_matches_legacy_bitwise(sampling, preset):
    """Host-index engine rounds == host-assembled RoundBatch rounds, bit for
    bit; independent sampling adds padding slots (client -1)."""
    kw = _quad_kw(preset, "momentum", sampling=sampling, engine="cohort", prefetch=0)
    legacy, lm = _port_quad(kw, 3)
    eng, em = _port_quad(kw, 3, engine="host")
    assert torch.equal(legacy.params["x"], eng.params["x"])
    assert torch.equal(legacy.opt["m"]["x"], eng.opt["m"]["x"])
    for k in lm:
        assert torch.equal(lm[k], em[k]), k


@pytest.mark.parametrize("preset", ["fedshuffle", "fedavg_mean"])
def test_cipher_backends_agree_bitwise(preset):
    """The host numpy mirror, the plain torch version and the CPU route of
    the kernel dispatch gather identical round data from a table bank
    (rr mode; wr for the equalized preset), padding slots included."""
    kw = TINY_FL | dict(algorithm=preset, sampling="independent", num_clients=6)
    task = CharLMTask(vocab=32, seq_len=4, num_clients=6)
    batches = {}
    for backend in ("host_feistel", "device_ref", "device"):
        fl = FLConfig(**kw | {"rr_backend": backend})
        eng = CohortEngine.build(task, Population.build(fl), fl, device="cpu")
        batches[backend] = [eng.plane.materialize(eng.device_plan(r)) for r in range(3)]
    assert any((b.meta.client_id < 0).any() for b in batches["device"])
    for backend in ("device_ref", "device"):
        for want, got in zip(batches["host_feistel"], batches[backend]):
            assert torch.equal(want.data["tokens"], got.data["tokens"]), backend


def test_empty_chain_equals_local_sgd_bitwise():
    rng = np.random.default_rng(0)
    params = {"x": torch.from_numpy(rng.normal(size=3).astype(np.float32))}
    data = {"e": torch.from_numpy(rng.normal(size=(5, 2, 3)).astype(np.float32))}
    mask = torch.tensor([1, 1, 1, 0, 0], dtype=torch.float32)
    eta = torch.tensor(0.07)
    d0, l0 = local_sgd(LOSS, params, data, mask, eta)
    d1, l1, cs = build_local_step((), LOSS)(params, {"x": torch.zeros(3)}, {}, data, mask, eta, {})
    assert torch.equal(d0["x"], d1["x"]) and torch.equal(l0, l1) and cs == {}


def test_chain_transform_carry_skips_masked_steps():
    """A transform's carry advances on real steps only; its direction change
    reaches the update (here: a running sum of gradients as the direction)."""

    def update(step, d, carry, cstate):
        acc = {n: carry[n] + d[n] for n in d}
        return acc, acc

    t = ClientTransform(name="sum", update=update,
                        init=lambda p: {n: torch.zeros_like(v) for n, v in p.items()})
    x = {"x": torch.tensor([1.0, -2.0, 0.5])}
    data = {"e": torch.zeros(4, 1, 3)}
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0])
    eta = torch.tensor(0.1)
    delta, _, _ = build_local_step((t,), LOSS)(x, {"x": torch.zeros(3)}, {}, data, mask, eta, {})
    # by hand: g = 2 y; step 1 d = g0, step 2 d = g0 + g1; masked steps move nothing
    y0 = x["x"]
    y1 = y0 - 0.1 * (2 * y0)
    y2 = y1 - 0.1 * (2 * y0 + 2 * y1)
    torch.testing.assert_close(delta["x"], y2 - y0, rtol=0, atol=1e-7)


def test_weighted_sum_matches_jax():
    rng = np.random.default_rng(2)
    deltas = {"a": rng.normal(size=(4, 3, 5)).astype(np.float32),
              "b": rng.normal(size=(4, 7)).astype(np.float32)}
    coeff = rng.normal(size=4).astype(np.float32)
    want = j_weighted_sum({k: jnp.asarray(v) for k, v in deltas.items()}, jnp.asarray(coeff))
    got = weighted_sum({k: torch.from_numpy(v) for k, v in deltas.items()}, torch.from_numpy(coeff))
    for k in deltas:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw,what", [
    (dict(server_opt="adam"), "adam"),
    (dict(server_opt="scaffold", local_update="scaffold"), "scaffold"),
])
def test_unported_configs_raise(kw, what):
    """Once refused as unported, these configurations now bind, run a
    round and land where the JAX package's round does (atol 1e-6)."""
    kw = _quad_kw("fedshuffle", "sgd") | kw
    fl = FLConfig(**kw)
    strat = bind_strategy(None, fl, LOSS, num_clients=3)
    assert strat.local_update == ("scaffold" if what == "scaffold" else "sgd")
    state = strat.init({"x": torch.from_numpy(X0.copy())})
    rb = FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl).round_batch(0)
    state, mets = build_round_step(LOSS, strat, fl, device="cpu")(state, rb)
    jfl = JFL(**kw)
    jpipe = JPipe(JDup(copies=(1, 2, 3)), JPop.build(jfl, sizes=TASK.sizes()), jfl)
    jl = j_quad(3)
    jstrat = j_bind(j_strategy_for(jfl), jfl, jl, num_clients=3)
    jstate, jm = j_build_step(jl, jstrat, jfl, num_clients=3)(
        jstrat.init({"x": jnp.asarray(X0)}), j_as_device(jpipe.round_batch(0)))
    np.testing.assert_allclose(state.params["x"].numpy(), np.asarray(jstate.params["x"]),
                               rtol=0, atol=1e-6)
    for k, tree in jstate.opt.items():
        np.testing.assert_allclose(state.opt[k]["x"].numpy(), np.asarray(tree["x"]), rtol=0,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(mets["local_loss"]), float(jm["local_loss"]), rtol=1e-6)


def test_port_imports_neither_jax_nor_repro():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    chip_smoke = PORT_SRC.parents[1] / "chip_smoke.py"
    files = sorted(PORT_SRC.rglob("*.py")) + [chip_smoke]
    assert len(files) > 20 and chip_smoke.exists()
    for part in ("fed/comm/codecs.py", "kernels/quantize/ops.py", "kernels/quantize/ref.py",
                 "kernels/flash_attention/ops.py", "kernels/ssd/ops.py", "launch/serve.py",
                 "models/mamba2.py", "configs/registry.py", "utils/checkpoint.py",
                 "fed/cohort/prefetch.py", "configs/llava_next_mistral_7b.py",
                 "data/tasks.py", "launch/train.py", "fed/fleet/clock.py",
                 "fed/robust/aggregators.py", "fed/privacy/__init__.py",
                 "fed/privacy/accountant.py", "fed/privacy/dp.py", "fed/privacy/secagg.py",
                 "obs/__init__.py", "obs/hist.py", "obs/metrics.py", "obs/trace.py",
                 "dist/__init__.py", "dist/sharding.py", "dist/tensor.py", "launch/mesh.py"):
        assert PORT_SRC / part in files, part
    for f in files:
        assert not bad.search(f.read_text()), f
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert not any(n == 'jax' or n.startswith(('jax.', 'repro.')) or n == 'repro'\n"
            "               for n in sys.modules), sorted(sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PORT_SRC.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fl = FLConfig(**_quad_kw("fedshuffle", "sgd", engine="cohort", prefetch=0))
    pop = Population.build(fl, sizes=TASK.sizes())
    pipe = FederatedPipeline(TASK, pop, fl)
    for call in (lambda: build_round_step(LOSS, None, fl),
                 lambda: CohortEngine.build(TASK, pop, fl),
                 lambda: train(LOSS, {"x": torch.zeros(3)}, pipe, fl, 1),
                 lambda: launch_train.run_charlm_e2e(1),
                 lambda: launch_train.run_smoke("vision-tiny", 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for the CPU, the same calls run
    build_round_step(LOSS, None, fl, device="cpu")
    CohortEngine.build(TASK, pop, fl, device="cpu")


def test_round_step_moves_host_batches_and_checks_the_plane_device():
    fl = FLConfig(**_quad_kw("fedshuffle", "sgd", engine="cohort", prefetch=0))
    pop = Population.build(fl, sizes=TASK.sizes())
    eng = CohortEngine.build(TASK, pop, fl, rr_backend="device", device="cpu")
    step = build_round_step(LOSS, None, fl, plane=eng.plane, device="cpu")
    strat = bind_strategy(None, fl, LOSS, num_clients=3)
    host_plan = eng.index_plan(0)
    assert host_plan.idx is None and isinstance(host_plan.sizes, np.ndarray)
    a, _ = step(strat.init({"x": torch.zeros(3)}), host_plan)
    b, _ = step(strat.init({"x": torch.zeros(3)}), eng.device_plan(0))
    assert torch.equal(a.params["x"], b.params["x"])
    rb = as_device_batch(FederatedPipeline(TASK, pop, fl).round_batch(0), "cpu")
    assert rb.meta.client_id.dtype == torch.int64 and rb.step_mask.dtype == torch.float32
    with pytest.raises(ValueError, match="plane"):
        build_round_step(LOSS, None, fl, plane=eng.plane, device="meta")


def test_charlm_e2e_launcher_runs_on_cpu(monkeypatch):
    """The e2e launcher's wiring at a tiny width (same driver code path)."""
    tiny = dataclasses.replace(_port_charlm_cfg(), vocab=512, n_layers=1, d_model=32,
                               d_ff=64, n_heads=2, n_kv_heads=2)
    monkeypatch.setattr(launch_train, "CHARLM_100M", tiny)
    res = launch_train.run_charlm_e2e(2, device="cpu", engine="cohort", rr_backend="device",
                                      prefetch=0, num_clients=6, cohort_size=2)
    rows = res.metrics.rows
    assert [r["round"] for r in rows] == [0, 1] and "eval_loss" in rows[-1]
    assert all(np.isfinite(r["local_loss"]) for r in rows)
