"""The PyTorch port's examples (``examples/torch_*.py``) on the CPU, each
through its ``main(device="cpu", ...)`` at fewer rounds than its default:

* each imports only ``repro_torch`` (besides the standard library, numpy
  and torch);
* ``torch_objective_inconsistency``: every arm's final x against the JAX
  example's (``examples/objective_inconsistency.py``, the same arms run
  here through the JAX package) at the same rounds, within 1e-5;
* ``torch_quickstart``: the held-out loss falls, the custom clip rule is registered
  and clips as the built-in ``local_clip`` does (its parameters within
  1e-6 of a ``local_clip`` run's at the same bound), the traced run's
  histogram and trace file;
* ``torch_dp_training``: epsilon falls as the noise multiplier grows, and
  the secure-aggregation arm equals the DP arm (epsilon exactly, the
  distance to the optimum within the fixed-point grid);
* ``torch_robust_aggregation``: the sign flip breaks the plain mean and the
  trimmed mean defends against it;
* ``torch_serve_moe``: greedy tokens equal to JAX's ``generate`` at the same
  weights (``weights.params_from_jax``) and prompts;
* ``torch_quickstart_split`` (the quickstart's training round by round):
  weights one ulp apart have parted after a round.
"""
import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.data.federated import FederatedPipeline as JPipe  # noqa: E402
from repro.data.federated import Population as JPop  # noqa: E402
from repro.data.tasks import DuplicatedQuadraticTask as JQuad  # noqa: E402
from repro.fed.losses import make_quadratic_loss as j_quad_loss  # noqa: E402
from repro.fed.rounds import as_device_batch as j_as_device_batch  # noqa: E402
from repro.fed.rounds import build_round_step as j_build_round_step  # noqa: E402
from repro.fed.strategy import bind_strategy as j_bind  # noqa: E402
from repro.fed.strategy import strategy_for as j_strategy_for  # noqa: E402
from repro.launch.serve import generate as j_generate  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch.core.local import CLIENT_TRANSFORMS  # noqa: E402
from repro_torch.fed.strategy import LOCAL_UPDATES  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NAMES = ("torch_quickstart", "torch_objective_inconsistency", "torch_dp_training",
         "torch_robust_aggregation", "torch_serve_moe", "torch_quickstart_split")
ALLOWED = {"argparse", "dataclasses", "importlib", "json", "os", "sys", "time", "numpy",
           "torch"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over.  TF32 off, as in every parity
    test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(n)


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_only_the_port(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots and roots <= ALLOWED | {"repro_torch"}, roots


def jax_objective_arms(rounds: int) -> dict:
    """The JAX example's arms (``examples/objective_inconsistency.py``) at
    ``rounds`` rounds -> {arm: final x}."""
    task, loss_fn = JQuad(copies=(1, 2, 3)), j_quad_loss(3)
    arms = {alg: dict(cohort_size=3, sampling="full", epochs=1, algorithm=alg,
                      server_opt="sgd") for alg in ("fedavg", "fednova", "fedshuffle")}
    arms.update({f"partial/{name}": dict(cohort_size=2, sampling="uniform", epochs=2,
                                         algorithm="fedavg", server_opt=opt, seed=3)
                 for name, opt in (("fedavg", "sgd"), ("fedavg+scaffold", "scaffold"))})
    out = {}
    for arm, kw in arms.items():
        fl = JFL(num_clients=3, local_batch=1, local_lr=0.05, **kw)
        pipe = JPipe(task, JPop.build(fl, sizes=task.sizes()), fl)
        strategy = j_bind(j_strategy_for(fl), fl, loss_fn, num_clients=3)
        state = strategy.init({"x": jnp.zeros(3)})
        step = jax.jit(j_build_round_step(loss_fn, strategy, fl, num_clients=3))
        for r in range(rounds):
            state, _ = step(state, j_as_device_batch(pipe.round_batch(r)))
        out[arm] = np.asarray(state.params["x"])
    return out


def test_objective_inconsistency_equals_jax():
    rounds = 60
    got = load("torch_objective_inconsistency").main("cpu", rounds=rounds)
    want = jax_objective_arms(rounds)
    assert set(got) == set(want)
    for arm in want:
        np.testing.assert_allclose(got[arm], want[arm], rtol=0, atol=1e-5, err_msg=arm)
    task = JQuad(copies=(1, 2, 3))
    # the paper's claim, already at 60 rounds: FedShuffle nearer x* than FedAvg
    assert np.linalg.norm(got["fedshuffle"] - task.optimum()) < \
        np.linalg.norm(got["fedavg"] - task.optimum())


def test_quickstart_trains_clips_and_traces(tmp_path):
    qs = load("torch_quickstart")
    trace = tmp_path / "trace.json"
    res = qs.main("cpu", rounds=2, clip_rounds=1, traced_rounds=1, trace_path=str(trace))
    assert res["heldout"][1] < res["heldout"][0]
    assert LOCAL_UPDATES["sgd_demo_clip"].transforms == ("demo_clip",)
    assert CLIENT_TRANSFORMS["demo_clip"].__name__ == "make_demo_clip"
    assert np.isfinite(res["clip_loss"]) and len(res["generated"]) == 2
    assert sum(res["hist_steps"]) == 4 and trace.stat().st_size > 0


def test_quickstart_split_sees_one_ulp():
    """The split diagnostic on the CPU: the reference arm is its own
    reference, and weights one ulp apart have parted after a round."""
    rep = load("torch_quickstart_split").main(rounds=1, cpu_only=True)
    assert rep["cpu"]["distance"] == [0.0]
    assert 0 < rep["cpu_ulp"]["distance"][0] < 1e-4
    assert np.isfinite(rep["cpu"]["heldout"][0]) and len(rep["cpu_ulp"]["local"]) == 1


def test_quickstart_clip_equals_local_clip():
    """The example's transform against the built-in rule at its bound."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.paper_tasks import CHARLM_TINY
    from repro_torch.data.federated import FederatedPipeline, Population
    from repro_torch.data.tasks import CharLMTask
    from repro_torch.fed.losses import make_loss
    from repro_torch.fed.train_loop import train
    from repro_torch.models.model import build_model

    from repro_torch.fed import ClientChain, register_client_transform, register_local_update

    register_client_transform("demo_clip", load("torch_quickstart").make_demo_clip,
                              overwrite=True)
    register_local_update("sgd_demo_clip", ClientChain("sgd_demo_clip", ("demo_clip",)),
                          overwrite=True)
    model = build_model(CHARLM_TINY)
    params = model.init(0, "cpu")
    runs = {}
    for mode in ("vmapped", "sequential"):
        for rule in ("sgd_demo_clip", "local_clip"):
            fl = FLConfig(num_clients=8, cohort_size=4, epochs=2, local_batch=2,
                          local_lr=1.0, mean_samples=6, local_update=rule, clip_norm=0.5,
                          cohort_mode=mode)
            task = CharLMTask(vocab=CHARLM_TINY.vocab, seq_len=32, num_clients=8)
            runs[mode, rule] = train(make_loss(model), params,
                                     FederatedPipeline(task, Population.build(fl), fl), fl,
                                     rounds=1, log_every=0, device="cpu").state.params
        for k, v in runs[mode, "local_clip"].items():
            torch.testing.assert_close(runs[mode, "sgd_demo_clip"][k], v, rtol=1e-6, atol=1e-6)
    assert any(not torch.equal(runs["vmapped", "local_clip"][k], params[k]) for k in params)


def test_dp_training_claims():
    res = load("torch_dp_training").main("cpu", rounds=60)
    eps = [res[f"dp z={z}"][0] for z in (0.5, 1.0, 2.0)]
    assert eps[0] > eps[1] > eps[2] > 0 and res["baseline"][0] == float("inf")
    dp, sa = res["dp z=1.0"], res["dp z=1.0 + secagg"]
    assert sa[0] == dp[0] and sa[2] == dp[2]
    assert abs(sa[1] - dp[1]) < 1e-3


def test_robust_aggregation_defends_the_sign_flip():
    losses = load("torch_robust_aggregation").main("cpu", rounds=150)   # it asserts its claim
    clean = losses["attack-free     / mean"]
    assert losses["under attack    / mean"] > 10 * clean
    assert losses["under attack    / trimmed_mean"] < 1.5 * clean


def test_serve_moe_tokens_equal_jax():
    cfg = j_get_arch("deepseek-v2-lite-16b").reduced()
    model = j_build_model(cfg)
    jparams = model.init(jax.random.PRNGKey(0))
    prompts = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, cfg.vocab)
    want = np.asarray(j_generate(model, jparams, prompts, steps=16, cache_len=48))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    got = load("torch_serve_moe").main("cpu", params=params,
                                       prompts=torch.as_tensor(np.asarray(prompts)),
                                       temperature=0.0)
    assert np.array_equal(got.numpy(), want)
    sampled = load("torch_serve_moe").main("cpu")
    assert sampled.shape == (4, 16) and int(sampled.max()) < cfg.vocab
