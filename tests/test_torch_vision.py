"""The PyTorch port's vlm family and the paper's vision task against the JAX
package's, on the CPU with TF32 off.

* the tasks: ``VisionTask``, ``TokenTask`` (with ``patches`` and ``frames``
  extras) and ``PopulationQuadraticTask`` batches bitwise equal to JAX's,
  the quadratic's ``bank`` / ``bank_rows`` too (numpy and torch), and the
  cohort plane's procedural bank giving the legacy pipeline's round bitwise;
* ``FederatedPipeline.eval_batch``: the twins of
  ``tests/test_cohort_engine.py:220-240`` (the explicit held-out split, a
  finite task), the ``HELDOUT_BASE`` fallback, and JAX's batch bitwise;
* the registry: ``vision-tiny`` and ``llava-next-mistral-7b`` equal to
  JAX's configs field for field (every JAX field the port leaves out is at
  its default);
* vision-tiny at full width (2 x 128, 64 patches): ``Model.loss`` against
  JAX's at rtol 1e-5 / atol 1e-6, and each gradient leaf within atol 1e-6 +
  rtol 1e-5 of its largest magnitude (the embedding's rows sum many
  positions, so an element near zero carries its row's rounding); a vlm
  batch without patches raises;
* three rounds of ``fedshuffle``, ``gen`` (FedShuffleGen), ``fednova`` and
  ``fedavg_min`` on the paper's vision configuration (8 clients, cohort 4,
  6 samples each, E_i ~ U{2..5}) at ``local_lr=0.01``, both cohort modes of
  the port against JAX's vmapped round step: each leaf within atol 1e-6 +
  rtol 1e-4 of its largest magnitude, as ``tests/test_torch_vmapped.py``
  holds CharLM-tiny.  At the benchmark's 0.1, FedNova's and FedAvgMin's
  unscaled steps (12 to 15 of 0.1 a round) make the run chaotic: the fp32
  rounding grows ~10x a round (1.4e-4, 2.0e-3, 3.6e-2 of a leaf's largest
  magnitude in rounds 0-2), and the port's two modes drift as far from each
  other as from JAX, so no elementwise bound holds there;
* serving: ``llava-next-mistral-7b.reduced(n_kv_heads=2)`` (16 patches,
  groups of 2 heads) in fp32, the
  prefill over random patches (logits and caches) and 8 greedy decode
  steps against JAX's ``prefill`` / ``decode_step`` at 2e-4 + 2e-3 |ref|,
  equal tokens; a JAX-saved reduced-LLaVA params file served by the
  port's CLI gives JAX's tokens (16 zero patches before the prompt), and
  ``patch_proj`` crosses ``params_to_jax`` and a params file the port
  saved into JAX's ``load_checkpoint`` bitwise;
* the train CLI's ``--smoke`` (2 rounds, ``--device cpu``) for
  ``qwen1.5-0.5b``, ``vision-tiny``, ``mamba2-1.3b`` (ssm),
  ``hymba-1.5b`` (hybrid) and ``seamless-m4t-medium`` (audio) from JAX's
  initial params: each round's ``local_loss`` against JAX's ``run_smoke``
  at rtol 1e-4; the moe family's two archs take a round in each cohort
  mode (their JAX twins are in ``tests/test_torch_moe.py``).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.train as j_launch_train  # noqa: E402
from repro.configs.base import ArchConfig as JArch  # noqa: E402
from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.registry import ARCHS as J_ARCHS  # noqa: E402
from repro.data.federated import FederatedPipeline as JPipe  # noqa: E402
from repro.data.federated import Population as JPop  # noqa: E402
from repro.data.tasks import CharLMTask as JCharLM  # noqa: E402
from repro.data.tasks import PopulationQuadraticTask as JPopQuad  # noqa: E402
from repro.data.tasks import QuadraticTask as JQuad  # noqa: E402
from repro.data.tasks import TokenTask as JToken  # noqa: E402
from repro.data.tasks import VisionTask as JVision  # noqa: E402
from repro.fed.losses import make_loss as j_make_loss  # noqa: E402
from repro.fed.rounds import as_device_batch as j_as_device  # noqa: E402
from repro.fed.rounds import build_round_step as j_build_step  # noqa: E402
from repro.fed.strategy import bind_strategy as j_bind  # noqa: E402
from repro.launch.serve import generate as j_generate  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.utils import checkpoint as j_ckpt  # noqa: E402
from repro.utils.pytree import tree_paths as j_tree_paths  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.federated import FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import (HELDOUT_BASE, CharLMTask, PopulationQuadraticTask,  # noqa: E402
                                    QuadraticTask, TokenTask, VisionTask)
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.losses import make_loss, make_quadratic_loss  # noqa: E402
from repro_torch.fed.rounds import build_round_step  # noqa: E402
from repro_torch.fed.strategy import bind_strategy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.weights import cache_from_jax, params_from_jax, params_to_jax  # noqa: E402

SERVE_TOL = dict(atol=2e-4, rtol=2e-3)
# the paper's vision configuration (benchmarks/bench_vision.py)
VISION_FL = dict(num_clients=8, cohort_size=4, sampling="uniform", epochs=2, epochs_max=5,
                 local_batch=2, local_lr=0.1, server_opt="sgd", imbalance="equal",
                 mean_samples=6, seed=31)


def port_cfg(jcfg) -> ArchConfig:
    """The port's ArchConfig from the JAX one's fields (one keyword dict)."""
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})


def _np_params(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread_no_tf32():
    """Parity with JAX: fp32 matrix products without TF32.  One intra-op
    thread: the suite runs a test process on each of several cores at once,
    and torch's default (a thread a core in every process) oversubscribes
    them many times over."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    yield
    torch.backends.cuda.matmul.allow_tf32 = before[0]
    torch.set_num_threads(before[1])


@pytest.fixture(scope="module")
def vision_jparams():
    """vision-tiny's JAX params at full width, from PRNGKey(0)."""
    return j_build_model(J_ARCHS["vision-tiny"]).init(jax.random.PRNGKey(0))


def _leafwise_close(got: dict, want: dict, what: str, rtol: float = 1e-4):
    """Each leaf within atol 1e-6 + rtol of that leaf's largest magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        assert np.abs(g - w).max() <= 1e-6 + rtol * np.abs(w).max(), f"{what}: {k}"


def _batches_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


def test_vision_task_batches_equal_jax():
    kw = dict(num_classes=100, num_patches=64, d_model=128, num_clients=8, alpha=0.5)
    port, jt = VisionTask(**kw), JVision(**kw)
    np.testing.assert_array_equal(port.protos, jt.protos)
    np.testing.assert_array_equal(port.client_label_p, jt.client_label_p)
    idx = np.array([[0, 5], [3, 1], [HELDOUT_BASE + 2, 4]])
    for c in (0, 7):
        _batches_equal(port.batch(c, idx), jt.batch(c, idx))
    assert port.spec() == jt.spec()
    np.testing.assert_array_equal(port.heldout_ids(3, 4), jt.heldout_ids(3, 4))


@pytest.mark.parametrize("extras", [{}, {"patches": (16, 32)}, {"frames": (8, 24)}])
def test_token_task_batches_equal_jax(extras):
    kw = dict(vocab=100, seq_len=12, num_clients=6, seed=4, extras=extras)
    port, jt = TokenTask(**kw), JToken(**kw)
    idx = np.arange(6).reshape(3, 2)
    for c in (0, 5):
        _batches_equal(port.batch(c, idx), jt.batch(c, idx))
    assert port.spec() == jt.spec()


def test_population_quadratic_task_equals_jax_and_feeds_the_cohort_plane():
    kw = dict(dim=16, num_clients=50, samples_per_client=5)
    port, jt = PopulationQuadraticTask(**kw), JPopQuad(**kw)
    idx = np.arange(12).reshape(2, 3, 2)
    for c in (0, 17, 49):
        _batches_equal(port.batch(c, idx[0]), jt.batch(c, idx[0]))
    _batches_equal(port.bank(), jt.bank())
    np.testing.assert_array_equal(port.sizes(), jt.sizes())
    cids = np.array([3, 41])
    want = jt.bank_rows(cids, idx)
    np.testing.assert_array_equal(port.bank_rows(cids, idx), want)
    np.testing.assert_array_equal(
        port.bank_rows(torch.from_numpy(cids), torch.from_numpy(idx)).numpy(), want)
    # the cohort plane gathers through bank()/bank_rows(): one round equals
    # the legacy pipeline's, bitwise, with the host RR streams
    fl = FLConfig(num_clients=50, cohort_size=4, local_batch=2, imbalance="equal",
                  mean_samples=5, engine="cohort", rr_backend="host", prefetch=0,
                  cohort_mode="sequential")
    pop = Population.build(fl, sizes=port.sizes())
    eng = CohortEngine.build(port, pop, fl, device="cpu")
    loss = make_quadratic_loss(16)
    x0 = {"x": torch.from_numpy(np.linspace(-1, 1, 16).astype(np.float32))}
    strat = bind_strategy(None, fl, loss, num_clients=50)
    a, _ = build_round_step(loss, strat, fl, plane=eng.plane, device="cpu")(
        strat.init(x0), eng.device_plan(0))
    b, _ = build_round_step(loss, strat, fl, device="cpu")(
        strat.init(x0), FederatedPipeline(port, pop, fl).round_batch(0))
    assert torch.equal(a.params["x"], b.params["x"])


# ---------------------------------------------------------------------------
# eval_batch (twins of tests/test_cohort_engine.py:220-240)
# ---------------------------------------------------------------------------


def test_eval_batch_uses_explicit_heldout_split():
    task = CharLMTask(vocab=32, seq_len=8, num_clients=3)
    fl = FLConfig(num_clients=3, cohort_size=2, mean_samples=4, seed=2)
    pipe = FederatedPipeline(task, Population.build(fl), fl)
    ev = pipe.eval_batch(per_client=2)
    assert ev["tokens"].shape == (6, 9)
    ids = task.heldout_ids(0, 2)
    assert ids.min() >= HELDOUT_BASE
    assert int(pipe.population.sizes.max()) < HELDOUT_BASE
    jfl = JFL(num_clients=3, cohort_size=2, mean_samples=4, seed=2)
    want = JPipe(JCharLM(vocab=32, seq_len=8, num_clients=3), JPop.build(jfl), jfl).eval_batch(
        per_client=2)
    _batches_equal(ev, want)


def test_eval_batch_works_for_finite_tasks():
    task = QuadraticTask(dim=6, assignment=((0,), (1, 2), (3, 4, 5)))
    fl = FLConfig(num_clients=3, cohort_size=2, seed=2)
    pipe = FederatedPipeline(task, Population.build(fl, sizes=task.sizes()), fl)
    ev = pipe.eval_batch(per_client=2)
    assert ev["e"].shape == (6, 6)
    jtask = JQuad(dim=6, assignment=((0,), (1, 2), (3, 4, 5)))
    jfl = JFL(num_clients=3, cohort_size=2, seed=2)
    _batches_equal(ev, JPipe(jtask, JPop.build(jfl, sizes=jtask.sizes()), jfl).eval_batch(
        per_client=2))


def test_eval_batch_falls_back_to_heldout_base():
    class NoSplit:
        """A procedural task without ``heldout_ids``: it records the ids."""

        def __init__(self):
            self.seen = []

        def batch(self, client, idx):
            self.seen.append(idx.copy())
            return {"id": (idx + 1000 * client).astype(np.int64)}

    task = NoSplit()
    fl = FLConfig(num_clients=3, cohort_size=2, seed=2)
    ev = FederatedPipeline(task, Population.build(fl), fl).eval_batch(per_client=3)
    want = np.concatenate([HELDOUT_BASE + np.arange(3) + 1000 * c for c in range(3)])
    np.testing.assert_array_equal(ev["id"], want)
    assert all(s.shape == (1, 3) for s in task.seen)


def test_vision_eval_batch_equals_jax():
    kw = dict(num_classes=100, num_patches=64, d_model=128, num_clients=8, alpha=0.5)
    fl, jfl = FLConfig(**VISION_FL), JFL(**VISION_FL)
    ev = FederatedPipeline(VisionTask(**kw), Population.build(fl), fl).eval_batch(per_client=2)
    assert ev["patches"].shape == (16, 64, 128) and ev["tokens"].shape == (16, 2)
    _batches_equal(ev, JPipe(JVision(**kw), JPop.build(jfl), jfl).eval_batch(per_client=2))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["vision-tiny", "llava-next-mistral-7b"])
def test_vlm_archs_resolve_equal_to_jax(arch):
    cfg, jcfg = get_arch(arch), J_ARCHS[arch]
    assert cfg.family == "vlm" and cfg == port_cfg(jcfg)
    ours = {f.name for f in dataclasses.fields(ArchConfig)}
    defaults = JArch()
    for f in dataclasses.fields(JArch):
        if f.name not in ours:
            assert getattr(jcfg, f.name) == getattr(defaults, f.name), f.name
    assert cfg.reduced() == port_cfg(jcfg.reduced())
    assert cfg.reduced().num_patches == 16


# ---------------------------------------------------------------------------
# vision-tiny's train loss at full width
# ---------------------------------------------------------------------------


def test_vision_tiny_loss_and_grads_match_jax(vision_jparams):
    cfg, jparams = get_arch("vision-tiny"), vision_jparams
    jmodel = j_build_model(J_ARCHS["vision-tiny"])
    task = JVision(num_classes=100, num_patches=64, d_model=128, num_clients=4)
    mb = task.batch(2, np.arange(3).reshape(1, 3))
    mb = {k: v[0] for k, v in mb.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in mb.items()})
    params = {k: v.requires_grad_() for k, v in _np_params(jparams, cfg).items()}
    assert params.keys() == build_model(cfg).init(0, "meta").keys()
    assert params["patch_proj"].shape == (128, 128)
    loss, mets = build_model(cfg).loss(params, {k: torch.from_numpy(v) for k, v in mb.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, atol=1e-6)
    assert float(mets["ce"].detach()) == float(loss.detach())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _leafwise_close(grads, _np_params(jg, cfg), "gradient", rtol=1e-5)
    assert float(grads["patch_proj"].abs().max()) > 0
    with pytest.raises(ValueError, match="patches"):
        build_model(cfg).loss(params, {"tokens": torch.from_numpy(mb["tokens"])})


# ---------------------------------------------------------------------------
# rounds on the paper's vision configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["fedshuffle", "gen", "fednova", "fedavg_min"])
def test_vision_rounds_match_jax(algorithm, vision_jparams):
    rounds = 3
    kw = VISION_FL | dict(algorithm=algorithm, local_lr=0.01)
    tkw = dict(num_classes=100, num_patches=64, d_model=128, num_clients=8, alpha=0.5)
    jcfg, cfg = J_ARCHS["vision-tiny"], get_arch("vision-tiny")
    jfl = JFL(**kw)
    jpipe = JPipe(JVision(**tkw), JPop.build(jfl), jfl)
    jloss = j_make_loss(j_build_model(jcfg))
    jparams = vision_jparams
    jstrat = j_bind(None, jfl, jloss, num_clients=8)
    jstep = jax.jit(j_build_step(jloss, jstrat, jfl, num_clients=8))
    jstate = jstrat.init(jparams)
    ks = set()
    for r in range(rounds):
        rb = jpipe.round_batch(r)
        ks.update(int(k) for k in np.asarray(rb.meta.num_steps)[np.asarray(rb.meta.valid) > 0])
        jstate, jm = jstep(jstate, j_as_device(rb))
    assert jpipe.k_max == 15 and (len(ks) > 1 or algorithm == "fedavg_min"), ks
    want = _np_params(jstate.params, cfg)
    loss_fn = make_loss(build_model(cfg))
    for mode in ("vmapped", "sequential"):
        fl = FLConfig(**kw, cohort_mode=mode)
        pipe = FederatedPipeline(VisionTask(**tkw), Population.build(fl), fl)
        strat = bind_strategy(None, fl, loss_fn, num_clients=8)
        step = build_round_step(loss_fn, strat, fl, device="cpu")
        state = strat.init(_np_params(jparams, cfg))
        for r in range(rounds):
            state, mets = step(state, pipe.round_batch(r))
        _leafwise_close(state.params, want, f"{algorithm} {mode}")
        np.testing.assert_allclose(float(mets["local_loss"]), float(jm["local_loss"]), rtol=1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_vlm_prefill_and_greedy_decode_match_jax():
    steps, T, B = 8, 24, 2
    jcfg = J_ARCHS["llava-next-mistral-7b"].reduced(n_kv_heads=2)
    cfg = get_arch("llava-next-mistral-7b").reduced(n_kv_heads=2)
    assert cfg == port_cfg(jcfg) and cfg.num_patches == 16
    jmodel, model = j_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = _np_params(jparams, cfg)
    r = np.random.default_rng(1)
    toks = r.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    patches = r.normal(size=(B, 16, cfg.d_model)).astype(np.float32)
    cache_len = 16 + T + steps + 1
    jl, jc = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len))(
        jparams, {"tokens": toks, "patches": patches})
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                           "patches": torch.from_numpy(patches)}, cache_len)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **SERVE_TOL)
    want = cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert cache["pos"] == want["pos"] == 16 + T
    for k, v in want["layers"].items():
        assert cache["layers"][k].shape == v.shape, k
        np.testing.assert_allclose(cache["layers"][k].numpy(), v.numpy(), **SERVE_TOL)
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        jtok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok), err_msg=f"step {i}")
        jl, jc = jdecode(jparams, jtok, jc)
        with torch.inference_mode():
            lg, cache = model.decode_step(params, tok, cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **SERVE_TOL)
    assert cache["pos"] == int(jc["pos"]) == 16 + T + steps
    with pytest.raises(ValueError, match="patches"):
        model.prefill(params, {"tokens": torch.from_numpy(toks)}, cache_len)


def test_jax_saved_llava_checkpoint_served_by_port_cli(tmp_path, capsys):
    """A reduced-LLaVA params file that JAX saved: the port's ``serve
    --checkpoint`` (16 zero patches, then the prompt) gives JAX's greedy
    tokens on the same prompts, its cache sized by JAX's CLI formula."""
    jcfg = J_ARCHS["llava-next-mistral-7b"].reduced()
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    path = os.path.join(tmp_path, "llava.npz")
    j_ckpt.save_checkpoint(path, jparams, {"round": 0})
    batch, plen, steps = 2, 16, 6
    got = serve.main(["--arch", "llava-next-mistral-7b", "--device", "cpu", "--checkpoint", path,
                      "--batch", str(batch), "--prompt-len", str(plen), "--tokens", str(steps)])
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab, (batch, plen)).astype(np.int32)
    want = j_generate(jmodel, jparams, jnp.asarray(prompts), steps=steps,
                      cache_len=jcfg.num_patches + plen + steps + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert "seq1:" in capsys.readouterr().out


def test_patch_proj_crosses_both_ways_and_through_files(tmp_path):
    """``patch_proj`` through ``params_from_jax`` / ``params_to_jax`` and a
    params file the port saved, read by JAX's ``load_checkpoint``."""
    jcfg = J_ARCHS["llava-next-mistral-7b"].reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(3))
    params = _np_params(jparams, port_cfg(jcfg))
    assert params["patch_proj"].shape == (jcfg.d_model, jcfg.d_model)
    path = os.path.join(tmp_path, "llava.npz")
    save_checkpoint(path, params, {"round": 0})
    restored = j_ckpt.load_checkpoint(path, jax.tree.map(jnp.zeros_like, jparams))
    for tree in (params_to_jax(params), restored):
        got = dict(j_tree_paths(tree))
        want = dict(j_tree_paths(jparams))
        assert got.keys() == want.keys() and any("patch_proj" in k for k in want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


# ---------------------------------------------------------------------------
# the train CLI's --arch / --smoke
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "vision-tiny", "mamba2-1.3b", "hymba-1.5b",
                                  "seamless-m4t-medium"])
def test_smoke_cli_matches_jax_run_smoke(arch, monkeypatch):
    rounds = 2
    runs, inits = {}, {}

    def capture(key, fn):
        def run(*a, **k):
            inits[key] = a[1]
            runs[key] = fn(*a, **k)
            return runs[key]
        return run

    monkeypatch.setattr(j_launch_train, "train", capture("jax", j_launch_train.train))
    j_launch_train.run_smoke(arch, rounds, "fedshuffle", "sgd")
    jparams = inits["jax"]         # JAX's run_smoke initial params, PRNGKey(0)
    cfg = get_arch(arch).reduced()
    monkeypatch.setattr(Model, "init", lambda self, seed, device: _np_params(jparams, cfg))
    monkeypatch.setattr(launch_train, "train", capture("port", launch_train.train))
    monkeypatch.setattr("sys.argv", ["train", "--arch", arch, "--smoke", "--rounds", str(rounds),
                                     "--device", "cpu"])
    launch_train.main()
    got, want = runs["port"].metrics.rows, runs["jax"].metrics.rows
    assert len(got) == len(want) == rounds
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["local_loss"], w["local_loss"], rtol=1e-4)
    _leafwise_close(runs["port"].state.params, _np_params(runs["jax"].state.params, cfg),
                    f"{arch} smoke")


def test_smoke_refuses_untrained_families():
    """No family is left untrained: both DeepSeek archs' smoke runs (the moe
    family) take a round on the CPU in each cohort mode with finite
    losses, the two modes' losses within rtol 1e-5, and V3's loss has its
    MTP term (``mtp_ce``).  A dense config cannot take the moe family
    without its MoE and MLA configs, nor MTP."""
    for arch in ("deepseek-v2-lite-16b", "deepseek-v3-671b"):
        rows = {mode: launch_train.run_smoke(arch, 1, device="cpu", cohort_mode=mode).metrics.rows
                for mode in ("vmapped", "sequential")}
        losses = [r[0]["local_loss"] for r in rows.values()]
        assert all(np.isfinite(losses)), arch
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
        cfg = get_arch(arch).reduced()
        model = build_model(cfg)
        toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 33)))
        loss, metrics = model.loss(model.init(0, "cpu"), {"tokens": toks})
        assert torch.isfinite(loss) and ("mtp_ce" in metrics) == (arch == "deepseek-v3-671b")
    dense = get_arch("qwen1.5-0.5b").reduced()
    for bad in (dict(family="moe"), dict(mtp=True)):
        with pytest.raises(NotImplementedError, match="moe family"):
            build_model(dataclasses.replace(dense, **bad))
