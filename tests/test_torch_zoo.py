"""The rest of the PyTorch port's model zoo against the JAX package, on the
CPU in fp32: the ssm family (``mamba2-1.3b``), the dense archs
``minicpm-2b``, ``chatglm3-6b`` (the "half" RoPE) and ``qwen2-72b``, and the
train losses of the ssm, hybrid (``hymba-1.5b``) and audio
(``seamless-m4t-medium``) families, each at ``.reduced()`` (Hymba's window
cut to 8, so that the sequences pass it).

* ``Model.loss`` and its gradients against ``jax.value_and_grad`` of JAX's
  (64 tokens: two SSD chunks of 32; the audio family over 32 frames): the
  loss at rtol 1e-5 / atol 1e-6, every gradient leaf within 1e-6 + 1e-5 of
  its largest magnitude, as ``tests/test_torch_model.py`` holds the dense
  loss;
* one FedShuffle round (``tests/test_models.py::test_one_federated_round``'s
  configuration) in both of the port's cohort modes against JAX's round:
  each leaf within 1e-6 + 1e-4 of its largest magnitude, ``local_loss`` at
  rtol 1e-4;
* prefill -> decode against the full prefill (atol 2e-4, rtol 2e-3), the
  twin of ``test_prefill_decode_consistency``, here past a chunk (40 + 3
  tokens, a ragged last chunk) and past Hymba's window;
* the full-width leaves of the four new archs: ``Model.init(0, "meta")``
  against ``jax.eval_shape`` of JAX's init, names, shapes and dtypes;
* a dense config with a sliding window served into a window-sized ring
  cache and into a linear one, each equal to JAX's decode (whose
  ``gqa_decode`` never reads ``window``: the ring's size is the window);
* the plain SSD scan under autograd: gradients against JAX's
  ``ssd_chunked`` at normal decay, and finite and equal to the sequential
  ``ssd_ref``'s at strong decay (where JAX's mask-after form gives NaN);
  the new losses under ``torch.func.vmap`` equal to a client at a time;
  Hymba's bucketed smoke run bitwise equal to its padded twin; the ssm
  family's params through ``params_to_jax`` and back bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.registry import ARCHS as J_ARCHS  # noqa: E402
from repro.data.federated import FederatedPipeline as JPipe  # noqa: E402
from repro.data.federated import Population as JPop  # noqa: E402
from repro.data.tasks import TokenTask as JToken  # noqa: E402
from repro.fed.losses import make_loss as j_make_loss  # noqa: E402
from repro.fed.rounds import as_device_batch as j_as_device  # noqa: E402
from repro.fed.rounds import build_round_step as j_build_step  # noqa: E402
from repro.fed.server import init_server as j_init_server  # noqa: E402
from repro.models.mamba2 import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig, SSMConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.local import cohort_loss, value_and_grad  # noqa: E402
from repro_torch.data.federated import FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import TokenTask  # noqa: E402
from repro_torch.fed.losses import make_loss  # noqa: E402
from repro_torch.fed.rounds import build_round_step  # noqa: E402
from repro_torch.fed.strategy import bind_strategy  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.weights import cache_from_jax, params_from_jax, params_to_jax  # noqa: E402

ZOO = ["mamba2-1.3b", "minicpm-2b", "chatglm3-6b", "qwen2-72b", "hymba-1.5b",
       "seamless-m4t-medium"]
NEW_ARCHS = ZOO[:4]
TRAINED = ["mamba2-1.3b", "hymba-1.5b", "seamless-m4t-medium"]   # the families new to the loss
KW = {"hymba-1.5b": dict(sliding_window=8)}
KEY = jax.random.PRNGKey(0)
SEQ, BATCH = 64, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> ArchConfig:
    """The port's ArchConfig from the JAX one's fields (one keyword dict)."""
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    d = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields}
    if d.get("ssm") is not None:
        d["ssm"] = SSMConfig(**d["ssm"])
    return ArchConfig(**d)


def _setup(arch):
    jcfg = J_ARCHS[arch].reduced(**KW.get(arch, {}))
    jmodel = j_build(jcfg)
    jparams = jmodel.init(KEY)
    cfg = port_cfg(jcfg)
    assert cfg == get_arch(arch).reduced(**KW.get(arch, {}))
    return jmodel, jparams, cfg, build_model(cfg), _np_params(jparams, cfg)


def _np_params(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _batch(cfg, T: int, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (BATCH, T)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.normal(size=(BATCH, cfg.src_frames, cfg.d_model)).astype(np.float32)
    return b


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leafwise_close(got: dict, want: dict, what: str, rtol: float):
    """Each leaf within atol 1e-6 + rtol of that leaf's largest magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].detach().numpy(), want[k].numpy()
        assert np.abs(g - w).max() <= 1e-6 + rtol * np.abs(w).max(), f"{what}: {k}"


@pytest.mark.parametrize("arch", ZOO)
def test_loss_and_grads_match_jax(arch):
    jmodel, jparams, cfg, model, params = _setup(arch)
    batch = _batch(cfg, SEQ + 1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, batch)
    loss, grads = value_and_grad(model.loss, params, _torch(batch))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    _, metrics = model.loss(params, _torch(batch))
    assert metrics.keys() == jm.keys() == {"ce", "aux"} and float(metrics["aux"]) == 0.0
    _leafwise_close(grads, _np_params(jg, cfg), f"{arch} grads", rtol=1e-5)


ROUND_FL = dict(num_clients=4, cohort_size=2, sampling="uniform", epochs=1, local_batch=2,
                algorithm="fedshuffle", local_lr=0.05, mean_samples=4, seed=0)


def _extras(cfg) -> dict:
    return {"frames": (cfg.src_frames, cfg.d_model)} if cfg.family == "audio" else {}


@pytest.mark.parametrize("arch", ZOO)
def test_one_round_matches_jax(arch):
    """``test_one_federated_round``'s configuration (4 clients, 2 a round,
    16-token samples), JAX's legacy entry points against the port's round
    step in both cohort modes."""
    jmodel, jparams, cfg, model, params = _setup(arch)
    jfl = JFL(**ROUND_FL)
    jpipe = JPipe(JToken(vocab=cfg.vocab, seq_len=16, num_clients=4, extras=_extras(cfg)),
                  JPop.build(jfl), jfl)
    jstep = jax.jit(j_build_step(j_make_loss(jmodel), jfl, num_clients=4))
    jstate, jm = jstep(j_init_server(jfl, jparams), j_as_device(jpipe.round_batch(0)))
    want = _np_params(jstate.params, cfg)
    loss_fn = make_loss(model)
    for mode in ("vmapped", "sequential"):
        fl = FLConfig(**ROUND_FL, cohort_mode=mode)
        pipe = FederatedPipeline(TokenTask(vocab=cfg.vocab, seq_len=16, num_clients=4,
                                           extras=_extras(cfg)), Population.build(fl), fl)
        strat = bind_strategy(None, fl, loss_fn, num_clients=4)
        state, mets = build_round_step(loss_fn, strat, fl, device="cpu")(
            strat.init(dict(params)), pipe.round_batch(0))
        _leafwise_close(state.params, want, f"{arch} {mode}", rtol=1e-4)
        np.testing.assert_allclose(float(mets["local_loss"]), float(jm["local_loss"]), rtol=1e-4)
        assert float(mets["delta_norm"]) > 0


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_decode_matches_full_prefill(arch):
    cfg = get_arch(arch).reduced(**KW.get(arch, {}))
    model = build_model(cfg)
    params = model.init(0, "cpu")
    T, extra = 40, 3
    batch = _torch(_batch(cfg, T + extra, seed=2))
    toks = batch["tokens"]
    cache_len = T + extra + 2
    with torch.inference_mode():
        lg, cache = model.prefill(params, batch | {"tokens": toks[:, :T]}, cache_len)
        for i in range(extra):
            lg, cache = model.decode_step(params, toks[:, T + i:T + i + 1], cache)
        full, _ = model.prefill(params, batch, cache_len)
    assert cache["pos"] == T + extra
    np.testing.assert_allclose(lg.numpy(), full.numpy(), atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_width_leaves_match_jax(arch):
    """Names, shapes and dtypes of every leaf at full width (no weights
    made: ``meta`` in the port, ``eval_shape`` in JAX), JAX's stacked
    ``blocks`` leaves unstacked a layer at a time."""
    cfg = get_arch(arch)
    shapes = jax.eval_shape(j_build(J_ARCHS[arch]).init, KEY)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = "/".join(p.key for p in path)
        if path[0].key == "blocks":
            assert leaf.shape[0] == cfg.n_layers, name
            rest = name.partition("/")[2]
            want.update({f"blocks/{i}/{rest}": (tuple(leaf.shape[1:]), str(leaf.dtype))
                         for i in range(cfg.n_layers)})
        else:
            want[name] = (tuple(leaf.shape), str(leaf.dtype))
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in build_model(cfg).init(0, "meta").items()}
    assert got == want


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "linear"])
def test_windowed_dense_decode_matches_jax(ring):
    """A dense config with a sliding window (Qwen-tiny, window 8): the
    prefill windowed, then decode steps past it into a window-sized ring
    cache (``ring=True``: the ring's size is the window) or into a linear
    cache (which the decode step reads whole, as JAX's does), each equal to
    JAX's logits and cache."""
    jcfg = J_ARCHS["qwen1.5-0.5b"].reduced(sliding_window=8)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(KEY)
    cfg = port_cfg(jcfg)
    model = build_model(cfg)
    params = _np_params(jparams, cfg)
    T, extra = 24, 3
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (BATCH, T + extra)).astype(np.int32)
    cache_len = cfg.sliding_window if ring else T + extra + 1
    jl, jc = jmodel.prefill(jparams, {"tokens": toks[:, :T]}, cache_len)
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :T])}, cache_len)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-4)
    for i in range(extra):
        tok = toks[:, T + i:T + i + 1]
        jl, jc = jmodel.decode_step(jparams, tok, jc, ring=ring)
        with torch.inference_mode():
            lg, cache = model.decode_step(params, torch.from_numpy(tok), cache, ring=ring)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-4)
    assert cache["layers"]["k"].shape[2] == cache_len
    for k, v in cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")["layers"].items():
        np.testing.assert_allclose(cache["layers"][k].numpy(), v.numpy(), atol=2e-5, rtol=2e-4)


def _scan_inputs(decay=None, T=128, H=4, P=8, N=16, seed=0):
    rng = np.random.default_rng(seed)
    xdt = rng.normal(size=(BATCH, T, H, P)).astype(np.float32) * 0.5
    a = (-np.log1p(np.exp(rng.normal(size=(BATCH, T, H)))) if decay is None
         else np.full((BATCH, T, H), decay)).astype(np.float32)
    bm = rng.normal(size=(BATCH, T, N)).astype(np.float32) * 0.5
    cm = rng.normal(size=(BATCH, T, N)).astype(np.float32) * 0.5
    w = rng.normal(size=(BATCH, T, H, P)).astype(np.float32)
    return xdt, a, bm, cm, w


def _scan_grads(fn, xdt, a, bm, cm, w):
    """d sum(w * y) / d (xdt, a, B, C) of ``fn(xdt, a, B, C) -> (y, S)``."""
    ins = [torch.from_numpy(x).requires_grad_() for x in (xdt, a, bm, cm)]
    y, s = fn(*ins)
    (torch.sum(torch.from_numpy(w) * y) + s.sum()).backward()
    return [x.grad.numpy() for x in ins]


def test_plain_scan_grads_match_jax_at_normal_decay():
    xdt, a, bm, cm, w = _scan_inputs()

    def jloss(*xs):
        y, s = j_ssd_chunked(*xs, 32)
        return jnp.sum(jnp.asarray(w) * y) + s.sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(xdt, a, bm, cm)
    got = _scan_grads(lambda *xs: ssd_scan(*xs, 32, backend="ref"), xdt, a, bm, cm, w)
    for g, jw, name in zip(got, want, ("xdt", "a", "B", "C")):
        jw = np.asarray(jw)
        assert np.abs(g - jw).max() <= 1e-6 + 1e-5 * np.abs(jw).max(), name


def test_plain_scan_grads_are_finite_at_strong_decay():
    """a = -40 a step: exp(cum_i - cum_j) overflows above the diagonal,
    which JAX's ``ssd_chunked`` masks after the exponential (inf * 0 = NaN
    in its backward).  The port masks before it: its gradients are finite
    and equal the sequential recurrence's."""
    xdt, a, bm, cm, w = _scan_inputs(decay=-40.0)
    got = _scan_grads(lambda *xs: ssd_scan(*xs, 32, backend="ref"), xdt, a, bm, cm, w)
    want = _scan_grads(ssd_ref, xdt, a, bm, cm, w)
    for g, r, name in zip(got, want, ("xdt", "a", "B", "C")):
        assert np.isfinite(g).all(), name
        assert np.abs(g - r).max() <= 1e-6 + 1e-5 * np.abs(r).max(), name


@pytest.mark.parametrize("arch", TRAINED)
def test_loss_under_vmap_matches_each_client(arch):
    """The vmapped cohort mode's form (``core/local.py:cohort_loss``): the
    loss over a stack of two clients' params and batches under
    ``torch.func.vmap``, and autograd of its sum, each client's loss and
    gradients equal to its own ``value_and_grad`` (1e-6 + 1e-5 of a
    leaf's largest magnitude)."""
    cfg = get_arch(arch).reduced(**KW.get(arch, {}))
    model = build_model(cfg)
    p0, p1 = model.init(0, "cpu"), model.init(1, "cpu")
    b0, b1 = _torch(_batch(cfg, 25, seed=3)), _torch(_batch(cfg, 25, seed=4))
    stacked = {k: torch.stack([p0[k], p1[k]]).requires_grad_() for k in p0}
    batches = {k: torch.stack([b0[k], b1[k]]) for k in b0}
    total, losses = cohort_loss(model.loss)(stacked, batches)
    grads = dict(zip(stacked, torch.autograd.grad(total, list(stacked.values()))))
    for i, (p, b) in enumerate(((p0, b0), (p1, b1))):
        loss, want = value_and_grad(model.loss, p, b)
        np.testing.assert_allclose(float(losses[i].detach()), loss.item(), rtol=1e-6)
        _leafwise_close({k: v[i] for k, v in grads.items()}, want, f"{arch} client {i}", 1e-5)


def test_hymba_bucketed_smoke_equals_padded_bitwise():
    """Hymba-tiny's smoke run (vmapped, 2 rounds) in the bucketed layout
    gives its padded twin's params bitwise, as the card's run must."""
    runs = {mode: launch_train.run_smoke("hymba-1.5b", 2, device="cpu", exec_mode=mode)
            for mode in ("padded", "bucketed")}
    got, want = runs["bucketed"].state.params, runs["padded"].state.params
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_ssm_params_cross_to_jax_and_back_bitwise():
    jmodel, jparams, cfg, model, params = _setup("mamba2-1.3b")
    assert "blocks/1/mixer/A_log" in params and "blocks/1/ln1/scale" in params
    back = params_to_jax(params)
    flat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))
