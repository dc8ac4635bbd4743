"""MLA and the moe family of the PyTorch port against the JAX package, on the
CPU in fp32: ``deepseek-v2-lite-16b`` (no query compression) and
``deepseek-v3-671b`` (q_lora, MTP, ``scan_groups``), each at
``.reduced()``, with inputs from numpy seeds.  Tolerances are atol 1e-5 /
rtol 1e-4 unless a case states its own.

* ``capacity`` on both full configs (prefill groups of 1,024, the batch-4
  decode group) and the reduced ones;
* ``_dispatch_group``'s dispatch mask **bitwise** against JAX's, its
  combine and aux, on random probabilities with drops (capacity below the
  load), on rows of exact ties, and on a padded trailing group at
  DeepSeek-V2-Lite's width (848 uniform pad rows, capacity 120: a pad's
  choice 0 takes a slot before a real token's choice 1); ties broken toward
  the higher index there give another mask;
* ``moe_forward`` at ``capacity_factor`` 1.0 with a padded trailing group
  against JAX's, ``scan_groups`` on and off within 1e-6 of each other, and
  a decode step's group of 4 at capacity 1 (choices dropped);
* ``mla_forward`` (the naive form, both q forms), the plain ``attend`` with
  v narrower than q on its chunked and unchunked branches, ``mla_decode``
  into a linear and a ring cache, against JAX's;
* ``Model.prefill`` then ``decode_step`` (linear and ring) against JAX's;
* ``Model.loss`` (``ce``, ``aux``, V3's ``mtp_ce``) and its gradients
  against ``jax.value_and_grad``; the loss under ``torch.func.vmap``
  against a client at a time;
* ``params_from_jax``: every leaf mapped onto the port's own names once
  (the full-width names, shapes and dtypes against ``jax.eval_shape``),
  the router fp32 in a bf16 model, a name two leaves would take refused;
* the smoke run of both archs for one round against JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import ARCHS as J_ARCHS  # noqa: E402
from repro.launch import train as j_launch_train  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.local import cohort_loss, value_and_grad  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.utils.pytree import flatten  # noqa: E402
from repro_torch.weights import cache_from_jax, params_from_jax  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
TOL = dict(atol=1e-5, rtol=1e-4)
KEY = jax.random.PRNGKey(0)


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
    d["moe"], d["mla"] = MoEConfig(**d["moe"]), MLAConfig(**d["mla"])
    return ArchConfig(**d)


def _jcfg(arch, **kw):
    return J_ARCHS[arch].reduced(**kw)


def _np_params(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _flat(jtree) -> dict:
    """A JAX subtree (one layer's params, a cache) as the port's flat dict."""
    return {k: torch.from_numpy(np.array(v)) for k, v in flatten(jax.tree.map(np.asarray,
                                                                               jtree)).items()}


def _close(got, want, what="", **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), err_msg=what, **(tol or TOL))


# ---------------------------------------------------------------------------
# capacity and the dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    """Full width: a prefill group of 1,024 (V2-Lite 120, V3 40) and the
    batch-4 decode group (1: an expert takes one of the four tokens); the
    reduced config's group of 64."""
    for jcfg, group in ((J_ARCHS[arch], 1024), (J_ARCHS[arch], 4), (_jcfg(arch), 64),
                        (_jcfg(arch), 7)):
        assert moe.capacity(port_cfg(jcfg), group) == j_moe.capacity(jcfg, group), group
    assert moe.capacity(get_arch(arch), 1024) == {"deepseek-v2-lite-16b": 120,
                                                  "deepseek-v3-671b": 40}[arch]
    assert moe.capacity(get_arch(arch), 4) == 1


def _probs(case: str):
    """(probs [g, E] fp32, k, cap) of a dispatch case."""
    rng = np.random.default_rng(7)
    if case == "drops":          # 64 tokens, 8 experts, top-2: load 16 an expert, cap 10
        logits = rng.normal(size=(64, 8)) * 2.0
        return _softmax(logits), 2, 10
    if case == "ties":           # exact ties: uniform rows and rows of tied pairs
        p = _softmax(rng.normal(size=(48, 8)))
        p[::3] = 1.0 / 8
        p[1::3, :4] = 0.2
        p[1::3, 4:] = 0.05
        return p.astype(np.float32), 3, 12
    # V2-Lite's padded trailing group of a 4 x 300 prompt: 176 real rows,
    # 848 pads (logits exactly 0, so probabilities exactly 1/64), top-6,
    # capacity 120
    logits = np.zeros((1024, 64))
    logits[:176] = rng.normal(size=(176, 64))
    return _softmax(logits), 6, 120


def _softmax(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case", ["drops", "ties", "padded_group"])
def test_dispatch_group_matches_jax_bitwise(case):
    probs, k, cap = _probs(case)
    jd, jc, ja = j_moe._dispatch_group(jnp.asarray(probs), k, cap)
    d, c, a = moe._dispatch_group(torch.from_numpy(probs), k, cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    _close(c, jc, "combine")
    _close(a, ja, "aux")
    kept = int(d.sum())
    assert kept == int(np.asarray(jd).sum())
    if case != "ties":
        assert kept < probs.shape[0] * k, "the case drops no assignment"


def test_dispatch_ties_toward_the_higher_index_differ_on_the_padded_group(monkeypatch):
    """The planted fault of the tie order: a top-k that breaks ties toward
    the higher index gives the pads experts E-k..E-1 and another mask."""
    probs, k, cap = _probs("padded_group")
    jd = np.asarray(j_moe._dispatch_group(jnp.asarray(probs), k, cap)[0])

    top_k = moe.top_k

    def top_k_high(p, kk):
        vals, idx = top_k(p.flip(-1), kk)
        return vals, p.shape[-1] - 1 - idx

    monkeypatch.setattr(moe, "top_k", top_k_high)
    d = moe._dispatch_group(torch.from_numpy(probs), k, cap)[0].numpy()
    assert not np.array_equal(d, jd)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax_with_a_padded_group(arch):
    """The reduced config at capacity factor 1.0 (drops), 2 x 50 tokens in
    groups of 64 (the second padded with 28 rows), against JAX's
    ``moe_forward``; ``scan_groups`` on and off within 1e-6."""
    jcfg = _jcfg(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=1.0))
    cfg = port_cfg(jcfg)
    jp = j_moe.moe_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = np.random.default_rng(2).normal(size=(2, 50, cfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(j_moe.moe_forward, static_argnums=1)(jp, jcfg, jnp.asarray(x))
    p = _flat(jp)
    ys = {}
    for scan in (False, True):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, scan_groups=scan))
        ys[scan] = moe.moe_forward(p, c, torch.from_numpy(x))
        _close(ys[scan][0], jy, f"y scan_groups={scan}")
        _close(ys[scan][1], jaux, f"aux scan_groups={scan}")
    _close(ys[True][0], ys[False][0].numpy(), atol=1e-6, rtol=1e-6)
    _close(ys[True][1], ys[False][1].numpy(), atol=1e-6, rtol=1e-6)
    assert p["router"].dtype == torch.float32


def test_moe_forward_decode_group_at_capacity_one(monkeypatch):
    """A decode step's one group of batch 4 at capacity 1 (16 experts, top-2,
    capacity factor 1.25): each expert takes one choice, the rest are
    dropped, as in JAX's ``moe_forward``."""
    jcfg = _jcfg("deepseek-v2-lite-16b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, num_experts=16, capacity_factor=1.25))
    cfg = port_cfg(jcfg)
    assert moe.capacity(cfg, 4) == 1
    jp = j_moe.moe_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    x = np.random.default_rng(4).normal(size=(4, 1, cfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(j_moe.moe_forward, static_argnums=1)(jp, jcfg, jnp.asarray(x))
    seen = []
    dispatch = moe._dispatch_group

    def recording(probs, k, cap):
        out = dispatch(probs, k, cap)
        seen.append(out[0])
        return out

    monkeypatch.setattr(moe, "_dispatch_group", recording)
    y, aux = moe.moe_forward(_flat(jp), cfg, torch.from_numpy(x))
    _close(y, jy, "y")
    _close(aux, jaux, "aux")
    assert len(seen) == 1 and int(seen[0].sum()) < 4 * cfg.moe.top_k, "no choice dropped"
    assert int(seen[0].sum(dim=(0, 2)).max()) == 1


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_setup(arch):
    jcfg = _jcfg(arch)
    jp = j_attn.mla_init(jax.random.PRNGKey(4), jcfg, jnp.float32)
    return jcfg, port_cfg(jcfg), jp, _flat(jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_forward_matches_jax(arch):
    jcfg, cfg, jp, p = _mla_setup(arch)
    assert ("wdq" in p) == bool(cfg.mla.q_lora) and ("wq" in p) != bool(cfg.mla.q_lora)
    x = np.random.default_rng(5).normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    pos = np.arange(40)
    jout, (jc, jk) = jax.jit(j_attn.mla_forward, static_argnums=1)(jp, jcfg, jnp.asarray(x),
                                                                    jnp.asarray(pos))
    out, (c, k) = attention.mla_forward(p, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    _close(out, jout, "out")
    _close(c, jc, "c_kv")
    _close(k, jk, "k_rope")


@pytest.mark.parametrize("Tq", [300, 2100], ids=["unchunked", "chunked"])
def test_attend_with_a_v_width_of_its_own(Tq):
    """MLA's shape: q and k 24 wide, v 16, scale 1/sqrt(24); above
    ``CHUNK_THRESHOLD`` queries the port slices the chunks and JAX pads
    them."""
    rng = np.random.default_rng(6)
    q, k = (rng.normal(size=(1, Tq, 2, 24)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(1, Tq, 2, 16)).astype(np.float32)
    pos = np.arange(Tq)
    want = j_attn.attend(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), causal=True)
    got = attention.attend(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)), causal=True)
    assert got.shape == (1, Tq, 2, 16)
    _close(got, want)


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mla_decode_matches_jax(arch, ring):
    """Decode steps from position 0 into a latent cache of 8 slots: 7 steps
    into the linear cache, 12 into the ring (past its size)."""
    jcfg, cfg, jp, p = _mla_setup(arch)
    S, steps = 8, (12 if ring else 7)
    rng = np.random.default_rng(8)
    m = cfg.mla
    jcache = {"c_kv": jnp.zeros((2, S, m.kv_lora)), "k_rope": jnp.zeros((2, S, m.qk_rope_dim))}
    cache = {k: torch.zeros(v.shape) for k, v in jcache.items()}
    jdecode = jax.jit(lambda p_, x_, pos_, c_: j_attn.mla_decode(p_, jcfg, x_, pos_, c_,
                                                                 ring=ring))
    for pos in range(steps):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jdecode(jp, jnp.asarray(x), pos, jcache)
        out, cache = attention.mla_decode(p, cfg, torch.from_numpy(x), pos, cache, ring=ring)
        _close(out, jout, f"out at {pos}")
    for k in cache:
        _close(cache[k], jcache[k], k)


# ---------------------------------------------------------------------------
# the model: prefill, decode, loss
# ---------------------------------------------------------------------------


def _model_setup(arch):
    jcfg = _jcfg(arch)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(KEY)
    cfg = port_cfg(jcfg)
    assert cfg == get_arch(arch).reduced()
    return jmodel, jparams, cfg, build_model(cfg), _np_params(jparams, cfg)


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch, ring):
    """A 2 x 70 prompt (two dispatch groups of 64, the second padded), then 3
    decode steps: into a linear cache of 74, or a ring of 32 (the prefill
    keeps its last 32 positions)."""
    jmodel, jparams, cfg, model, params = _model_setup(arch)
    T, extra = 70, 3
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, T + extra)).astype(np.int32)
    cache_len = 32 if ring else T + extra + 1
    jl, jc = jax.jit(jmodel.prefill, static_argnums=2)(jparams, {"tokens": toks[:, :T]},
                                                         cache_len)
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :T])}, cache_len)
    _close(lg, jl, "prefill logits")
    for k, v in cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")["layers"].items():
        _close(cache["layers"][k], v, f"prefill {k}")
    assert set(cache["layers"]) == {"c_kv", "k_rope"} and cache["pos"] == T
    jdecode = jax.jit(lambda p, t, c: jmodel.decode_step(p, t, c, ring=ring))
    for i in range(extra):
        tok = toks[:, T + i:T + i + 1]
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc)
        with torch.inference_mode():
            lg, cache = model.decode_step(params, torch.from_numpy(tok), cache, ring=ring)
        _close(lg, jl, f"decode step {i}")
    for k, v in cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")["layers"].items():
        _close(cache["layers"][k], v, f"decoded {k}")


def _leafwise_close(got: dict, want: dict, what: str, rtol: float):
    """Each leaf within atol 1e-6 + rtol of that leaf's largest magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].detach().numpy(), want[k].numpy()
        assert np.abs(g - w).max() <= 1e-6 + rtol * np.abs(w).max(), f"{what}: {k}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """2 x 65 tokens (a padded dispatch group): the loss and ``ce``,
    ``aux`` (and V3's ``mtp_ce``) at rtol 1e-5 / atol 1e-6, every gradient
    leaf (the MTP block's, the router's) within 1e-6 + 1e-5 of its largest
    magnitude."""
    jmodel, jparams, cfg, model, params = _model_setup(arch)
    batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab, (2, 66)).astype(np.int32)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, batch)
    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    loss, grads = value_and_grad(model.loss, params, tb)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        _, metrics = model.loss(params, tb)
    assert metrics.keys() == jm.keys() == ({"ce", "aux", "mtp_ce"} if cfg.mtp else {"ce", "aux"})
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(metrics["aux"]) > 0
    _leafwise_close(grads, _np_params(jg, cfg), f"{arch} grads", rtol=1e-5)
    assert (any(k.startswith("mtp_block/") for k in grads) and "mtp_proj" in grads) == cfg.mtp


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_under_vmap_matches_each_client(arch):
    """The vmapped cohort mode's form: the loss over two clients' stacked
    params and batches under ``torch.func.vmap`` and autograd of its sum,
    each client's loss and gradients equal to its own ``value_and_grad``
    (1e-6 + 1e-5 of a leaf's largest magnitude): the dispatch needs no
    host value."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    p0, p1 = model.init(0, "cpu"), model.init(1, "cpu")
    rng = np.random.default_rng(3)
    b0, b1 = ({"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))} for _ in range(2))
    stacked = {k: torch.stack([p0[k], p1[k]]).requires_grad_() for k in p0}
    batches = {k: torch.stack([b0[k], b1[k]]) for k in b0}
    total, losses = cohort_loss(model.loss)(stacked, batches)
    grads = dict(zip(stacked, torch.autograd.grad(total, list(stacked.values()))))
    for i, (p, b) in enumerate(((p0, b0), (p1, b1))):
        loss, want = value_and_grad(model.loss, p, b)
        np.testing.assert_allclose(float(losses[i].detach()), loss.item(), rtol=1e-6)
        _leafwise_close({k: v[i] for k, v in grads.items()}, want, f"{arch} client {i}", 1e-5)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_maps_every_leaf_once(arch):
    """The reduced model in bf16: each JAX leaf onto its own port names (a
    stacked leaf onto one a layer), together exactly the port's own init's
    names, shapes and dtypes, the router fp32 in both; at full width the
    port's leaves against ``jax.eval_shape`` of JAX's init, and their
    counts (V3's 715.4 B with its MTP block)."""
    jcfg = _jcfg(arch, dtype="bfloat16")
    cfg = port_cfg(jcfg)
    jparams = j_build(jcfg).init(KEY)
    jleaves = flatten(jax.tree.map(np.asarray, jparams))
    got = _np_params(jparams, cfg)
    mine = build_model(cfg).init(0, "meta")
    assert len(got) == sum(cfg.n_layers if k.startswith("blocks/") else 1 for k in jleaves)
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in mine.items()}
    routers = [k for k in got if k.endswith("moe/router")]
    assert len(routers) == cfg.n_layers + cfg.mtp
    assert all(got[k].dtype == torch.float32 and mine[k].dtype == torch.float32 for k in routers)
    assert got["blocks/1/moe/experts/gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["blocks/1/moe/experts/down"].float().numpy(),
                                  np.asarray(jparams["blocks"]["moe"]["experts"]["down"][1],
                                             np.float32))

    full = get_arch(arch)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.eval_shape(j_build(J_ARCHS[arch]).init, KEY))[0]:
        name = "/".join(p.key for p in path)
        if path[0].key == "blocks":
            rest = name.partition("/")[2]
            want.update({f"blocks/{i}/{rest}": (tuple(leaf.shape[1:]), str(leaf.dtype))
                         for i in range(full.n_layers)})
        else:
            want[name] = (tuple(leaf.shape), str(leaf.dtype))
    meta = build_model(full).init(0, "meta")
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in meta.items()} \
        == want
    assert sum(v.numel() for v in meta.values()) == {
        "deepseek-v2-lite-16b": 16_210_324_992, "deepseek-v3-671b": 715_407_858_688}[arch]
    with pytest.raises(ValueError, match="two leaves"):
        params_from_jax({"moe": {"router": np.zeros(2)}, "moe/router": np.zeros(2)}, None, "cpu")


# ---------------------------------------------------------------------------
# the smoke run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_one_round_matches_jax(arch, monkeypatch):
    """``run_smoke`` (6 clients, 3 a round, the vmapped cohort mode) from
    JAX's initial params: the round's ``local_loss`` at rtol 1e-4 and each
    leaf within 1e-6 + 1e-4 of its largest magnitude."""
    runs = {}

    def capture(key, fn):
        def run(*a, **k):
            runs[key] = (a[1], fn(*a, **k))
            return runs[key][1]
        return run

    monkeypatch.setattr(j_launch_train, "train", capture("jax", j_launch_train.train))
    j_launch_train.run_smoke(arch, 1, "fedshuffle", "sgd")
    jinit, jres = runs["jax"]
    cfg = get_arch(arch).reduced()
    monkeypatch.setattr(Model, "init", lambda self, seed, device: _np_params(jinit, cfg))
    res = launch_train.run_smoke(arch, 1, device="cpu")
    got, want = res.metrics.rows, jres.metrics.rows
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0]["local_loss"], want[0]["local_loss"], rtol=1e-4)
    _leafwise_close(res.state.params, _np_params(jres.state.params, cfg), f"{arch} smoke", 1e-4)
