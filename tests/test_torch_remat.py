"""``remat`` and the JAX package's perf switches in the PyTorch port, on the
CPU in fp32 with TF32 off, at ``.reduced()`` sizes with inputs from numpy
seeds: one arch of each family (dense ``qwen2-72b``, vlm
``llava-next-mistral-7b``, moe ``deepseek-v3-671b`` with MTP, ssm
``mamba2-1.3b``, hybrid ``hymba-1.5b`` at window 8, audio
``seamless-m4t-medium``).

* ``remat="full"`` against ``"none"``: the loss and every gradient leaf
  bitwise, in the sequential mode (``value_and_grad``) and the vmapped one
  (``cohort_loss`` of two clients, then one ``torch.autograd.grad``); a
  FedShuffle round in both modes bitwise;
* ``remat="full"`` against ``jax.value_and_grad`` of JAX's loss with
  ``remat="full"``: the loss at rtol 1e-5 / atol 1e-6, each gradient leaf
  within 1e-6 + 1e-5 of its largest magnitude (``tests/test_torch_zoo.py``'s
  and ``tests/test_torch_moe.py``'s tolerances);
* that remat drops activations: fewer bytes saved for backward (distinct
  storages, counted by ``torch.autograd.graph.saved_tensors_hooks``), in
  both modes; and that a recompute at positions shifted by one (a planted
  fault) changes the gradients;
* ``attend(banded=True)`` against JAX's at T > 2,048 with a window (within
  1e-6 + 1e-5, and of the port's unbanded ``attend``), unbanded where the
  band does not apply; a loss with ``opt_banded_window`` against JAX's;
* ``softmax_xent(onehot=True)`` against JAX's (rtol 1e-6) and bitwise the
  gather's; a loss with ``opt_onehot_xent`` against JAX's and bitwise its
  gather twin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.registry import ARCHS as J_ARCHS  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig, MLAConfig, MoEConfig, SSMConfig  # noqa: E402,E501
from repro_torch.core.local import cohort_loss, value_and_grad  # noqa: E402
from repro_torch.data.federated import FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import TokenTask  # noqa: E402
from repro_torch.fed.losses import make_loss  # noqa: E402
from repro_torch.fed.rounds import build_round_step  # noqa: E402
from repro_torch.fed.strategy import bind_strategy  # noqa: E402
from repro_torch.models import attention, remat  # noqa: E402
from repro_torch.models.layers import softmax_xent  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

FAMILIES = {"dense": "qwen2-72b", "vlm": "llava-next-mistral-7b", "moe": "deepseek-v3-671b",
            "ssm": "mamba2-1.3b", "hybrid": "hymba-1.5b", "audio": "seamless-m4t-medium"}
KW = {"hybrid": dict(sliding_window=8)}
MODES = ("sequential", "vmapped")
KEY = jax.random.PRNGKey(0)
SEQ, BATCH = 32, 2


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


def port_cfg(jcfg) -> ArchConfig:
    """The port's ArchConfig from the JAX one's fields (one keyword dict)."""
    d = dataclasses.asdict(jcfg)
    for name, kind in (("ssm", SSMConfig), ("moe", MoEConfig), ("mla", MLAConfig)):
        if d.get(name) is not None:
            d[name] = kind(**d[name])
    return ArchConfig(**d)


def _jcfg(family: str, **kw):
    return J_ARCHS[FAMILIES[family]].reduced(**KW.get(family, {}), **kw)


def _setup(family: str, **kw):
    """(JAX model, JAX params, port model, the same params in the port)."""
    jcfg = _jcfg(family, **kw)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(KEY)
    cfg = port_cfg(jcfg)
    return jmodel, jparams, build_model(cfg), _np_params(jparams, cfg)


def _np_params(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _batch(cfg, seed: int, T: int = SEQ + 1) -> dict:
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (BATCH, T)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.normal(size=(BATCH, cfg.src_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.normal(size=(BATCH, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return b


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _forward(model, params: dict, mode: str, seed: int = 1):
    """(the loss to differentiate, the losses to report, the leaves): of one
    client (sequential), or of two clients under ``torch.func.vmap``
    (``params`` and ``params`` scaled by 1.01, each over its own batch)."""
    cfg = model.cfg
    if mode == "sequential":
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, _ = model.loss(leaves, _torch(_batch(cfg, seed)))
        return loss, loss, leaves
    b0, b1 = _torch(_batch(cfg, seed)), _torch(_batch(cfg, seed + 1))
    leaves = {k: torch.stack([v, v * 1.01]).requires_grad_() for k, v in params.items()}
    total, losses = cohort_loss(model.loss)(leaves, {k: torch.stack([b0[k], b1[k]]) for k in b0})
    return total, losses, leaves


def _loss_and_grads(model, params: dict, mode: str, seed: int = 1):
    """(loss or losses [2], {name: grad}) of :func:`_forward`."""
    total, losses, leaves = _forward(model, params, mode, seed)
    return losses.detach(), dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))


def _bitwise(got: dict, want: dict) -> list:
    assert got.keys() == want.keys()
    return [k for k in want if not torch.equal(got[k], want[k])]


def _leafwise_close(got: dict, want: dict, what: str, rtol: float):
    """Each leaf within atol 1e-6 + rtol of that leaf's largest magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].detach().numpy(), want[k].numpy()
        assert np.abs(g - w).max() <= 1e-6 + rtol * np.abs(w).max(), f"{what}: {k}"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_equals_no_remat_bitwise(family, mode):
    """The recompute runs the same operations on the same inputs: the loss
    and every gradient leaf with ``remat="full"`` are those of ``"none"``
    bit for bit (the audio family's encoder leaves too: the decoder body
    takes the memory once for V and once for K)."""
    _, _, model, params = _setup(family, remat="none")
    r_model = build_model(dataclasses.replace(model.cfg, remat="full"))
    loss, grads = _loss_and_grads(model, params, mode)
    r_loss, r_grads = _loss_and_grads(r_model, params, mode)
    assert torch.equal(r_loss, loss)
    assert _bitwise(r_grads, grads) == []


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_matches_jax(family):
    jmodel, jparams, model, params = _setup(family, remat="full")
    assert model.cfg.remat == "full"
    batch = _batch(model.cfg, 1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, batch)
    loss, grads = value_and_grad(model.loss, params, _torch(batch))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    _, metrics = model.loss(params, _torch(batch))
    assert metrics.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5, atol=1e-6)
    _leafwise_close(grads, _np_params(jg, model.cfg), f"{family} grads", rtol=1e-5)


def _saved_bytes(model, params: dict, mode: str) -> int:
    """Bytes of the distinct storages the forward pass saves for backward."""
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _forward(model, params, mode)
    return sum(seen.values())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_saves_fewer_bytes_for_backward(family, mode):
    """A remat that recomputed nothing would pass the bitwise test; this
    one fails it: with ``remat="full"`` a layer keeps its inputs alone."""
    _, _, model, params = _setup(family, remat="none")
    r_model = build_model(dataclasses.replace(model.cfg, remat="full"))
    plain, kept = _saved_bytes(model, params, mode), _saved_bytes(r_model, params, mode)
    assert 0 < kept < plain, (kept, plain)


class _ShiftedRecompute(remat._Checkpoint):
    """A planted fault: the backward pass recomputes the layer at positions
    shifted by one (every integer input of the body)."""

    @staticmethod
    def backward(ctx, *cts):
        xs = tuple(x if x.is_floating_point() else x + 1 for x in ctx.saved_tensors)
        return (None, *remat.recompute_vjp(ctx.body, xs, cts))


@pytest.mark.parametrize("mode", MODES)
def test_a_recompute_at_shifted_positions_is_caught(mode, monkeypatch):
    _, _, model, params = _setup("dense", remat="full")
    loss, grads = _loss_and_grads(model, params, mode)
    monkeypatch.setattr(remat, "_Checkpoint", _ShiftedRecompute)
    f_loss, f_grads = _loss_and_grads(model, params, mode)
    assert torch.equal(f_loss, loss)    # the forward pass is the same
    differ = _bitwise(f_grads, grads)
    assert "blocks/0/attn/wq" in differ and "lm_head" not in differ


ROUND_FL = dict(num_clients=4, cohort_size=2, sampling="uniform", epochs=1, local_batch=2,
                algorithm="fedshuffle", local_lr=0.05, mean_samples=4, seed=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", ["dense", "audio"])
def test_fedshuffle_round_with_remat_is_bitwise(family, mode):
    """``tests/test_torch_zoo.py``'s round (4 clients, 2 a round, 16-token
    samples) with ``remat="full"`` and without: the same params and
    metrics, bit for bit."""
    _, _, model, params = _setup(family, remat="none")
    extras = ({"frames": (model.cfg.src_frames, model.cfg.d_model)}
              if family == "audio" else {})
    out = {}
    for r in ("none", "full"):
        loss_fn = make_loss(build_model(dataclasses.replace(model.cfg, remat=r)))
        fl = FLConfig(**ROUND_FL, cohort_mode=mode)
        pipe = FederatedPipeline(TokenTask(vocab=model.cfg.vocab, seq_len=16, num_clients=4,
                                           extras=extras), Population.build(fl), fl)
        strat = bind_strategy(None, fl, loss_fn, num_clients=4)
        out[r] = build_round_step(loss_fn, strat, fl, device="cpu")(
            strat.init(dict(params)), pipe.round_batch(0))
    (state, mets), (r_state, r_mets) = out["none"], out["full"]
    assert _bitwise(r_state.params, state.params) == []
    assert float(mets["delta_norm"]) > 0
    assert all(torch.equal(torch.as_tensor(r_mets[k]), torch.as_tensor(v))
               for k, v in mets.items())


BANDED = [(2500, 256, 2), (3072, 1000, 4), (2049, 1000, 1)]   # (T, window, KV)


@pytest.mark.parametrize("T,window,kv", BANDED)
def test_banded_attend_matches_jax(T, window, kv):
    """q [1, T, 4, 16] over k/v [1, T, kv, 16]: query chunks of 1,024 (a
    ragged last one at 2,500 and 2,049), each scoring its band of 1,024 +
    window keys; at T 2,049 and window 1,000 the band (2,024) leaves only
    one key out of the last chunk's."""
    rng = np.random.default_rng(T)
    q, k, v = (rng.normal(size=(1, T, h, 16)).astype(np.float32) for h in (4, kv, kv))
    pos = np.arange(T)
    want = np.asarray(j_attn.attend(q, k, v, pos, pos, window=window, banded=True))
    args = [torch.from_numpy(x) for x in (q, k, v, pos, pos)]
    got = attention.attend(*args, window=window, banded=True)
    plain = attention.attend(*args, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6, rtol=1e-5)
    assert not torch.equal(got, attention.attend(*args, window=window + 1, banded=True))


@pytest.mark.parametrize("T,window", [(2000, 256), (2500, 0), (2500, 1500)])
def test_banded_attend_is_unbanded_where_the_band_does_not_apply(T, window):
    """No chunking (T <= 2,048), no window, or Tk <= 1,024 + window: the
    unbanded path itself, bitwise."""
    rng = np.random.default_rng(T + window)
    args = [torch.from_numpy(rng.normal(size=(1, T, h, 16)).astype(np.float32))
            for h in (2, 1, 1)]
    assert torch.equal(attention.attend(*args, window=window, banded=True),
                       attention.attend(*args, window=window))


def test_banded_loss_matches_jax():
    """Qwen2-tiny with a window of 256 and ``opt_banded_window`` over 2,100
    tokens (three query chunks): loss and gradients against JAX's, and
    against the port's unbanded loss."""
    jmodel, jparams, model, params = _setup("dense", sliding_window=256, opt_banded_window=True,
                                            n_layers=1)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, model.cfg.vocab, (1, 2101)).astype(np.int32)}
    (jl, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, batch)
    loss, grads = value_and_grad(model.loss, params, _torch(batch))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    _leafwise_close(grads, _np_params(jg, model.cfg), "banded grads", rtol=1e-5)
    plain = build_model(dataclasses.replace(model.cfg, opt_banded_window=False))
    p_loss, p_grads = value_and_grad(plain.loss, params, _torch(batch))
    np.testing.assert_allclose(loss.item(), p_loss.item(), rtol=1e-6)
    _leafwise_close(grads, p_grads, "banded vs unbanded", rtol=1e-5)


def test_onehot_xent_matches_jax():
    """The picked logit is one value times 1 plus exact zeros: in each
    framework the one-hot cross entropy equals the gather's bit for bit
    (bf16 logits cast to fp32 too), and the port's equals JAX's within
    rtol 1e-6 (the two logsumexps round apart)."""
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(3, 50, 517)) * 4).astype(np.float32)
    labels = rng.integers(0, 517, (3, 50)).astype(np.int32)
    want = np.asarray(j_layers.softmax_xent(jnp.asarray(logits), labels, onehot=True))
    np.testing.assert_array_equal(
        want, np.asarray(j_layers.softmax_xent(jnp.asarray(logits), labels)))
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    got = softmax_xent(tl, tlab, onehot=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert torch.equal(got, softmax_xent(tl, tlab))
    bf = tl.bfloat16()
    assert torch.equal(softmax_xent(bf, tlab, onehot=True), softmax_xent(bf, tlab))


@pytest.mark.parametrize("family", ["moe", "audio"])
def test_onehot_xent_loss_matches_jax(family):
    """Every cross entropy of the loss with ``opt_onehot_xent``: V3's ``ce``
    and ``mtp_ce``, the audio decoder's; against JAX's, and the loss and
    gradients bitwise those of the gather."""
    jmodel, jparams, model, params = _setup(family, opt_onehot_xent=True)
    batch = _batch(model.cfg, 2)
    (jl, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, batch)
    loss, grads = value_and_grad(model.loss, params, _torch(batch))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    _leafwise_close(grads, _np_params(jg, model.cfg), f"{family} onehot grads", rtol=1e-5)
    gather = build_model(dataclasses.replace(model.cfg, opt_onehot_xent=False))
    g_loss, g_grads = value_and_grad(gather.loss, params, _torch(batch))
    assert torch.equal(loss, g_loss) and _bitwise(grads, g_grads) == []


def test_unknown_remat_is_refused():
    with pytest.raises(ValueError, match="remat"):
        build_model(dataclasses.replace(port_cfg(_jcfg("dense")), remat="some"))


def test_ignored_switches_change_no_value():
    """``scan_unroll`` and ``opt_seq_shard`` steer XLA alone in the JAX
    package, and ``serve_window_long`` sizes only the JAX launch tools'
    long-context cache: the port's loss and gradients do not move with
    them."""
    _, _, model, params = _setup("dense")
    moved = build_model(dataclasses.replace(model.cfg, scan_unroll=2, opt_seq_shard=True,
                                            serve_window_long=64))
    loss, grads = _loss_and_grads(model, params, "sequential")
    m_loss, m_grads = _loss_and_grads(moved, params, "sequential")
    assert torch.equal(loss, m_loss) and _bitwise(m_grads, grads) == []
    assert JFL().aggregation == FLConfig().aggregation == "unbiased"


@pytest.mark.parametrize("mode", MODES)
def test_aggregation_changes_no_round(mode):
    """``FLConfig.aggregation`` is read by nothing, in either package: a
    FedShuffle round with ``"sum_one"`` is bitwise the default round."""
    _, _, model, params = _setup("dense")
    loss_fn = make_loss(model)
    out = {}
    for agg in ("unbiased", "sum_one"):
        fl = FLConfig(**ROUND_FL, cohort_mode=mode, aggregation=agg)
        pipe = FederatedPipeline(TokenTask(vocab=model.cfg.vocab, seq_len=16, num_clients=4),
                                 Population.build(fl), fl)
        strat = bind_strategy(None, fl, loss_fn, num_clients=4)
        out[agg] = build_round_step(loss_fn, strat, fl, device="cpu")(
            strat.init(dict(params)), pipe.round_batch(0))
    (state, mets), (a_state, a_mets) = out["unbiased"], out["sum_one"]
    assert float(mets["delta_norm"]) > 0
    assert _bitwise(a_state.params, state.params) == []
    assert all(torch.equal(torch.as_tensor(a_mets[k]), torch.as_tensor(v))
               for k, v in mets.items())
