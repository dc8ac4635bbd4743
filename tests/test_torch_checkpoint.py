"""The PyTorch port's checkpoints (``repro_torch.utils.checkpoint``) and
resume, against the JAX package's.

* twins of the 11 tests of ``tests/test_checkpoint.py`` (round trip with a
  bf16 leaf, missing keys, the train loop's params checkpoint, a server
  state with its bank, template and shape mismatches, the resume-round
  check, bitwise mid-run resume, the three atomic-save crashes, which
  monkeypatch the port's module) and of ``tests/test_comm.py:244`` (the EF
  bank resumed bitwise, both engines); the refusals of another version and
  of a DP run's sidecar;
* resume within the port, bitwise: 2 + 2 rounds through a file == 4 rounds
  on a two-layer CharLM through the cohort engine at ``prefetch=2`` with
  the cosine schedule: dense, MVR App. F and exact eq. 14, bucketed, and
  the sequential mode with both banks (``ef_qsgd`` up, ``qsgd`` down);
* interchange: ``params_to_jax`` / ``server_state_to_jax`` invert
  ``params_from_jax`` / ``server_state_from_jax`` (a bf16 Hymba tree too);
  a server state (params, ``m``, EF bank) that JAX's ``save_server_state``
  wrote loads into the port bitwise, and one the port wrote loads in JAX's
  ``load_server_state`` with JAX's template (same keys, shapes, dtypes,
  values); the port's continuation of a JAX file (MVR App. F, topk's EF
  bank, on the quadratic) matches JAX's at ``tests/test_torch_mvr.py``'s
  rtol 1e-5 / atol 1e-6;
* serving: a reduced-qwen1.5-0.5b params file that JAX saved gives JAX's
  greedy tokens through the port's ``serve --checkpoint``; the train CLI's
  ``--checkpoint`` writes a file JAX's ``load_checkpoint`` reads.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.utils.checkpoint as ckpt_mod  # noqa: E402
from repro.configs.base import ArchConfig as JArch  # noqa: E402
from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.registry import ARCHS as J_ARCHS  # noqa: E402
from repro.data.federated import FederatedPipeline as JPipe  # noqa: E402
from repro.data.federated import Population as JPop  # noqa: E402
from repro.data.tasks import DuplicatedQuadraticTask as JDup  # noqa: E402
from repro.fed.losses import make_loss as j_make_loss  # noqa: E402
from repro.fed.losses import make_quadratic_loss as j_quad  # noqa: E402
from repro.fed.strategy import bind_strategy as j_bind  # noqa: E402
from repro.fed.strategy import strategy_for as j_strategy_for  # noqa: E402
from repro.fed.train_loop import train as j_train  # noqa: E402
from repro.launch.serve import generate as j_generate  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.utils import checkpoint as j_ckpt  # noqa: E402
from repro.utils.pytree import tree_paths as j_tree_paths  # noqa: E402
from repro_torch.configs.base import ArchConfig, FLConfig  # noqa: E402
from repro_torch.data.federated import FederatedPipeline, Population  # noqa: E402
from repro_torch.data.tasks import CharLMTask, DuplicatedQuadraticTask  # noqa: E402
from repro_torch.fed.cohort.engine import CohortEngine  # noqa: E402
from repro_torch.fed.losses import make_loss, make_quadratic_loss  # noqa: E402
from repro_torch.fed.server import ServerState  # noqa: E402
from repro_torch.fed.strategy import bind_strategy, strategy_for  # noqa: E402
from repro_torch.fed.train_loop import train  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils.checkpoint import (SERVER_STATE_VERSION, load_checkpoint,  # noqa: E402
                                          load_metadata, load_server_state, save_checkpoint,
                                          save_server_state)
from repro_torch.weights import (params_from_jax, params_to_jax,  # noqa: E402
                                 server_state_from_jax, server_state_to_jax)

TASK = DuplicatedQuadraticTask(copies=(1, 2, 3))
LOSS = make_quadratic_loss(3)
X0 = np.array([0.3, -0.1, 0.2], np.float32)
# a two-layer CharLM: blocks stacked [2, ...] in the JAX layout
MICRO = dict(name="charlm-micro", family="dense", n_layers=2, d_model=32, n_heads=2,
             n_kv_heads=2, d_ff=64, vocab=32, dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _tree_equal(a[k], b[k], f"{what}/{k}")
    elif a is None:
        assert b is None, what
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), what


def _state_equal(a, b, what):
    assert int(a.rnd) == int(b.rnd), what
    _tree_equal(a.params, b.params, f"{what}: params")
    _tree_equal(a.opt, b.opt, f"{what}: opt")
    _tree_equal(a.clients, b.clients, f"{what}: bank")


# ---------------------------------------------------------------------------
# twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"w": torch.ones(4, dtype=torch.bfloat16), "i": torch.arange(3)}}
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, tree, {"round": 7})
    restored = load_checkpoint(path, tree)
    _tree_equal(tree, restored, "round trip")
    assert np.load(path)["b/w"].dtype == np.float32       # bf16 stored widened
    assert load_metadata(path)["round"] == 7


def test_missing_key_raises(tmp_path):
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, {"a": torch.ones(2)})
    with pytest.raises(KeyError):
        load_checkpoint(path, {"a": torch.ones(2), "b": torch.ones(2)})


def _quad_fl(**kw):
    return FLConfig(**dict(num_clients=3, cohort_size=2, sampling="uniform", epochs=2,
                           local_batch=1, algorithm="fedshuffle", local_lr=0.05,
                           server_lr=0.8, seed=11, uplink="topk", uplink_frac=0.5) | kw)


def _pipe(fl):
    return FederatedPipeline(TASK, Population.build(fl, sizes=TASK.sizes()), fl)


def _x0():
    return {"x": torch.from_numpy(X0.copy())}


def test_train_loop_checkpointing(tmp_path):
    fl = FLConfig(num_clients=2, cohort_size=2, sampling="full", local_batch=1,
                  algorithm="fedshuffle", local_lr=0.1)
    task = DuplicatedQuadraticTask(copies=(1, 2))
    pipe = FederatedPipeline(task, Population.build(fl, sizes=task.sizes()), fl)
    path = os.path.join(tmp_path, "run.npz")
    res = train(make_quadratic_loss(2), {"x": torch.zeros(2)}, pipe, fl, 5,
                checkpoint_path=path, checkpoint_every=2, log_every=0, device="cpu")
    restored = load_checkpoint(path, {"x": torch.zeros(2)})
    assert torch.equal(res.state.params["x"], restored["x"])
    meta = load_metadata(path)
    assert meta["round"] == 4 and meta["name"] == "run" and meta["elapsed_s"] >= 0


def _strat(fl, loss=LOSS):
    return bind_strategy(strategy_for(fl), fl, loss, num_clients=fl.num_clients)


def test_server_state_roundtrip_with_bank(tmp_path):
    fl = _quad_fl()
    state = train(LOSS, _x0(), _pipe(fl), fl, 3, log_every=0, device="cpu").state
    path = os.path.join(tmp_path, "state.npz")
    save_server_state(path, state, {"round": 2})
    meta = load_metadata(path)
    assert meta["state_version"] == SERVER_STATE_VERSION
    assert meta["has_client_state"] is True and meta["round"] == 2
    restored = load_server_state(path, _strat(fl).init(_x0()))
    _state_equal(state, restored, "restored")
    assert np.load(path)["rnd"].dtype == np.int32 and np.load(path)["rnd"].shape == ()


def test_server_state_template_mismatch_raises(tmp_path):
    fl = _quad_fl()
    state = _strat(fl).init(_x0())
    path = os.path.join(tmp_path, "state.npz")
    save_server_state(path, state)
    # a stateless template must refuse a bank-carrying checkpoint (and not
    # silently resume without the EF residuals)
    plain = _strat(dataclasses.replace(fl, uplink="identity"))
    with pytest.raises(ValueError, match="state bank"):
        load_server_state(path, plain.init(_x0()))
    # and the reverse
    bare = os.path.join(tmp_path, "bare.npz")
    save_server_state(bare, plain.init(_x0()))
    with pytest.raises(ValueError, match="state bank"):
        load_server_state(bare, state)
    # and a non-server-state npz is refused by format
    other = os.path.join(tmp_path, "plain.npz")
    save_checkpoint(other, _x0())
    with pytest.raises(ValueError, match="not a server-state"):
        load_server_state(other, state)


def test_server_state_shape_mismatch_raises(tmp_path):
    """A bank saved under a different population must not load: the round
    step would silently clamp or drop the out-of-range rows."""
    fl = _quad_fl()
    path = os.path.join(tmp_path, "state.npz")
    save_server_state(path, _strat(fl).init(_x0()))
    fl6 = dataclasses.replace(fl, num_clients=6, cohort_size=3)
    with pytest.raises(ValueError, match="shape"):
        load_server_state(path, _strat(fl6).init(_x0()))


def test_server_state_version_and_dp_refusals(tmp_path):
    fl = _quad_fl()
    state = _strat(fl).init(_x0())
    path = os.path.join(tmp_path, "state.npz")
    save_server_state(path, state)
    meta_path = os.path.join(tmp_path, "state.json")
    meta = load_metadata(path)
    with open(meta_path, "w") as f:
        json.dump(meta | {"state_version": SERVER_STATE_VERSION + 1}, f)
    with pytest.raises(ValueError, match="version"):
        load_server_state(path, state)
    with open(meta_path, "w") as f:
        json.dump(meta | {"dp_accounting": {"noise_multiplier": 1.0}}, f)
    with pytest.raises(NotImplementedError, match="item 9"):
        load_server_state(path, state)


def test_resume_round_mismatch_raises():
    """train(state=, start_round=) refuses a start_round that disagrees with
    the rounds the state already completed (a silent replay or skip)."""
    fl = _quad_fl()
    mid = train(LOSS, _x0(), _pipe(fl), fl, 3, log_every=0, device="cpu").state
    with pytest.raises(ValueError, match="start_round"):
        train(LOSS, _x0(), _pipe(fl), fl, 6, log_every=0, state=mid, start_round=2,
              device="cpu")


def test_resume_mid_training_is_bitwise(tmp_path):
    """Checkpoint at round 3 of 6, reload, finish: the stitched run equals
    the unbroken 6-round run bit for bit (params, opt, bank, rnd)."""
    fl = _quad_fl(server_opt="momentum")
    full = train(LOSS, _x0(), _pipe(fl), fl, 6, log_every=0, device="cpu").state
    half = train(LOSS, _x0(), _pipe(fl), fl, 3, log_every=0, device="cpu").state
    path = os.path.join(tmp_path, "mid.npz")
    save_server_state(path, half, {"round": 2})
    restored = load_server_state(path, _strat(fl).init(_x0()))
    resumed = train(LOSS, _x0(), _pipe(fl), fl, 6, log_every=0, state=restored, start_round=3,
                    device="cpu").state
    _state_equal(full, resumed, "resume")
    assert full.rnd == resumed.rnd == 6


def test_atomic_save_crash_during_npz_write(tmp_path, monkeypatch):
    """np.savez dies halfway (full disk, SIGKILL): the previous pair stays
    byte-identical and loadable, and no tmp litter remains."""
    path = os.path.join(tmp_path, "ckpt.npz")
    old = {"a": torch.arange(4, dtype=torch.float32)}
    save_checkpoint(path, old, {"round": 1})
    raw = open(path, "rb").read()

    def boom(fname, **kw):
        with open(fname, "wb") as f:
            f.write(b"partial garbage")
        raise RuntimeError("simulated crash")

    monkeypatch.setattr(ckpt_mod.np, "savez", boom)
    with pytest.raises(RuntimeError, match="simulated crash"):
        save_checkpoint(path, {"a": torch.full((4,), 7.0)}, {"round": 2})
    assert open(path, "rb").read() == raw                 # npz untouched
    assert torch.equal(load_checkpoint(path, old)["a"], old["a"])
    assert load_metadata(path)["round"] == 1              # sidecar untouched
    assert sorted(os.listdir(tmp_path)) == ["ckpt.json", "ckpt.npz"]


def test_atomic_save_crash_before_any_replace(tmp_path, monkeypatch):
    """Both tmp files written but the first os.replace never ran: the
    previous pair is intact, the tmp files are cleaned up."""
    path = os.path.join(tmp_path, "ckpt.npz")
    old = {"a": torch.zeros(3)}
    save_checkpoint(path, old, {"round": 5})

    def boom(src, dst):
        raise RuntimeError("simulated crash")

    monkeypatch.setattr(ckpt_mod.os, "replace", boom)
    with pytest.raises(RuntimeError, match="simulated crash"):
        save_checkpoint(path, {"a": torch.ones(3)}, {"round": 6})
    assert torch.equal(load_checkpoint(path, old)["a"], torch.zeros(3))
    assert load_metadata(path)["round"] == 5
    assert sorted(os.listdir(tmp_path)) == ["ckpt.json", "ckpt.npz"]


def test_atomic_save_json_sidecar_is_commit_marker(tmp_path, monkeypatch):
    """Crash between the two replaces: the npz is new but the sidecar names
    the OLD round; readers keying off the sidecar never see a torn file."""
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, {"a": torch.zeros(2)}, {"round": 1})
    real_replace, calls = ckpt_mod.os.replace, []

    def boom_second(src, dst):
        calls.append(dst)
        if len(calls) == 2:
            raise RuntimeError("simulated crash")
        return real_replace(src, dst)

    monkeypatch.setattr(ckpt_mod.os, "replace", boom_second)
    with pytest.raises(RuntimeError, match="simulated crash"):
        save_checkpoint(path, {"a": torch.ones(2)}, {"round": 2})
    monkeypatch.setattr(ckpt_mod.os, "replace", real_replace)
    assert torch.equal(load_checkpoint(path, {"a": torch.zeros(2)})["a"], torch.ones(2))
    assert load_metadata(path)["round"] == 1
    assert sorted(os.listdir(tmp_path)) == ["ckpt.json", "ckpt.npz"]


@pytest.mark.parametrize("engine", ["legacy", "cohort"])
def test_ef_bank_resume_bitwise(tmp_path, engine):
    """Twin of tests/test_comm.py:244: the EF residual bank rides the
    checkpoint and the resumed trajectory equals the unbroken one bitwise."""
    fl = _quad_fl(engine=engine, rr_backend="device")
    full = train(LOSS, _x0(), _pipe(fl), fl, 4, log_every=0, device="cpu")
    assert full.state.clients is not None and "uplink" in full.state.clients
    half = train(LOSS, _x0(), _pipe(fl), fl, 2, log_every=0, device="cpu")
    path = os.path.join(tmp_path, f"ef_{engine}.npz")
    save_server_state(path, half.state)
    restored = load_server_state(path, _strat(fl).init(_x0()))
    _state_equal(half.state, restored, f"{engine}: restored state")
    resumed = train(LOSS, _x0(), _pipe(fl), fl, 4, log_every=0, state=restored, start_round=2,
                    device="cpu")
    _state_equal(full.state, resumed.state, f"{engine}: resumed run")


# ---------------------------------------------------------------------------
# resume within the port: CharLM through the engine, prefetched
# ---------------------------------------------------------------------------


def _micro_run(kw, rounds, tmp_path=None, resume_at=None, schedule="cosine"):
    fl = FLConfig(**dict(num_clients=6, cohort_size=3, sampling="uniform", epochs=1,
                         local_batch=2, algorithm="fedshuffle", local_lr=0.05,
                         imbalance="lognormal", mean_samples=4, seed=1, engine="cohort",
                         rr_backend="device", prefetch=2) | kw)
    cfg = ArchConfig(**MICRO)
    model = build_model(cfg)
    loss = make_loss(model)
    params = model.init(0, "cpu")
    strat = _strat(fl, loss)

    def engine():
        task = CharLMTask(vocab=cfg.vocab, seq_len=8, num_clients=fl.num_clients)
        return CohortEngine.build(task, Population.build(fl), fl, device="cpu")

    if resume_at is None:
        return train(loss, params, engine(), fl, rounds, strategy=strat, schedule=schedule,
                     log_every=0, device="cpu").state
    half = train(loss, params, engine(), fl, resume_at, strategy=strat, schedule=schedule,
                 log_every=0, device="cpu").state
    path = os.path.join(tmp_path, "state.npz")
    save_server_state(path, half)
    restored = load_server_state(path, strat.init(params))
    return train(loss, params, engine(), fl, rounds, strategy=strat, schedule=schedule,
                 log_every=0, state=restored, start_round=resume_at, device="cpu").state


@pytest.mark.parametrize("kw", [dict(), dict(server_opt="mvr"),
                                dict(server_opt="mvr", mvr_exact=True),
                                dict(exec_mode="bucketed", buckets=3),
                                dict(cohort_mode="sequential", uplink="ef_qsgd",
                                     downlink="qsgd")],
                         ids=["dense", "mvr", "mvr_exact", "bucketed", "banks"])
def test_resume_two_plus_two_equals_four(tmp_path, kw):
    want = _micro_run(kw, 4)
    got = _micro_run(kw, 4, tmp_path, resume_at=2)
    _state_equal(want, got, f"{kw}: 2 + 2 vs 4")
    assert got.rnd == 4


# ---------------------------------------------------------------------------
# interchange with the JAX package
# ---------------------------------------------------------------------------


def test_to_jax_inverts_from_jax():
    """params_to_jax / server_state_to_jax are the exact inverses of the
    from_jax functions: a bf16 Hymba tree (fp32 SSD leaves inside) and a
    JAX CharLM server state with an EF bank and a downlink reference."""
    jcfg = J_ARCHS["hymba-1.5b"].reduced(dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    back = params_to_jax(params_from_jax(jparams, None, "cpu"))
    want = {k: v for k, v in j_tree_paths(jparams)}
    got = {k: v for k, v in j_tree_paths(back)}
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].shape == got[k].shape, k
        np.testing.assert_array_equal(want[k].view(np.uint8), got[k].view(np.uint8), err_msg=k)

    jstate, *_ = _jax_micro_state(dict(uplink="ef_qsgd", downlink="qsgd", server_opt="mvr"))
    np_state = jax.tree.map(np.asarray, jstate)
    back = server_state_to_jax(server_state_from_jax(np_state, None, "cpu"))
    want = dict(j_tree_paths(np_state._asdict()))
    got = dict(j_tree_paths(back._asdict()))
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _micro_fl(kw):
    return dict(num_clients=6, cohort_size=3, local_batch=2, seed=1) | kw


def _jax_micro_state(kw):
    """A JAX ServerState of the two-layer CharLM, every leaf random."""
    jfl = JFL(**_micro_fl(kw))
    jmodel = j_build_model(JArch(**MICRO))
    jstrat = j_bind(j_strategy_for(jfl), jfl, j_make_loss(jmodel), num_clients=6)
    state = jstrat.init(jmodel.init(jax.random.PRNGKey(0)))
    leaves, treedef = jax.tree.flatten(state)
    rng = np.random.default_rng(3)
    leaves = [jnp.asarray(rng.normal(size=np.shape(x)).astype(np.asarray(x).dtype))
              if np.asarray(x).dtype.kind == "f" else jnp.asarray(2, jnp.int32) for x in leaves]
    return jax.tree.unflatten(treedef, leaves), jstrat, jmodel


def _port_micro_template(kw):
    fl = FLConfig(**_micro_fl(kw))
    model = build_model(ArchConfig(**MICRO))
    return _strat(fl, make_loss(model)).init(model.init(0, "cpu"))


KW_BANK = dict(uplink="topk", uplink_frac=0.5, server_opt="mvr")


def test_jax_server_state_loads_into_the_port(tmp_path):
    jstate, *_ = _jax_micro_state(KW_BANK)
    path = os.path.join(tmp_path, "jax_state.npz")
    j_ckpt.save_server_state(path, jstate, {"round": 1})
    got = load_server_state(path, _port_micro_template(KW_BANK))
    want = server_state_from_jax(jax.tree.map(np.asarray, jstate), ArchConfig(**MICRO), "cpu")
    assert sorted(got.opt) == ["m"] and sorted(got.clients) == ["uplink"]
    _state_equal(want, got, "JAX file in the port")
    assert got.rnd == 2 and isinstance(got.rnd, int)


def test_port_server_state_loads_in_jax(tmp_path):
    state = _port_micro_template(KW_BANK)
    gen = torch.Generator().manual_seed(4)
    state = ServerState(
        params={k: torch.randn(v.shape, generator=gen) for k, v in state.params.items()},
        opt={"m": {k: torch.randn(v.shape, generator=gen) for k, v in state.opt["m"].items()}},
        rnd=3,
        clients={"uplink": {f: {k: torch.randn(v.shape, generator=gen) for k, v in t.items()}
                            for f, t in state.clients["uplink"].items()}})
    path = os.path.join(tmp_path, "port_state.npz")
    save_server_state(path, state)
    jtemplate = _jax_micro_state(KW_BANK)[1].init(
        j_build_model(JArch(**MICRO)).init(jax.random.PRNGKey(0)))
    restored = j_ckpt.load_server_state(path, jtemplate)
    want = dict(j_tree_paths(jtemplate._asdict()))
    got = dict(j_tree_paths(restored._asdict()))
    assert want.keys() == got.keys()
    ours = dict(j_tree_paths(server_state_to_jax(state)._asdict()))
    for k in want:
        assert np.shape(got[k]) == np.shape(want[k]), k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), ours[k], err_msg=k)
    assert int(restored.rnd) == 3


def test_port_continues_a_jax_checkpoint(tmp_path):
    """JAX saves its MVR App. F state (params, m, topk's EF bank) after
    round 2; the port loads the file and runs rounds 2 and 3, landing where
    JAX's own continuation of the file does (rtol 1e-5 / atol 1e-6: the
    port's server step multiplies by 1/eta_l where JAX divides)."""
    kw = dict(num_clients=3, cohort_size=2, sampling="uniform", epochs=2, local_batch=1,
              algorithm="fedshuffle", local_lr=0.05, server_lr=0.8, seed=11,
              server_opt="mvr", uplink="topk", uplink_frac=0.5, cohort_mode="sequential")
    jfl = JFL(**kw)
    jtask = JDup(copies=(1, 2, 3))

    def jpipe():
        return JPipe(jtask, JPop.build(jfl, sizes=jtask.sizes()), jfl)

    jl = j_quad(3)
    jparams = {"x": jnp.asarray(X0)}
    half = j_train(jl, jparams, jpipe(), jfl, 2, log_every=0).state
    path = os.path.join(tmp_path, "jax_mvr.npz")
    j_ckpt.save_server_state(path, half)
    jstrat = j_bind(j_strategy_for(jfl), jfl, jl, num_clients=3)
    jres = j_train(jl, jparams, jpipe(), jfl, 4, log_every=0,
                   state=j_ckpt.load_server_state(path, jstrat.init(jparams)), start_round=2)

    fl = FLConfig(**kw)
    state = load_server_state(path, _strat(fl).init(_x0()))
    res = train(LOSS, _x0(), _pipe(fl), fl, 4, log_every=0, state=state, start_round=2,
                device="cpu")
    assert res.state.rnd == int(jres.state.rnd) == 4
    for got, want in ((res.state.params["x"], jres.state.params["x"]),
                      (res.state.opt["m"]["x"], jres.state.opt["m"]["x"]),
                      (res.state.clients["uplink"]["e"]["x"],
                       jres.state.clients["uplink"]["e"]["x"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_serve_cli_serves_a_jax_checkpoint(tmp_path, capsys):
    """A reduced-qwen1.5-0.5b params file that JAX saved: the port's
    ``serve --checkpoint`` gives JAX's greedy tokens on the same prompts."""
    jcfg = J_ARCHS["qwen1.5-0.5b"].reduced()
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    path = os.path.join(tmp_path, "qwen.npz")
    j_ckpt.save_checkpoint(path, jparams, {"round": 0})
    batch, plen, steps = 2, 16, 6
    got = serve.main(["--arch", "qwen1.5-0.5b", "--device", "cpu", "--checkpoint", path,
                      "--batch", str(batch), "--prompt-len", str(plen), "--tokens", str(steps)])
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab, (batch, plen)).astype(np.int32)
    want = j_generate(jmodel, jparams, jnp.asarray(prompts), steps=steps,
                      cache_len=plen + steps + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert "seq1:" in capsys.readouterr().out


def test_train_cli_checkpoint_loads_in_jax(tmp_path, monkeypatch):
    """``train --checkpoint`` at a tiny width writes the params in the JAX
    layout: JAX's ``load_checkpoint`` reads them into its own template."""
    tiny = ArchConfig(**MICRO | dict(vocab=512))
    monkeypatch.setattr(launch_train, "CHARLM_100M", tiny)
    path = os.path.join(tmp_path, "e2e.npz")
    monkeypatch.setattr("sys.argv", ["train", "--rounds", "2", "--device", "cpu", "--engine",
                                     "cohort", "--rr-backend", "device", "--checkpoint", path])
    launch_train.main()
    meta = load_metadata(path)
    assert meta["round"] == 1 and meta["name"] == "charlm-e2e"
    jparams = j_build_model(JArch(**MICRO | dict(vocab=512))).init(jax.random.PRNGKey(0))
    restored = j_ckpt.load_checkpoint(path, jparams)
    port = load_checkpoint(path, build_model(tiny).init(0, "cpu"))
    ours = dict(j_tree_paths(params_to_jax(port)))
    for k, v in j_tree_paths(restored):
        np.testing.assert_array_equal(np.asarray(v), ours[k], err_msg=k)
