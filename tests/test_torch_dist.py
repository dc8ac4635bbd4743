"""The mesh layer of the PyTorch port (``repro_torch.dist``, the mesh
builders of ``repro_torch.launch.mesh``, ``launch/specs.py`` with
``mesh=``, the dry run's per-card count) against the JAX package's
``repro.dist.sharding`` and ``repro.launch.specs``, on the CPU:

* JAX's four rule tests (``tests/test_dist.py``), case for case, against
  the port's ``param_spec``;
* for every arch, the port's spec of every parameter equals JAX's of the
  stacked leaf (less the layer axis), on a 16 x 16 and a 2 x 16 x 16 mesh,
  with ``fsdp`` None, ``("data",)`` and ``("pod", "data")``; the same for
  the batch, step-mask, meta, token and cache specs of the setups' leaves
  (JAX's setups built on a duck-typed mesh, their ``NamedSharding`` read
  for its spec);
* on a fake 16 x 16 process group, each DTensor's local shape is each
  global dim over the product of its axes' sizes;
* the twin of ``tests/test_dist.py::test_mesh_lower_compile_subprocess``:
  8 gloo ranks on a (4, 2) mesh run JAX's three reduced setups and
  Hymba's prefill (the flash and SSD wrappers on local head shards), and
  each output's ``full_tensor()`` equals the meshless step within
  ``DIST_TOL``; each rank's count is above 0; ``seq_over_model`` and
  ``opt_seq_shard`` change no value there;
* one gloo rank on a (1, 1) mesh: every family's prefill and decode
  bitwise the meshless step;
* the per-card count is one rank's share: a column-parallel product
  counts 1/16 of its FLOPs on the 16 x 16 mesh, a shard-to-shard move one
  all-to-all, a reduced TP step records
  all-reduces, a remat round counts there, and a meshless record is what
  it was.
"""
import functools
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

import repro.dist.sharding as j_sharding  # noqa: E402
import repro.launch.specs as j_specs  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.dist.sharding import param_spec as j_param_spec  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.dist.sharding import P, param_spec  # noqa: E402
from repro_torch.launch import dryrun, mesh  # noqa: E402
from repro_torch.launch.specs import make_setup  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils.pytree import wire_layout  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST_TOL = 1e-5   # fp32; the TP sums add their shards in another order than the meshless step


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Duck-typed mesh with named axis sizes (JAX's ``tests/test_dist.py``'s,
    with ``axis_names`` for JAX's setups)."""

    def __init__(self, **axes):
        self.shape = axes
        self.axis_names = tuple(axes)


MESH = FakeMesh(data=16, model=16)
POD_MESH = FakeMesh(pod=2, data=16, model=16)
MESH_CASES = [(MESH, None), (MESH, ("data",)), (POD_MESH, None), (POD_MESH, ("data",)),
              (POD_MESH, ("pod", "data"))]


def norm(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as its axis (JAX's
    ``PartitionSpec`` reads ``("data",)`` back as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def both(path, shape, mesh_=MESH, **kw):
    """The port's spec, checked equal to JAX's on the same input."""
    got = param_spec(path, shape, mesh_, **kw)
    assert isinstance(got, P) and norm(got) == norm(j_param_spec(path, shape, mesh_, **kw))
    return norm(got)


# ------------------------------------------------------------ JAX's rule tests


def test_tp_rules():
    assert both("blocks/attn/wq", (24, 1024, 2048)) == (None, None, "model")
    assert both("blocks/attn/wo", (24, 2048, 1024)) == (None, "model", None)
    assert both("blocks/mlp/gate", (24, 1024, 4096)) == (None, None, "model")
    assert both("embed", (152064, 8192)) == ("model", None)
    assert both("blocks/ln1/scale", (24, 1024)) == ()


def test_divisibility_fallback():
    # hymba vocab 32001 is not divisible by 16 -> replicate, all-None of its rank
    assert both("embed", (32001, 1600)) == (None, None)
    # 8 kv heads can't shard over 16 -> flat dim 8*128=1024 still divides
    assert both("blocks/attn/wk", (80, 8192, 1024)) == (None, None, "model")


def test_fsdp_rules():
    assert both("blocks/mlp/gate", (80, 8192, 29568), fsdp=("data",)) == \
        norm((None, ("data",), "model"))
    assert both("blocks/attn/wo", (80, 8192, 8192), fsdp=("data",)) == \
        norm((None, "model", ("data",)))
    assert both("embed", (152064, 8192), fsdp=("data",)) == norm(("model", ("data",)))


def test_expert_parallel_rules():
    assert both("blocks/moe/experts/gate", (61, 256, 7168, 2048)) == \
        (None, "model", None, None)
    assert both("blocks/moe/experts/down", (61, 256, 2048, 7168)) == \
        (None, "model", None, None)
    assert both("blocks/moe/experts/up", (61, 256, 7168, 2048), fsdp=("data",)) == \
        norm((None, "model", None, ("data",)))


# ------------------------------------------------ every leaf of every arch


@functools.cache
def jax_leaves(arch: str) -> dict:
    model = j_build_model(j_registry.get_arch(arch))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return {j_sharding._path_str(kp): tuple(x.shape)
            for kp, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@functools.cache
def port_leaves(arch: str) -> dict:
    return {k: tuple(v.shape)
            for k, v in build_model(registry.get_arch(arch)).init(0, "meta").items()}


@pytest.mark.parametrize("arch", registry.ASSIGNED)
def test_param_specs_equal_jax_every_leaf(arch):
    jl, pl = jax_leaves(arch), port_leaves(arch)
    layout = wire_layout(pl)
    assert {path for path, _ in layout} == set(jl)
    n = 0
    for mesh_, fsdp in MESH_CASES:
        for path, names in layout:
            want = norm(j_param_spec(path, jl[path], mesh_, fsdp=fsdp))
            stacked = names != [path]
            for name in names:
                got = norm(param_spec(name, pl[name], mesh_, fsdp=fsdp))
                # a stacked JAX leaf's spec has the layer axis first, unsharded
                assert (((None,) + got) if stacked and got else got) == want, \
                    (name, mesh_.shape, fsdp)
                n += 1
    assert n == len(pl) * len(MESH_CASES)


# ------------------------------------------------- the setups' other specs


@pytest.fixture(scope="module")
def production():
    """The port's production meshes over a fake process group, torn down
    after the module."""
    meshes = {mp: mesh.make_production_mesh(multi_pod=mp) for mp in (False, True)}
    yield meshes
    if dist.is_initialized():
        dist.destroy_process_group()


def jax_setup_specs(arch: str, shape_name: str, mesh_, monkeypatch):
    """JAX's ``make_setup`` on the duck-typed mesh, each ``NamedSharding``
    read as its spec."""
    for mod in (j_sharding, j_specs):
        monkeypatch.setattr(mod, "NamedSharding", lambda _mesh, spec: spec)
    return j_specs.make_setup(j_registry.get_arch(arch), j_registry.get_shape(shape_name),
                              mesh_).in_shardings


def _eq(p, j, where):
    assert norm(p) == norm(j), (where, p, j)


def compare_specs(kind: str, pspecs, jspecs) -> int:
    n = 0
    if kind == "train":
        pb, jb = pspecs[1], jspecs[1]
        assert set(pb.data) == set(jb.data)
        for k in jb.data:
            _eq(pb.data[k], jb.data[k], k)
        _eq(pb.step_mask, jb.step_mask, "step_mask")
        for f in jb.meta._fields:
            _eq(getattr(pb.meta, f), getattr(jb.meta, f), f)
        _eq(pspecs[0].rnd, jspecs[0].rnd, "rnd")
        _eq(pspecs[2], jspecs[2], "lr")
        assert set(pspecs[0].opt) == set(jspecs[0].opt)
        n = len(jb.data) + 1 + len(jb.meta._fields) + 2
    elif kind == "prefill":
        assert set(pspecs[1]) == set(jspecs[1])
        for k in jspecs[1]:
            _eq(pspecs[1][k], jspecs[1][k], k)
        n = len(jspecs[1])
    else:
        _eq(pspecs[1], jspecs[1], "token")
        jl = jspecs[2]["layers"]
        assert set(pspecs[2]["layers"]) == set(jl)
        for k in jl:
            _eq(pspecs[2]["layers"][k], jl[k], k)
        _eq(pspecs[2]["pos"], jspecs[2]["pos"], "pos")
        n = len(jl) + 2
    return n


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", registry.ASSIGNED)
def test_setup_specs_equal_jax(arch, multi_pod, production, monkeypatch):
    """The batch, step-mask, meta, lr, token and cache specs of every shape's
    setup on each mesh (the params' are held leaf by leaf above)."""
    pm = production[multi_pod]
    for shape_name in base.INPUT_SHAPES:
        shape = base.INPUT_SHAPES[shape_name]
        st = make_setup(registry.get_arch(arch), shape, mesh=pm, device="meta", backend="ref")
        assert st.inert == []
        js = jax_setup_specs(arch, shape_name, POD_MESH if multi_pod else MESH, monkeypatch)
        assert compare_specs(shape.kind, st.in_shardings, js) > 0, shape_name


def pairs(args, specs):
    """(tensor, spec) for each tensor leaf of a setup's args."""
    if isinstance(args, torch.Tensor):
        yield args, specs
    elif isinstance(args, dict):
        for k in args:
            yield from pairs(args[k], specs[k])
    elif isinstance(args, tuple):
        for a, s in zip(args, specs):
            yield from pairs(a, s)


def test_local_shapes_are_shares(production):
    """Each DTensor of a setup on the fake 16 x 16 group holds each global
    dim over the product of the sizes of the axes that shard it."""
    pm = production[False]
    sizes = dict(zip(pm.mesh_dim_names, pm.shape))
    n_sharded = 0
    for shape_name in ("train_4k", "decode_32k"):
        st = make_setup(registry.get_arch("qwen1.5-0.5b"), base.INPUT_SHAPES[shape_name],
                        mesh=pm, device="meta", backend="ref")
        for t, spec in pairs(st.args, st.in_shardings):
            local = t.to_local().shape
            for d, g in enumerate(t.shape):
                entry = spec[d] if d < len(spec) else None
                axes = (entry,) if isinstance(entry, str) else (entry or ())
                div = math.prod(sizes[a] for a in axes)
                assert local[d] == g // div, (spec, t.shape, local)
                n_sharded += div > 1
    assert n_sharded > 100


# ------------------------------------------------------------ the count


def test_count_is_one_ranks_share(production):
    """A column-parallel product counts 1/16 of its global FLOPs on the
    16 x 16 mesh; a reduced TP step records all-reduces; the meshless
    record keeps its one-card form."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    pm = production[False]
    x = torch.empty((64, 1024), device="meta")
    w = torch.empty((1024, 4096), device="meta")
    with FlopCounterMode(display=False) as fc:
        x @ w
    xd = distribute_tensor(x, pm, [Replicate(), Replicate()], src_data_rank=None)
    wd = distribute_tensor(w, pm, [Replicate(), Shard(1)], src_data_rank=None)
    with dryrun.LocalCount() as c:
        out = xd @ wd
    assert out.placements == (Replicate(), Shard(1))
    assert c.flops * 16 == fc.get_total_flops() > 0

    cfg = registry.get_arch("qwen1.5-0.5b").reduced(n_heads=16, n_kv_heads=16, head_dim=8)
    shape = base.ShapeConfig("t", 128, 32, "prefill")
    rec = dryrun.count_step(make_setup(cfg, shape, mesh=pm, device="meta", backend="ref"), pm)
    one = dryrun.count_step(make_setup(cfg, shape, device="meta", backend="ref"))
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert 0 < rec["cost"]["flops"] < one["cost"]["flops"] / 100
    assert "collectives" not in one and set(one) == {"cost", "memory"}


def test_shard_to_shard_counts_as_all_to_all(production):
    """DTensor moves a shard from one dim to another on the ``cpu``-typed
    production mesh by an all-gather and a chunk, as over gloo; the count
    records the one all-to-all NCCL runs instead, at its new shard's
    bytes, and nothing of the gather."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    pm = production[False]
    assert pm.device_type == "cpu"
    x = distribute_tensor(torch.empty((64, 128), device="meta"), pm, [Replicate(), Shard(0)],
                          src_data_rank=None)
    with dryrun.LocalCount() as c:
        y = x.redistribute(pm, [Replicate(), Shard(1)])
    assert y.to_local().shape == (64, 8)
    nonzero = {k: v for k, v in c.collectives.items() if v["count"]}
    assert nonzero == {"all-to-all": {"count": 1, "bytes": 64 * 8 * 4}}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen1.5-0.5b", "qwen2-72b"])
def test_remat_round_counts_on_the_mesh(arch, production):
    """A train round with ``remat="full"`` (its recompute under
    ``torch.func.vjp``, the vmapped cohort's under ``vmap`` too) counted on
    the 16 x 16 mesh: the layout steps' backward runs beneath functorch's
    wrappers.  Qwen2-72B's config sets remat and the sequential mode."""
    import dataclasses

    pm = production[False]
    cfg = dataclasses.replace(registry.get_arch(arch).reduced(), remat="full")
    st = make_setup(cfg, base.ShapeConfig("t", 64, 32, "train"), mesh=pm, device="meta",
                    backend="ref")
    rec = dryrun.count_step(st, pm)
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["total_bytes"] > 0


def test_meshless_record_is_unchanged(tmp_path):
    cfg = registry.get_arch("mamba2-1.3b").reduced()
    rec = dryrun.run_one("mamba2-1.3b", "decode_32k", out_dir=str(tmp_path), cfg=cfg, batch=2)
    assert rec["ok"] and rec["mesh"] == "1xH100" and rec["chips"] == 1
    assert rec["collectives"] == {"total_bytes": 0, "reason": "one card"}
    assert json.load(open(tmp_path / "mamba2-1.3b_decode_32k_1xH100.json")) == rec


# ------------------------------------------------- 8 gloo ranks on (4, 2)

WORKER = textwrap.dedent("""
    import json, sys, dataclasses
    sys.path.insert(0, "src")
    import torch
    import torch.distributed as dist
    from torch.utils._pytree import tree_flatten
    torch.set_num_threads(1)
    rank, store_path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 8), rank=rank,
                            world_size=8)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.dryrun import LocalCount
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import make_setup
    mesh = make_host_mesh(4, 2)
    CASES = [("qwen1.5-0.5b", "train", 64, 8, {}),
             ("mamba2-1.3b", "decode", 128, 8, {}),
             ("deepseek-v2-lite-16b", "prefill", 128, 8, {}),
             ("hymba-1.5b", "prefill", 128, 8, {}),
             ("qwen1.5-0.5b", "prefill", 128, 8, {"seq_over_model": True}),
             ("hymba-1.5b", "prefill", 128, 8, {"opt_seq_shard": True})]
    res = {}
    for arch, kind, seq, gb, kw in CASES:
        cfg = get_arch(arch).reduced()
        if kw.pop("opt_seq_shard", False):
            cfg = dataclasses.replace(cfg, opt_seq_shard=True)
        shape = ShapeConfig("t", seq, gb, kind)
        extra = {"dp": 4} if kind == "train" else {}
        plain = make_setup(cfg, shape, device="cpu", **extra, **kw)
        ref = [t for t in tree_flatten(plain.fn(*plain.args))[0] if torch.is_tensor(t)]
        st = make_setup(cfg, shape, mesh=mesh, device="cpu", **kw)
        with LocalCount() as c:
            got = [t for t in tree_flatten(st.fn(*st.args))[0] if torch.is_tensor(t)]
        got = [t.full_tensor() if hasattr(t, "full_tensor") else t for t in got]
        errs = [float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
                for a, b in zip(ref, got)]
        res[f"{arch}/{kind}/{sorted(kw)}/{cfg.opt_seq_shard}"] = {
            "n": [len(ref), len(got)], "err": max(errs),
            "scale": max(float(a.double().abs().max()) for a in ref if a.numel()),
            "shapes": [list(a.shape) == list(b.shape) for a, b in zip(ref, got)],
            "flops": c.flops, "inert": st.inert,
            "coll": sum(v["count"] for v in c.collectives.values())}
    if rank == 0:
        json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


def test_mesh_run_equals_meshless_subprocess(tmp_path):
    """8 gloo ranks (a ``FileStore`` under ``tmp_path``, no port) on a
    (4, 2) ``("data", "model")`` mesh: JAX's three reduced setups
    (Qwen1.5-0.5B train 64/8, Mamba2 decode 128/8, DeepSeek-V2-Lite
    prefill 128/8), Hymba's prefill, and the prefill levers; every output
    equal to the meshless step's within ``DIST_TOL`` (relative to its
    largest magnitude), each rank's count above 0."""
    store, out = tmp_path / "store", tmp_path / "out.json"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(store), str(out)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(8)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-4000:]
    res = json.loads(out.read_text())
    assert len(res) == 6
    for name, r in res.items():
        assert r["n"][0] == r["n"][1] > 0 and all(r["shapes"]), name
        assert r["err"] <= DIST_TOL * max(1.0, r["scale"]), (name, r)
        assert r["flops"] > 0 and r["inert"] == [], name
    assert all(r["coll"] > 0 for r in res.values())


ONE_RANK = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "src")
    import torch
    import torch.distributed as dist
    from torch.utils._pytree import tree_flatten
    torch.set_num_threads(1)
    store_path, out = sys.argv[1], sys.argv[2]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 1), rank=0, world_size=1)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import make_setup
    mesh = make_host_mesh(1, 1)
    res = {}
    for arch in ("qwen1.5-0.5b", "llava-next-mistral-7b", "hymba-1.5b", "mamba2-1.3b",
                 "seamless-m4t-medium", "deepseek-v2-lite-16b"):
        for kind in ("prefill", "decode"):
            cfg, shape = get_arch(arch).reduced(), ShapeConfig("t", 128, 8, kind)
            plain = make_setup(cfg, shape, device="cpu")
            ref = [t for t in tree_flatten(plain.fn(*plain.args))[0] if torch.is_tensor(t)]
            st = make_setup(cfg, shape, mesh=mesh, device="cpu")
            got = [t for t in tree_flatten(st.fn(*st.args))[0] if torch.is_tensor(t)]
            got = [t.full_tensor() if hasattr(t, "full_tensor") else t for t in got]
            res[f"{arch}/{kind}"] = [len(ref) == len(got) > 0] + [
                torch.equal(a, b) for a, b in zip(ref, got)]
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


def test_one_rank_mesh_is_bitwise_subprocess(tmp_path):
    """On a one-rank (1, 1) mesh every placement is ``Replicate``, so each
    family's prefill and decode over DTensors run the meshless ops: every
    output bitwise the meshless step's (the decode's output projection
    included, ``models/attention.py:_out_proj``)."""
    out = tmp_path / "out.json"
    r = subprocess.run([sys.executable, "-c", ONE_RANK, str(tmp_path / "store"), str(out)],
                       cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    res = json.loads(out.read_text())
    assert len(res) == 12
    assert all(all(v) for v in res.values()), res
