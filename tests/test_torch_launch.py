"""The launch tools of the PyTorch port (``repro_torch.launch.{mesh,specs,
dryrun,roofline,hillclimb}``, ``MeshConfig``, ``RunConfig``, ``ASSIGNED``)
against the JAX package's, on the CPU:

* ``MeshConfig``, ``RunConfig`` and ``ASSIGNED`` equal JAX's;
* every setup's arguments, leaf by leaf, in shape and dtype, against
  ``jax.eval_shape``'s of JAX's ``Setup`` on ``make_host_mesh(1, 1)`` (one
  client: dp = 1), through the JAX leaf layout of ``utils.pytree.wire_layout``
  (the one ``weights.py`` maps): the four shapes for the reduced config of
  every family, and full-size Qwen1.5-0.5B and Hymba-1.5B;
* the dry run's counted ``flops`` against the matmul FLOPs of JAX's program
  (each ``dot_general`` of ``jax.make_jaxpr`` of the setup's fn at 2 x its
  output x its contraction, a ``scan`` body times its length, into ``jit``
  and ``checkpoint`` bodies): equal, but for the products the two programs
  do differently, each named in ``named_products`` with its exact count;
* ``flops_kernel``'s attention band and the backward factor it assumes;
  ``bytes_min``;
* ``roofline``'s merge and order of records against JAX's on the same
  synthetic records, and ``hillclimb``'s ``PAIRS`` and ``_resolve``.

The shapes are the assigned ones (one client: a train setup's local batch
is the whole global batch, or a quarter of it for each of the sequential
mode's four), but for the moe family, cut on both sides alike to one
sequence and its prefill to 4,096 tokens: the port's dispatch runs a group
at a time on the host, so its count costs time in proportion to the tokens.
"""
import dataclasses
import functools
import json
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.extend import core as jcore  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.launch import hillclimb as j_hillclimb  # noqa: E402
from repro.launch import roofline as j_roofline  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.specs import make_setup as j_make_setup  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun, hillclimb, mesh, roofline  # noqa: E402
from repro_torch.launch.dryrun import band_pairs  # noqa: E402
from repro_torch.launch.specs import decode_cache_len, make_setup  # noqa: E402
from repro_torch.models.mamba2 import dims as ssm_dims  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402
from repro_torch.utils.pytree import wire_layout  # noqa: E402

FAMILIES = {"dense": "qwen1.5-0.5b", "vlm": "llava-next-mistral-7b",
            "moe": "deepseek-v2-lite-16b", "ssm": "mamba2-1.3b", "hybrid": "hymba-1.5b",
            "audio": "seamless-m4t-medium"}
SHAPES = tuple(base.INPUT_SHAPES)
MOE_PREFILL_SEQ = 4096


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cut_shape(shape_name: str, family: str):
    """Both packages' ShapeConfig of ``shape_name``; for the moe family at a
    global batch of 1 and its prefill at ``MOE_PREFILL_SEQ`` tokens (the
    port's dispatch runs a group at a time on the host, so its count takes
    time in proportion to the tokens; the other families' does not)."""
    kw = {}
    if family == "moe":
        kw["global_batch"] = 1
        if shape_name == "prefill_32k":
            kw["seq_len"] = MOE_PREFILL_SEQ
    return (dataclasses.replace(j_base.INPUT_SHAPES[shape_name], **kw),
            dataclasses.replace(base.INPUT_SHAPES[shape_name], **kw))


def configs(arch: str, full: bool):
    j = j_registry.get_arch(arch)
    p = registry.get_arch(arch)
    return (j, p) if full else (j.reduced(), p.reduced())


@functools.cache
def setups(family: str, arch: str, shape_name: str, full: bool = False):
    """(JAX's Setup on a one-client host mesh, the port's on the meta
    device, the port's config and shape), shared by the tests below."""
    jcfg, pcfg = configs(arch, full)
    jshape, pshape = cut_shape(shape_name, family)
    return (j_make_setup(jcfg, jshape, make_host_mesh(1, 1)),
            make_setup(pcfg, pshape, device="meta", backend="ref", dp=1), pcfg, pshape)


# ------------------------------------------------------------------ configs


def test_mesh_and_run_config_equal_jax():
    for j_cls, p_cls in ((j_base.MeshConfig, base.MeshConfig), (j_base.RunConfig, base.RunConfig)):
        assert [(f.name, str(f.type)) for f in dataclasses.fields(j_cls)] == \
            [(f.name, str(f.type)) for f in dataclasses.fields(p_cls)]
    for mp in (False, True):
        j, p = j_base.MeshConfig(mp), base.MeshConfig(mp)
        assert (j.multi_pod, j.shape, j.axes) == (p.multi_pod, p.shape, p.axes)
    j, p = dataclasses.asdict(j_base.RunConfig()), dataclasses.asdict(base.RunConfig())
    # FLConfig's one default of its own (configs/base.py): the kernel's name
    assert (j["fl"].pop("uplink_backend"), p["fl"].pop("uplink_backend")) == ("ref", "kernel")
    assert j == p
    data_axes = base.MeshConfig().shape[base.MeshConfig().axes.index("data")]
    assert dryrun.PRODUCTION_DP == data_axes == 16


def test_assigned_equals_jax():
    assert registry.ASSIGNED == j_registry.ASSIGNED
    assert all(a in registry.ARCHS for a in registry.ASSIGNED)


def test_h100_peaks_are_one_table():
    assert (mesh.BF16_FLOP_PER_S, mesh.HBM_BYTES_PER_S) == (989e12, 3.35e12)
    assert mesh.dp_size(3) == 3
    with pytest.raises(ValueError):
        mesh.dp_size(0)


# ------------------------------------------------------------ setup shapes


def _leaf(x):
    return tuple(int(s) for s in x.shape), np.dtype(x.dtype).name


def _port_leaf(t):
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


def params_layout(flat: dict) -> dict:
    """A port param tree's leaves in the JAX layout: path -> (shape, dtype),
    a stacked leaf ``[L, ...]``."""
    out = {}
    for path, names in wire_layout(flat):
        shape, dt = _port_leaf(flat[names[0]])
        out[path] = (((len(names),) + shape) if names != [path] else shape, dt)
    return out


def jax_layout(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in kp): _leaf(x)
            for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def compare_args(kind: str, jargs, pargs) -> int:
    """Assert every leaf equal in shape and dtype -> the leaves compared."""
    n = 0

    def same(j, p, where):
        nonlocal n
        assert j == p, where
        n += len(j)

    if kind == "train":
        js, jb, jlr = jargs
        ps, pb, plr = pargs
        same(jax_layout(js.params), params_layout(ps.params), "params")
        assert set(js.opt) == set(ps.opt)
        for k in js.opt:
            same(jax_layout(js.opt[k]), params_layout(ps.opt[k]), f"opt/{k}")
        same({k: _leaf(v) for k, v in jb.data.items()},
             {k: _port_leaf(v) for k, v in pb.data.items()}, "data")
        same({"m": _leaf(jb.step_mask)}, {"m": _port_leaf(pb.step_mask)}, "step_mask")
        same({f: _leaf(getattr(jb.meta, f)) for f in jb.meta._fields},
             {f: _port_leaf(getattr(pb.meta, f)) for f in pb.meta._fields}, "meta")
        same({"lr": _leaf(jlr)}, {"lr": _port_leaf(plr)}, "lr")
    elif kind == "prefill":
        same(jax_layout(jargs[0]), params_layout(pargs[0]), "params")
        same(jax_layout(jargs[1]), {k: _port_leaf(v) for k, v in pargs[1].items()}, "batch")
    else:
        same(jax_layout(jargs[0]), params_layout(pargs[0]), "params")
        same({"t": _leaf(jargs[1])}, {"t": _port_leaf(pargs[1])}, "token")
        same(jax_layout(jargs[2]["layers"]),
             {k: _port_leaf(v) for k, v in pargs[2]["layers"].items()}, "cache")
        assert _leaf(jargs[2]["pos"])[0] == () and isinstance(pargs[2]["pos"], int)
    return n


SETUP_CASES = [(f, FAMILIES[f], s, False) for f in FAMILIES for s in SHAPES] + \
    [("full", a, s, True) for a in ("qwen1.5-0.5b", "hymba-1.5b") for s in SHAPES]


@pytest.mark.parametrize("family,arch,shape_name,full", SETUP_CASES,
                         ids=[f"{a}{'-full' if full else ''}-{s}"
                              for _, a, s, full in SETUP_CASES])
def test_setup_args_equal_jax(family, arch, shape_name, full):
    jst, pst, _, pshape = setups(family, arch, shape_name, full)
    assert pst.name == jst.name and pst.in_shardings is None
    assert compare_args(pshape.kind, jst.args, pst.args) > 0
    assert all(t.device.type == "meta" for t in dryrun._tensors(pst.args))


def test_long_context_ring_reads_serve_window_long():
    """``long_500k``: a ring of ``serve_window_long`` for the quadratic
    families, the whole context for the ssm and hybrid ones (JAX's rule)."""
    S = base.INPUT_SHAPES["long_500k"].seq_len
    for arch in registry.ASSIGNED:
        cfg = registry.get_arch(arch)
        ring, slots = decode_cache_len(cfg, S)
        assert ring == (cfg.family in ("dense", "vlm", "moe", "audio"))
        assert slots == (cfg.serve_window_long if ring else S)
        assert decode_cache_len(cfg, 32768) == (False, 32768)
    cfg = dataclasses.replace(registry.get_arch("qwen1.5-0.5b").reduced(), serve_window_long=96)
    st = make_setup(cfg, base.INPUT_SHAPES["long_500k"], device="meta")
    assert st.args[2]["layers"]["k"].shape[2] == 96 and st.args[2]["pos"] == S - 1
    assert st.fn.keywords == {"ring": True}


def test_cuts_are_recorded():
    cfg = registry.get_arch("hymba-1.5b")
    st = make_setup(cfg, base.INPUT_SHAPES["train_4k"], device="meta", dp=1, batch=1,
                    n_layers=4)
    assert st.reduced == ["n_layers 4 of 32", "batch 1 x 1 of 256"]
    assert st.args[1].data["tokens"].shape == (1, 1, 1, 4097)
    st = make_setup(cfg, base.INPUT_SHAPES["prefill_32k"], device="meta", batch=2,
                    seq_over_model=True)
    assert st.reduced == ["batch 2 of 32"] and st.inert == ["seq_over_model"]
    with pytest.raises(ValueError):
        make_setup(cfg, base.INPUT_SHAPES["train_4k"], device="meta", dp=1, batch=300)


# --------------------------------------------------------------- the count


def _jaxprs(v):
    if isinstance(v, jcore.ClosedJaxpr):
        yield v.jaxpr
    elif isinstance(v, jcore.Jaxpr):
        yield v
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _jaxprs(x)


def jaxpr_dot_flops(jaxpr) -> int:
    """2 x output x contraction for each ``dot_general``; a scan body times
    its length; other sub-jaxprs (``jit``, ``checkpoint``, custom rules)
    once.  A ``cond``, a ``while`` or a collective would need more, and
    raises."""
    total = 0
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            k = math.prod(e.invars[0].aval.shape[i] for i in lc)
            total += 2 * math.prod(e.outvars[0].aval.shape) * k
            continue
        subs = [j for v in e.params.values() for j in _jaxprs(v)]
        if not subs:
            continue
        if name in ("cond", "while"):
            raise NotImplementedError(f"no count rule for {name}")
        mult = e.params["length"] if name == "scan" else 1
        total += mult * sum(jaxpr_dot_flops(j) for j in subs)
    return total


def named_products(cfg, shape, setup) -> dict:
    """The products the two programs do differently, port minus JAX, each
    counted exactly (2 a multiply-add):

    * ``onehot_embed``: the port's train loss looks its token embeddings up
      as ``one_hot(tokens) @ embed`` (``models/model.py:onehot_lookup``;
      JAX gathers): the product and the table's gradient; with ``mtp`` the
      MTP block's lookup of the next tokens too;
    * ``aggregate``: JAX sums the vmapped cohort's [C] stack as a
      ``dot_general`` over C (``weighted_sum``), the port as a product and
      a sum: 2 C a parameter;
    * ``ssd_state``: JAX's three-operand einsum of a chunk's state
      (``bqn,bqh,bqhp->bhpn``) takes decay x x as a ``dot_general`` without
      contraction, the port as an elementwise product: 2 T H P a layer, and
      its two backward products with gradients;
    * ``ssd_decode_state``: JAX's decode step forms dt x x (outer) B
      (``bn,bhp->bhpn``) as a ``dot_general``, the port elementwise;
    * ``cross_dead_kv``: JAX's cross-attention projects the decoder's own K
      and V and drops them (``gqa_decode``'s ``_qkv``; dead code that XLA
      removes); the port does not form them;
    * ``remat_last``: with ``remat="full"`` JAX's recompute drops the
      layer's last product (the MLP's down projection, whose output feeds
      no gradient); the port's recompute (``torch.func.vjp`` of the whole
      layer) runs it;
    * ``one_token_dispatch``: the moe decode's dispatch einsum over a group
      of one token contracts one element, which ``torch.einsum`` takes as an
      elementwise product (JAX: a ``dot_general``).
    """
    out = {}
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    if shape.kind == "train":
        state, rb, _ = setup.args
        C, _, B, tp1 = rb.data["tokens"].shape
        T = tp1 - 1
        out["onehot_embed"] = 2 * 2 * C * B * T * V * D
        if cfg.mtp:
            out["onehot_embed"] += 2 * 2 * C * B * (T - 1) * V * D
        if cfg.name not in ("qwen2-72b", "deepseek-v3-671b"):       # the vmapped mode
            out["aggregate"] = -2 * C * sum(v.numel() for v in state.params.values())
        if cfg.family in ("ssm", "hybrid"):
            _, H, P, _ = ssm_dims(cfg)
            out["ssd_state"] = -3 * 2 * C * B * shape.seq_len * H * P * L
        if cfg.remat == "full":
            assert cfg.family == "dense"
            out["remat_last"] = 2 * C * B * T * cfg.d_ff * D * L
    elif shape.kind == "prefill":
        B = shape.global_batch
        if cfg.family in ("ssm", "hybrid"):
            _, H, P, _ = ssm_dims(cfg)
            out["ssd_state"] = -2 * B * shape.seq_len * H * P * L
        if cfg.family == "audio":
            out["cross_dead_kv"] = -2 * 2 * B * shape.seq_len * D * cfg.n_kv_heads * cfg.hd() * L
    else:
        B = shape.global_batch
        if cfg.family in ("ssm", "hybrid"):
            _, H, P, N = ssm_dims(cfg)
            out["ssd_decode_state"] = -2 * B * H * P * N * L
        if cfg.family == "audio":
            out["cross_dead_kv"] = -2 * 2 * B * D * cfg.n_kv_heads * cfg.hd() * L
        if cfg.family == "moe" and B == 1:
            m = cfg.moe
            out["one_token_dispatch"] = -2 * m.num_experts * capacity(cfg, 1) * D * L
    return out


FLOP_CASES = [(f, FAMILIES[f], s) for f in FAMILIES for s in SHAPES] + \
    [("dense", "qwen2-72b", "train_4k")]


@pytest.mark.parametrize("family,arch,shape_name", FLOP_CASES,
                         ids=[f"{a}-{s}" for _, a, s in FLOP_CASES])
def test_counted_flops_equal_jax_matmuls(family, arch, shape_name):
    jst, pst, pcfg, pshape = setups(family, arch, shape_name)
    want = jaxpr_dot_flops(jax.make_jaxpr(jst.fn)(*jst.args).jaxpr)
    got = dryrun.count_step(pst)["cost"]["flops"]
    named = named_products(pcfg, pshape, pst)
    assert got == want + sum(named.values()), (got, want, named)


def test_kernel_count_takes_the_band():
    """``flops_kernel`` of a prefill: the plain count less each attention
    block's products over the pairs its mask drops, 4 B H hd a pair."""
    cfg = registry.get_arch("hymba-1.5b").reduced()
    T, W = 4096, cfg.sliding_window
    shape = dataclasses.replace(base.INPUT_SHAPES["prefill_32k"], seq_len=T, global_batch=2)
    cost = dryrun.count_step(make_setup(cfg, shape, device="meta", backend="ref"))["cost"]
    per_pair = 4 * 2 * cfg.n_heads * cfg.hd() * cfg.n_layers
    assert cost["attention_flops_masked"] == per_pair * (T * T - band_pairs(0, T, 0, T,
                                                                            window=W))
    assert cost["flops_kernel"] == cost["flops"] - cost["attention_flops_masked"]


@pytest.mark.parametrize("mode", ("vmapped", "sequential"))
def test_kernel_count_backward_factor(mode):
    """The masked pairs' products of a train step (x3 with the backward; x4
    with remat's recompute) against the counted flops: the banded loss
    scores fewer keys of the same band, so the counted flops fall by
    exactly the masked products' difference and ``flops_kernel`` stays."""
    shape = dataclasses.replace(base.INPUT_SHAPES["train_4k"], global_batch=2, seq_len=3072)
    cost = {}
    for name, ov in (("plain", {}), ("banded", {"opt_banded_window": True}),
                     ("remat", {"remat": "full"}),
                     ("remat_banded", {"remat": "full", "opt_banded_window": True})):
        cfg = registry.get_arch("qwen1.5-0.5b").reduced(sliding_window=64, **ov)
        st = make_setup(cfg, shape, device="meta", dp=2, cohort_mode=mode)
        cost[name] = dryrun.count_step(st)["cost"]
    for full, banded in (("plain", "banded"), ("remat", "remat_banded")):
        f, b = cost[full], cost[banded]
        assert f["flops"] - b["flops"] == \
            f["attention_flops_masked"] - b["attention_flops_masked"] > 0
        assert f["flops_kernel"] == b["flops_kernel"] < f["flops"]
    assert cost["remat"]["attention_flops_masked"] == \
        cost["plain"]["attention_flops_masked"] * 4 // 3


def test_bytes_min_reads_and_writes_each_storage_once():
    cfg = registry.get_arch("qwen1.5-0.5b").reduced()
    st = make_setup(cfg, dataclasses.replace(base.INPUT_SHAPES["decode_32k"], global_batch=2),
                    device="meta")
    rec = dryrun.count_step(st)
    params, token, cache = st.args
    arg = sum(t.numel() * t.element_size()
              for t in [*params.values(), token, *cache["layers"].values()])
    logits = 2 * 1 * cfg.vocab * 4
    assert rec["memory"]["argument_size_in_bytes"] == arg
    assert rec["memory"]["output_size_in_bytes"] == logits      # the cache is written in place
    assert rec["cost"]["bytes_min"] == arg + logits
    assert rec["cost"]["bytes_unfused"] > rec["cost"]["bytes_min"]


def test_run_one_writes_a_record(tmp_path):
    cfg = registry.get_arch("mamba2-1.3b").reduced()
    rec = dryrun.run_one("mamba2-1.3b", "decode_32k", out_dir=str(tmp_path), cfg=cfg, batch=2,
                         tag="t")
    assert rec["ok"] and rec["collectives"] == {"total_bytes": 0, "reason": "one card"}
    assert rec["reduced"] == ["batch 2 of 128"] and rec["memory"]["temp_size_in_bytes"] is None
    on_disk = json.loads((tmp_path / "mamba2-1.3b_decode_32k_1xH100_t.json").read_text())
    assert on_disk["cost"] == rec["cost"]
    bad = dryrun.run_one("mamba2-1.3b", "decode_32k", out_dir=str(tmp_path), cfg=cfg, n_layers=9)
    assert not bad["ok"] and "traceback" in bad


# ---------------------------------------------------------------- roofline


def synthetic_records() -> list[dict]:
    """Records both packages' ``analyze_record`` read: JAX's cost keys and
    the port's, two meshes, tags (baseline, the preferred exact tag,
    hillclimb iterations) and a failed record."""
    recs = []
    for i, (arch, shape, mesh_name, tag) in enumerate([
            ("qwen1.5-0.5b", "train_4k", "16x16", ""),
            ("qwen1.5-0.5b", "train_4k", "16x16", "unrolled"),
            ("hymba-1.5b", "prefill_32k", "16x16", ""),
            ("hymba-1.5b", "train_4k", "16x16", "it2-remat"),
            ("hymba-1.5b", "train_4k", "16x16", "it1-banded"),
            ("hymba-1.5b", "train_4k", "16x16", ""),
            ("mamba2-1.3b", "decode_32k", "2x16x16", ""),
            ("chatglm3-6b", "long_500k", "16x16", "")]):
        recs.append({"arch": arch, "shape": shape, "mesh": mesh_name,
                     "multi_pod": mesh_name == "2x16x16", "tag": tag, "ok": True,
                     "cost": {"flops": 1e12 * (i + 1), "bytes accessed": 3e9 * (8 - i),
                              "flops_kernel": 0.5e12 * (i + 1), "bytes_min": 2e9 * (8 - i)},
                     "memory": {"temp_size_in_bytes": 2**30 * i,
                                "argument_size_in_bytes": 2**20 * i},
                     "collectives": {"total_bytes": 1e8 * i}})
    recs.append({"arch": "qwen1.5-0.5b", "shape": "decode_32k", "mesh": "16x16", "ok": False})
    return recs


def test_roofline_merges_and_orders_as_jax(tmp_path):
    for i, rec in enumerate(synthetic_records()):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
    want = j_roofline.load_all(str(tmp_path))
    got = roofline.load_all(str(tmp_path))
    key = ("arch", "shape", "mesh", "tag", "exact")
    assert [tuple(r[k] for k in key) for r in got] == [tuple(r[k] for k in key) for r in want]
    for g, w in zip(got, want):
        assert (g["params_total"], g["params_active"], g["model_flops"]) == \
            (w["params_total"], w["params_active"], w["model_flops"])
        assert g["t_compute_s"] == g["flops_kernel"] / mesh.BF16_FLOP_PER_S
        assert g["t_memory_s"] == g["bytes_min"] / mesh.HBM_BYTES_PER_S
        assert g["dominant"] == max(("compute", "memory"),
                                    key=lambda t: g[f"t_{t}_s"])
        assert g["useful_ratio"] == g["model_flops"] / g["flops"]
        assert g["chips"] == 1
    for x in (2.5, 0.0042, 3.1e-5):
        assert roofline.fmt_s(x) == j_roofline.fmt_s(x)
    table = roofline.markdown_table(got).splitlines()
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in table[0]
    rows = [ln for ln in table if ln.startswith("| ") and "arch" not in ln]
    assert [r.split(" | ")[:3] for r in rows] == \
        [ln.split(" | ")[:3] for ln in j_roofline.markdown_table(want).splitlines()[2:]]


# --------------------------------------------------------------- hillclimb


def test_hillclimb_pairs_and_resolve_equal_jax(monkeypatch):
    assert hillclimb.PAIRS == j_hillclimb.PAIRS
    for arch, _, iters in hillclimb.PAIRS.values():
        for tag, overrides, _ in iters:
            assert dataclasses.asdict(hillclimb._resolve(arch, overrides)) == \
                dataclasses.asdict(j_hillclimb._resolve(arch, overrides)), tag
    runs = []
    monkeypatch.setattr(dryrun, "run_one", lambda *a, **kw: runs.append((a, kw)))
    hillclimb.main(["--pair", "deepseek", "--out", "unused"])
    assert [kw["tag"] for _, kw in runs] == [t for t, _, _ in hillclimb.PAIRS["deepseek"][2]]
    assert all(a == ("deepseek-v3-671b", "prefill_32k") and kw["mesh"] == "16x16"
               for a, kw in runs)
    assert runs[-1][1]["setup_kwargs"] == {"seq_over_model": True}
