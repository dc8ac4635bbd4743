"""The PyTorch port's serving path (``Model.prefill`` / ``decode_step`` and
``launch/serve.py:generate``) against the JAX package's, on
``hymba-1.5b.reduced(n_kv_heads=2)`` (the hybrid family: window 64, SSD
chunk 32, groups of 2 heads), ``qwen1.5-0.5b.reduced()`` (dense, QKV
bias, tied embeddings), ``seamless-m4t-medium.reduced()`` (the audio
encoder-decoder: 2 + 2 layers, sinusoidal positions, 32 frames from numpy
seed 3, so the decoder's cross-attention has Tq 128 > Tk 32),
``mamba2-1.3b.reduced()`` (the ssm family: 4 SSD chunks of 32, no
positions), ``minicpm-2b.reduced()`` (tied embeddings),
``chatglm3-6b.reduced()`` (the "half" RoPE, groups of 2 heads, QKV bias)
and ``qwen2-72b.reduced()`` (theta 1e6, QKV bias), all fp32, T = 128
prompts (past the window).

* ``params_from_jax`` carries the JAX tree across (``enc_blocks`` too; a
  bf16 one with its fp32 SSD leaves); ``cache_from_jax`` a cache (``xk``
  and ``xv`` too);
* the prefill's last logits and every cache entry, three decode steps, the
  ring-cache twin of ``test_sliding_window_ring_decode_matches_windowed_
  forward``, and greedy ``generate`` tokens vs JAX's: atol 2e-5 / rtol 2e-4
  (fp32; the plain flash version keeps its probabilities in fp32 and both
  frameworks sum in their own order), tokens exactly;
* the serve CLI on ``--device cpu``; sampling from an explicit generator;
* ``backend="kernel"`` on CPU tensors takes the plain versions (no launch),
  the registry serves every arch (the moe family's, the vlm ones and the
  rest of the zoo) as the JAX config, field for field, with JAX's
  ``param_counts``; ``FLConfig()`` and ``INPUT_SHAPES`` are JAX's; the
  prefill's kernels are never reached under autograd; a dense config with a sliding window is served
  as JAX serves it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import FLConfig as JFL  # noqa: E402
from repro.configs.registry import ARCHS as J_ARCHS  # noqa: E402
from repro.configs.registry import get_shape as j_get_shape  # noqa: E402
from repro.launch.roofline import param_counts as j_param_counts  # noqa: E402
from repro.launch.serve import generate as j_generate  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, FLConfig, MLAConfig,  # noqa: E402
                                      MoEConfig, SSMConfig)
from repro_torch.configs.registry import ARCHS as PORT_ARCHS  # noqa: E402
from repro_torch.configs.registry import get_arch, get_shape  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel  # noqa: E402
from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_kernel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.roofline import param_counts, tokens_for  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.weights import cache_from_jax, params_from_jax  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-4)
ARCH_KW = {"hymba-1.5b": dict(n_kv_heads=2), "qwen1.5-0.5b": {}, "seamless-m4t-medium": {},
           "mamba2-1.3b": {}, "minicpm-2b": {}, "chatglm3-6b": {}, "qwen2-72b": {}}
B, T, EXTRA = 2, 128, 3


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
    for name, kind in (("ssm", SSMConfig), ("moe", MoEConfig), ("mla", MLAConfig)):
        if d.get(name) is not None:
            d[name] = kind(**d[name])
    return ArchConfig(**d)


class Setup:
    def __init__(self, arch):
        self.jcfg = J_ARCHS[arch].reduced(**ARCH_KW[arch])
        self.jmodel = j_build(self.jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(0))
        self.cfg = port_cfg(self.jcfg)
        self.model = build_model(self.cfg)
        self.params = params_from_jax(jax.tree.map(np.asarray, self.jparams), self.cfg, "cpu")
        self.toks = np.random.default_rng(1).integers(
            0, self.cfg.vocab, (B, T + EXTRA)).astype(np.int32)
        # the audio family's frame embeddings, for both prefills
        self.frames = ({"frames": np.random.default_rng(3).normal(
            size=(B, self.cfg.src_frames, self.cfg.d_model)).astype(np.float32)}
            if self.cfg.family == "audio" else {})
        self.cache_len = T + EXTRA + 2
        self.jprefill = jax.jit(lambda p, b, n=self.cache_len: self.jmodel.prefill(p, b, n))
        self.jdecode = jax.jit(self.jmodel.decode_step)


def _torch(arrays: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.fixture(scope="module", params=list(ARCH_KW))
def setup(request):
    return Setup(request.param)


def test_port_config_matches_registry(setup):
    assert setup.cfg == get_arch(setup.cfg.name).reduced(**ARCH_KW[setup.cfg.name])


def test_params_from_jax_carries_every_leaf(setup):
    jflat = jax.tree_util.tree_flatten_with_path(setup.jparams)[0]
    n_blocks = sum(1 for path, _ in jflat if path[0].key == "blocks")
    n_enc = sum(1 for path, _ in jflat if path[0].key == "enc_blocks")
    assert (n_enc > 0) == (setup.cfg.family == "audio")
    assert len(setup.params) == (len(jflat) + (setup.cfg.n_layers - 1) * n_blocks
                                 + (setup.cfg.enc_layers - 1) * n_enc)
    assert setup.params.keys() == setup.model.init(0, "meta").keys()
    for k, v in setup.model.init(0, "meta").items():
        assert setup.params[k].shape == v.shape and setup.params[k].dtype == v.dtype, k


def test_params_from_jax_bf16_tree_keeps_fp32_leaves():
    jcfg = J_ARCHS["hymba-1.5b"].reduced(dtype="bfloat16")
    jp = j_build(jcfg).init(jax.random.PRNGKey(0))
    p = params_from_jax(jax.tree.map(np.asarray, jp), port_cfg(jcfg), "cpu")
    assert p["blocks/1/attn/wq"].dtype == torch.bfloat16
    assert p["blocks/1/mixer/gate_norm/scale"].dtype == torch.bfloat16
    for leaf in ("mixer/A_log", "mixer/dt_bias", "mixer/D", "branch_scale"):
        assert p[f"blocks/1/{leaf}"].dtype == torch.float32, leaf
    assert p["blocks/0/branch_scale"].shape == (2,)
    np.testing.assert_array_equal(
        p["blocks/1/mixer/in_proj"].float().numpy(),
        np.asarray(jp["blocks"]["mixer"]["in_proj"][1], np.float32))


def test_prefill_and_decode_match_jax(setup):
    s = setup
    jl, jc = s.jprefill(s.jparams, {"tokens": s.toks[:, :T], **s.frames})
    with torch.inference_mode():
        lg, cache = s.model.prefill(s.params, {"tokens": torch.from_numpy(s.toks[:, :T]),
                                               **_torch(s.frames)}, s.cache_len)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    want = cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert cache["pos"] == want["pos"] == T
    assert cache["layers"].keys() == want["layers"].keys()
    for k, v in want["layers"].items():
        assert cache["layers"][k].shape == v.shape and cache["layers"][k].dtype == v.dtype, k
        np.testing.assert_allclose(cache["layers"][k].numpy(), v.numpy(), **TOL)
    for i in range(EXTRA):
        tok = s.toks[:, T + i:T + i + 1]
        jl, jc = s.jdecode(s.jparams, tok, jc)
        with torch.inference_mode():
            lg, cache = s.model.decode_step(s.params, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert cache["pos"] == int(jc["pos"]) == T + EXTRA


def test_decode_continues_a_jax_cache(setup):
    s = setup
    _, jc = s.jprefill(s.jparams, {"tokens": s.toks[:, :T], **s.frames})
    cache = cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    tok = s.toks[:, T:T + 1]
    jl, _ = s.jdecode(s.jparams, tok, jc)
    with torch.inference_mode():
        lg, _ = s.model.decode_step(s.params, torch.from_numpy(tok), cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)


def test_sliding_window_ring_decode_matches_windowed_forward():
    """Decoding past the window with the ring cache matches the full prefill
    with the same window mask (the port's twin of the JAX model test)."""
    cfg = get_arch("hymba-1.5b").reduced(sliding_window=8, n_layers=2)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (1, 25)))
    with torch.inference_mode():
        lg_full, _ = model.prefill(params, {"tokens": toks}, cache_len=28)
        _, cache = model.prefill(params, {"tokens": toks[:, :24]}, cache_len=cfg.sliding_window)
        assert cache["layers"]["k"].shape[2] == cfg.sliding_window
        lg_dec, _ = model.decode_step(params, toks[:, 24:25], cache)
    np.testing.assert_allclose(lg_dec.numpy(), lg_full.numpy(), atol=2e-4, rtol=2e-3)


def test_greedy_generate_matches_jax(setup):
    s = setup
    steps = 6
    want = j_generate(s.jmodel, s.jparams, jnp.asarray(s.toks[:, :T]), steps=steps,
                      cache_len=T + steps + 1)
    got = serve.generate(s.model, s.params, torch.from_numpy(s.toks[:, :T]), steps=steps,
                         cache_len=T + steps + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_uses_the_given_generator(setup):
    s = setup
    prompts = torch.from_numpy(s.toks[:, :16])

    def run(seed):
        return serve.generate(s.model, s.params, prompts, steps=5, cache_len=24, temperature=0.9,
                              generator=torch.Generator().manual_seed(seed))

    a, b = run(7), run(7)
    assert torch.equal(a, b) and a.shape == (B, 5) and int(a.max()) < s.cfg.vocab
    with pytest.raises(ValueError, match="Generator"):
        serve.generate(s.model, s.params, prompts, steps=2, cache_len=24, temperature=0.9)


@pytest.mark.parametrize("arch", list(ARCH_KW))
def test_serve_cli_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "40",
                      "--tokens", "4"])
    assert out.shape == (2, 4) and "seq1:" in capsys.readouterr().out


def test_kernel_backend_on_cpu_takes_plain_versions_and_needs_no_grad():
    cfg = get_arch("hymba-1.5b").reduced()
    params = build_model(cfg).init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 64)))
    before = (flash_attention_kernel.launches, ssd_intra_chunk_kernel.launches)
    with torch.inference_mode():
        lk, ck = build_model(cfg, backend="kernel").prefill(params, {"tokens": toks}, 70)
        lr, cr = build_model(cfg, backend="ref").prefill(params, {"tokens": toks}, 70)
    assert (flash_attention_kernel.launches, ssd_intra_chunk_kernel.launches) == before
    assert torch.equal(lk, lr)
    assert all(torch.equal(ck["layers"][k], cr["layers"][k]) for k in ck["layers"])
    grad_params = {k: v.requires_grad_() for k, v in params.items()}
    with pytest.raises(RuntimeError, match="forward-only"):
        build_model(cfg).prefill(grad_params, {"tokens": toks}, 70)
    loss, metrics = build_model(cfg).loss(params, {"tokens": toks})
    assert torch.isfinite(loss) and set(metrics) == {"ce", "aux"}
    with pytest.raises(ValueError, match="backend"):
        build_model(cfg, backend="pallas")


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "deepseek-v2-lite-16b"])
def test_registry_refuses_unported_archs(arch):
    """No arch is left unported: each DeepSeek config is the JAX config
    field for field, with no JAX field left out (V3's ``remat="full"``
    included); an unknown name still raises ``KeyError``."""
    cfg = get_arch(arch)
    assert cfg.name == arch and cfg.family == "moe" and cfg == port_cfg(J_ARCHS[arch])
    assert cfg.mtp == (arch == "deepseek-v3-671b") and cfg.moe.scan_groups == cfg.mtp
    assert cfg.remat == ("full" if arch == "deepseek-v3-671b" else "none")
    assert _fields(ArchConfig) == _fields(type(J_ARCHS[arch]))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(J_ARCHS[arch])
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def _fields(cls) -> list:
    return [f.name for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "minicpm-2b", "chatglm3-6b", "qwen2-72b"])
def test_registry_serves_the_zoo_archs(arch):
    """Each new arch is the JAX config field for field, with no JAX field
    left out (Qwen2-72B's ``remat="full"`` included)."""
    cfg = get_arch(arch)
    assert cfg.name == arch and cfg == port_cfg(J_ARCHS[arch])
    assert cfg.remat == ("full" if arch == "qwen2-72b" else "none")
    assert _fields(ArchConfig) == _fields(type(J_ARCHS[arch]))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(J_ARCHS[arch])


@pytest.mark.parametrize("arch", sorted(PORT_ARCHS))
def test_every_arch_equals_jax_and_counts_its_params(arch):
    """Every arch of the port's registry (the JAX registry's, name for
    name) equals its JAX config field for field, and its ``param_counts``
    (total, and active: routed experts at top_k / E) equal JAX's exactly,
    the twin of ``tests/test_models.py::test_param_counts_full_scale``."""
    assert set(PORT_ARCHS) == set(J_ARCHS)
    assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(J_ARCHS[arch])
    assert param_counts(arch) == j_param_counts(arch)


def test_fl_config_and_input_shapes_equal_jax():
    """``FLConfig()`` has JAX's fields in JAX's order with JAX's defaults,
    ``aggregation`` included, but ``uplink_backend``: the port's default
    ``"kernel"`` is JAX's ``"pallas"`` (the kernel on the card's main
    path), where JAX defaults to ``"ref"``.  ``INPUT_SHAPES`` equals JAX's
    and ``get_shape`` raises ``KeyError`` on an unknown name."""
    assert _fields(FLConfig) == _fields(JFL)
    mine, theirs = dataclasses.asdict(FLConfig()), dataclasses.asdict(JFL())
    assert {k for k in theirs if mine[k] != theirs[k]} == {"uplink_backend"}
    assert (mine["uplink_backend"], theirs["uplink_backend"]) == ("kernel", "ref")
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert get_shape("train_4k") == INPUT_SHAPES["train_4k"]
    assert get_shape("train_4k").seq_len == j_get_shape("train_4k").seq_len == 4096
    assert tokens_for("train_4k") == 4096 * 256 and tokens_for("decode_32k") == 128
    with pytest.raises(KeyError):
        get_shape("no-such-shape")


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "vision-tiny"])
def test_registry_serves_the_vlm_archs(arch):
    cfg = get_arch(arch)
    assert cfg.name == arch and cfg.family == "vlm" and cfg.num_patches > 0
    assert cfg == port_cfg(J_ARCHS[arch])


def test_windowed_dense_config_is_not_served():
    """A dense config with a sliding window is now served as the JAX
    package serves it: the prefill windowed, then a decode step over the
    linear cache, which sees the whole cache (JAX's ``gqa_decode`` never
    reads its ``window``): logits and cache equal to JAX's at the serve
    tolerance.  ``tests/test_torch_zoo.py`` holds the ring cache too."""
    jcfg = J_ARCHS["qwen1.5-0.5b"].reduced(sliding_window=8)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 25)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": toks[:, :24]}, 28)
    jl, jc = jmodel.decode_step(jparams, toks[:, 24:25], jc)
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :24])}, 28)
        lg, cache = model.decode_step(params, torch.from_numpy(toks[:, 24:25]), cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    for k, v in cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")["layers"].items():
        np.testing.assert_allclose(cache["layers"][k].numpy(), v.numpy(), **TOL)
