"""The PyTorch port's CharLM forward/backward against the JAX model.

Same JAX ``Model.init`` parameters (through ``params_from_jax``) and the
same tokens: the loss agrees at rtol 1e-5 / atol 1e-6, and every gradient
leaf within atol 1e-6 + rtol 1e-5 of that leaf's largest magnitude.  Both
run fp32 on the CPU; the tolerance covers the different summation order of
the two frameworks' matrix products and reductions, whose rounding error
scales with the largest terms of a sum (the embedding gradient sums terms
of magnitude ~1 into entries of ~1e-2), not with each entry.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_tasks import CHARLM_TINY as J_TINY  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.utils.pytree import tree_paths  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.paper_tasks import CHARLM_TINY  # noqa: E402
from repro_torch.core.local import value_and_grad  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

SEQ, BATCH = 16, 2
GQA = dict(n_kv_heads=2, qkv_bias=True)    # grouped heads + QKV bias path


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs a test process on each of several
    cores at once, and torch's default (a thread a core in every process)
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(**kw):
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in dataclasses.asdict(J_TINY).items() if k in fields} | kw)


def _setup(**kw):
    jcfg = dataclasses.replace(J_TINY, **kw)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, size=(BATCH, SEQ + 1)).astype(np.int32)
    pcfg = _port_cfg(**kw)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), pcfg, "cpu")
    return jmodel, jparams, toks, build_model(pcfg), params


@pytest.mark.parametrize("kw", [{}, GQA], ids=["mha", "gqa_bias"])
def test_loss_and_grads_match_jax(kw):
    jmodel, jparams, toks, model, params = _setup(**kw)
    (jl, _), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, {"tokens": toks})
    loss, grads = value_and_grad(model.loss, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jg), model.cfg, "cpu")
    assert set(grads) == set(want)
    for k in want:
        g, w = grads[k].numpy(), want[k].numpy()
        assert np.abs(g - w).max() <= 1e-6 + 1e-5 * np.abs(w).max(), k


def test_params_from_jax_unstacks_every_layer():
    jmodel, jparams, _, model, params = _setup()
    n_jax = sum(int(np.prod(x.shape)) for _, x in tree_paths(jparams))
    assert sum(v.numel() for v in params.values()) == n_jax
    assert params["blocks/1/attn/wq"].shape == (128, 128)
    np.testing.assert_array_equal(params["blocks/1/mlp/down"].numpy(),
                                  np.asarray(jparams["blocks"]["mlp"]["down"][1]))


def test_port_init_has_the_jax_layout():
    """The port's own seeded init has the same names, shapes and dtypes as
    the converted JAX parameters (the values are the port's own draws)."""
    _, _, _, model, params = _setup()
    own = model.init(0, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    again = model.init(0, "cpu")
    assert all(torch.equal(own[k], again[k]) for k in own)


def test_charlm_tiny_is_a_copy():
    assert _port_cfg() == CHARLM_TINY
