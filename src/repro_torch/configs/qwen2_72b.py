"""Qwen2-72B [arXiv:2407.10671] — dense, GQA kv=8, QKV bias (a copy of
``repro.configs.qwen2_72b``).

``remat="full"``: the train loss recomputes each layer's activations in
the backward pass (``models/remat.py``), as the JAX config's
``jax.checkpoint`` does."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    citation="arXiv:2407.10671",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_kind="full",
    rope_theta=1e6,
    remat="full",
)
