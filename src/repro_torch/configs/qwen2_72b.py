"""Qwen2-72B [arXiv:2407.10671] — dense, GQA kv=8, QKV bias (a copy of
``repro.configs.qwen2_72b``).

The JAX config also sets ``remat="full"`` (``jax.checkpoint`` of each
layer in the train loss), which changes memory only; the port has no such
field yet (ROADMAP 'Modules to port', item 10), and every other field is
the JAX config's."""
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
)
