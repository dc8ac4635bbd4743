"""ChatGLM3-6B [arXiv:2406.12793] — dense, GQA kv=2, 2d (half-dim) RoPE (a
copy of ``repro.configs.chatglm3_6b``)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    citation="arXiv:2406.12793",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    qkv_bias=True,          # ChatGLM uses bias on QKV only
    rope_kind="half",       # rotary applied to half the head dims ("2d RoPE")
)
