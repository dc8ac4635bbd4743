"""MiniCPM-2B [arXiv:2404.06395] — llama-like dense, tied embeddings (a copy
of ``repro.configs.minicpm_2b``)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    citation="arXiv:2404.06395",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    rope_kind="full",
    tie_embeddings=True,
)
