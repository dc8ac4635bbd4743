"""Hymba-1.5B [arXiv:2411.13676] — hybrid parallel attention+SSM heads (a
copy of ``repro.configs.hymba_1_5b``).

Each layer runs a sliding-window GQA attention branch and a Mamba2 SSD
branch in parallel on the same normalised input; serving decodes with a
ring cache of the window's size.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    citation="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    hybrid=True,
    sliding_window=1024,
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=1, chunk=128),
)
