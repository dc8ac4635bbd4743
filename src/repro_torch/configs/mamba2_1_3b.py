"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSD (state-space duality)
(a copy of ``repro.configs.mamba2_1_3b``).

Each layer is a norm and the Mamba2 mixer with a residual, no MLP; no
attention, so no positions are added (``rope_kind="none"`` without the
audio family's sinusoid).  Serving keeps the SSD state and the conv tail.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    citation="arXiv:2405.21060",
    n_layers=48,
    d_model=2048,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=0,                 # no separate MLP: Mamba2 block is the mixer+channel
    vocab=50280,
    rope_kind="none",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=256),
)
