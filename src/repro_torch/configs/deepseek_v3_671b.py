"""DeepSeek-V3-671B [arXiv:2412.19437] — MoE with MLA and MTP, a copy of
``repro.configs.deepseek_v3_671b``.

1 shared + 256 routed experts, top-8; MLA with kv_lora=512, q_lora=1536;
one extra multi-token-prediction block (MTP).  ``remat="full"``: the
train loss recomputes each layer's activations in the backward pass
(``models/remat.py``), as the JAX config's ``jax.checkpoint`` does.
"""
from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    citation="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,             # dense-FFN width of the paper's first layers (unused here)
    vocab=129280,
    mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, num_shared=1, expert_ff=2048, group_size=1024,
                  scan_groups=True),
    mtp=True,
    remat="full",
)
