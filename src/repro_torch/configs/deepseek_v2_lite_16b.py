"""DeepSeek-V2-Lite-16B [arXiv:2405.04434] — MoE with MLA (kv_lora=512), a
copy of ``repro.configs.deepseek_v2_lite_16b``.

2 shared + 64 routed experts, top-6; per-expert FFN dim 1408; no query
compression in the Lite variant (q_lora=0).  Every layer is an MoE block,
as the JAX package builds it: ``d_ff`` is never read.
"""
from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    citation="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,             # dense FFN of layer 0 in the paper (unused: every layer is MoE)
    vocab=102400,
    mla=MLAConfig(q_lora=0, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, expert_ff=1408, group_size=1024),
)
