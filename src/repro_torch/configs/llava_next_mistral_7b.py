"""LLaVA-NeXT (Mistral-7B) [hf:llava-hf/llava-v1.6-mistral-7b-hf] — VLM (a
copy of ``repro.configs.llava_next_mistral_7b``).

The vision tower and projector are a stub: the model takes pre-projected
patch embeddings [batch, num_patches, d_model] and prepends them to the
text token embeddings (anyres tiling sets num_patches: one base tile of 576
plus the high-res grid, 1,176 here)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    rope_kind="full",
    rope_theta=1e6,
    num_patches=1176,       # anyres: base 576 + hi-res tiles (simplified)
)
