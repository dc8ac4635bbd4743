"""SeamlessM4T-medium [arXiv:2308.11596] — encoder-decoder (audio backbone),
a copy of ``repro.configs.seamless_m4t_medium``.

The mel-spectrogram + conformer feature extractor is a stub: the encoder
takes precomputed frame embeddings of shape (batch, src_frames, d_model);
the transformer encoder-decoder backbone is what runs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    citation="arXiv:2308.11596",
    n_layers=12,            # decoder layers
    enc_layers=12,          # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    rope_kind="none",       # learned/sinusoidal positions in the original
    src_frames=1024,
)
