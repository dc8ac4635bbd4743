"""The paper's experimental models that the port runs (copies of
``repro.configs.paper_tasks``).

* ``charlm-tiny`` — stand-in for the Shakespeare LSTM (2-layer transformer LM
  over a small char vocab; heterogeneous client sizes ~ log-normal).
* ``vision-tiny`` — stand-in for CIFAR100/ResNet18 (patch-transformer over
  synthetic image patches; equal split; E_i ~ U{2..5} per round -> exercises
  FedShuffleGen).
* ``charlm-100m`` — the e2e train driver's ~100M-param char-LM.
"""
from __future__ import annotations

from .base import ArchConfig

CHARLM_TINY = ArchConfig(
    name="charlm-tiny",
    family="dense",
    citation="paper §6.2 (Shakespeare stand-in)",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab=128,
    dtype="float32",
)

VISION_TINY = ArchConfig(
    name="vision-tiny",
    family="vlm",          # patch-embedding frontend stub = image patches
    citation="paper §6.2 (CIFAR100 stand-in)",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab=100,             # 100 classes as a 100-token vocab on a CLS position
    num_patches=64,        # 8x8 patches of a 32x32 image
    dtype="float32",
)

CHARLM_100M = ArchConfig(
    name="charlm-100m",
    family="dense",
    citation="e2e driver (~100M params)",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=8192,
    dtype="float32",
)

PAPER_ARCHS = {c.name: c for c in (CHARLM_TINY, VISION_TINY, CHARLM_100M)}
