"""Model assembly: ``init`` / ``loss`` for the dense transformer LM.

One ``Model`` per ArchConfig, the API the FL stack uses:

  * ``init(seed, device) -> params``  (flat dict of tensors, random weights
    drawn with a ``torch.Generator`` on ``device``; shapes only on ``meta``)
  * ``loss(params, batch) -> (scalar, metrics)``  (the train objective)

Gradients come from autograd.  The port's counterpart of
``repro.models.model`` for the dense family; the JAX package's other
families, prefill and decode are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .blocks import dense_block_forward, dense_block_init
from .layers import dense_init, embed_init, rmsnorm, softmax_xent


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family != "dense" or self.cfg.rope_kind == "none":
            raise NotImplementedError(
                f"{self.cfg.name}: only the dense family with RoPE is ported yet")

    def init(self, seed: int, device) -> dict:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        # device "meta" gives the shapes alone (it has no generator)
        gen = (None if torch.device(device).type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        p = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dt, device)}
        for i in range(cfg.n_layers):
            p.update(dense_block_init(gen, cfg, dt, device, f"blocks/{i}/"))
        p["final_norm/scale"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, dt, device)
        return p

    def loss(self, params: dict, batch: dict):
        cfg = self.cfg
        toks = batch["tokens"]
        inputs, labels = toks[..., :-1], toks[..., 1:]
        h = F.embedding(inputs.long(), params["embed"])
        positions = torch.arange(h.shape[1], device=h.device)
        for i in range(cfg.n_layers):
            h = dense_block_forward(params, cfg, h, positions, f"blocks/{i}/")
        h = rmsnorm(params["final_norm/scale"], h, cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        ce = softmax_xent(h @ head, labels).mean()
        return ce, {"ce": ce}


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
