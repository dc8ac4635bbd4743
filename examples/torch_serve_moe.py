"""Serve a (reduced) DeepSeek-V2-Lite MoE with MLA absorbed decode on the
PyTorch port: the same ``Model.decode_step`` that ``launch/specs.py``
counts for decode_32k / long_500k at full scale.  The counterpart of
``examples/serve_moe.py``; it imports only ``repro_torch``.

    PYTHONPATH=src python examples/torch_serve_moe.py [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.launch.serve import generate
from repro_torch.models.model import build_model
from repro_torch.utils.device import resolve_device


def main(device=None, params: dict | None = None, prompts: torch.Tensor | None = None,
         temperature: float = 0.7, steps: int = 16) -> torch.Tensor:
    """-> the generated tokens [4, steps].  ``params`` (the model's flat
    dict, e.g. ``weights.params_from_jax`` of the JAX package's) and
    ``prompts`` [4, 16] default to random ones from seeds 0 and 1;
    ``temperature`` 0 decodes greedily."""
    device = resolve_device(device)
    cfg = get_arch("deepseek-v2-lite-16b").reduced()
    model = build_model(cfg)
    params = model.init(0, device) if params is None else params
    n = sum(v.numel() for v in params.values())
    print(f"reduced {cfg.name}: {n/1e6:.2f}M params, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
          f"MLA kv_lora={cfg.mla.kv_lora}")
    gen = torch.Generator(device=device).manual_seed(1)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab, (4, 16), device=device, generator=gen)
    t0 = time.time()
    out = generate(model, params, prompts.to(device), steps=steps, cache_len=48,
                   temperature=temperature, generator=gen)
    dt = time.time() - t0
    print(f"decoded {out.shape[0]}x{steps} tokens in {dt:.2f}s (MLA cache: latent+rope per "
          f"token, not per-head K/V)")
    print("sample:", out[0].tolist())
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
