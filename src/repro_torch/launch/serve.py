"""Serving launcher: batched prefill + autoregressive decode (the port of
``repro.launch.serve``).

``generate`` runs ``Model.prefill`` over the prompts (the flash attention
and SSD kernels on a card), then ``Model.decode_step`` once a token, under
``torch.inference_mode()``.  An audio encoder-decoder encodes zero frame
embeddings and a vlm model prefixes zero patch embeddings, as the JAX
package's ``generate`` does.  The CLI serves the
reduced demo config of an arch with random weights from seed 0 and prompts
from numpy seed 1::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-mistral-7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --device cpu

(or ``minicpm-2b``, ``chatglm3-6b``, ``qwen2-72b``, ``deepseek-v2-lite-16b``,
``deepseek-v3-671b``: every arch of the registry; the two DeepSeek archs
cache MLA's latent ``c_kv`` / ``k_rope`` and route each token through the
MoE's capacity-bounded dispatch, dropping what overflows, as JAX does).

The cache holds a vlm model's ``num_patches`` patch positions before the
prompt and the generated tokens.

``--checkpoint PATH`` serves the params of a checkpoint saved by either
package (``save_checkpoint``: the JAX package's layout), loaded into the
model's init params in that layout and carried onto the device.  It runs
on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from ..configs.registry import get_arch
from ..models.model import Model, build_model
from ..utils.checkpoint import load_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import log


@torch.inference_mode()
def generate(model: Model, params: dict, prompts: torch.Tensor, *, steps: int, cache_len: int,
             temperature: float = 0.0, generator: torch.Generator | None = None,
             on_logits: Callable[[int, torch.Tensor], None] | None = None) -> torch.Tensor:
    """prompts [B, T] int -> generated [B, steps] int64: greedy
    (``temperature == 0``) or sampled from softmax(logits / temperature)
    with ``generator`` (a ``torch.Generator`` on the prompts' device).

    ``on_logits(i, logits [B, V])``, if given, sees the prefill's logits
    (i = 0) and each decode step's (i = 1 .. steps - 1) before the token is
    picked from them.  The last token needs no decode step, so there are
    ``steps - 1`` of them."""
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs an explicit torch.Generator")
    batch = {"tokens": prompts}
    if model.cfg.family == "vlm":
        batch["patches"] = torch.zeros((prompts.shape[0], model.cfg.num_patches,
                                        model.cfg.d_model), dtype=torch.float32,
                                       device=prompts.device)
    if model.cfg.family == "audio":
        batch["frames"] = torch.zeros((prompts.shape[0], model.cfg.src_frames, model.cfg.d_model),
                                      dtype=torch.float32, device=prompts.device)
    logits, cache = model.prefill(params, batch, cache_len)
    out = []
    for i in range(steps):
        last = logits[:, -1]
        if on_logits is not None:
            on_logits(i, last)
        if temperature > 0:
            probs = torch.softmax(last.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(last, dim=-1, keepdim=True)
        out.append(tok)
        if i + 1 < steps:
            logits, cache = model.decode_step(params, tok, cache)
    return torch.cat(out, dim=1)


def main(argv: list[str] | None = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device)
    if args.checkpoint:
        params = load_checkpoint(args.checkpoint, params)
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (args.batch, args.prompt_len)), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, steps=args.tokens,
                   cache_len=cfg.num_patches + args.prompt_len + args.tokens + 1,
                   temperature=args.temperature, generator=gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    log(f"served {args.batch}x{args.tokens} tokens in {dt:.2f}s "
        f"({args.batch * args.tokens / dt:.1f} tok/s) on {device}")
    for b in range(min(2, args.batch)):
        print(f"  seq{b}: {out[b].tolist()}")
    return out


if __name__ == "__main__":
    main()
