"""Model assembly: ``init`` / ``loss`` / ``prefill`` / ``decode_step``.

One ``Model`` per ArchConfig, the API the FL stack and the serving path use:

  * ``init(seed, device) -> params``  (flat dict of tensors, random weights
    drawn with a ``torch.Generator`` on ``device``; shapes only on ``meta``)
  * ``loss(params, batch) -> (scalar, {"ce", "aux"} (+ "mtp_ce"))``  (the
    train objective; gradients come from autograd)
  * ``init_cache(batch_size, cache_len, device) -> cache``  (decode state,
    zeros)
  * ``prefill(params, batch, cache_len) -> (logits, cache)``
  * ``decode_step(params, token, cache, ring=False) -> (logits, cache)``

The port's counterpart of ``repro.models.model`` for every family: dense,
vlm, moe (MLA + MoE), ssm, hybrid and audio (encoder-decoder).
A cache is ``{"layers": {name: [L, B, ...] tensor}, "pos": int}`` with the
JAX package's entries and layouts; ``decode_step`` writes it in place (the
JAX step returns a new one) and returns it.  ``backend`` picks the
prefill's kernels (flash attention, SSD intra-chunk): ``"kernel"`` (the
default) launches them for CUDA tensors and takes their plain torch
versions for CPU tensors; ``"ref"`` takes the plain versions on any
device.  The decode step runs no kernel of the port, and the train loss
none either (the plain attention and SSD scan, under autograd); nor does
the moe family's prefill (MLA through the plain attention, as in JAX).
The dense family's cache is linear, or a ring with
``decode_step(ring=True)``; the hybrid family's is a ring of the window's
size.  As in the JAX package, a
dense config's sliding window applies to the prefill and the loss, and
its decode step sees the whole cache: a window-sized ring cache is what
windows it.  The ssm family (Mamba2) adds no positions and caches the SSD
state and the conv tail alone.  The vlm family is the dense family with
``batch["patches"]`` [B, num_patches, d_model] (the patch embeddings the
stubbed vision tower would give) projected by ``patch_proj`` and prefixed
to the token embeddings: positions run over patches and tokens, the train
loss reads the text positions only, and the prefill caches K/V over both
(``pos`` = num_patches + T); its decode step is the dense one.  The moe
family (DeepSeek) caches MLA's compressed ``c_kv`` and ``k_rope``
(linear, or a ring with ``ring=True``); its loss adds the MoE aux summed
over layers, and with ``cfg.mtp`` DeepSeek-V3's multi-token prediction
(``mtp_block``, ``mtp_proj``: ``mtp_coef * (mtp_ce + mtp_aux)``).  The
audio family runs its encoder once a prefill over ``batch["frames"]`` [B,
src_frames, d_model] (the frame embeddings the stubbed front end would
give), with sinusoidal positions (``rope_kind="none"``) on both sides; its
cache adds the encoder memory's K/V per decoder layer (``xk``, ``xv``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import blocks as B
from ..dist.tensor import settle, shard_model
from .layers import dense_init, embed_init, rmsnorm, softmax_xent
from .mamba2 import dims as ssm_dims
from .remat import checkpoint

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
UNPOSITIONED = ("ssm", "audio")  # rope_kind "none": audio adds a sinusoid, ssm nothing
BACKENDS = ("kernel", "ref")
REMAT = ("none", "full")
SEQ_KEYS = ("k", "v", "c_kv", "k_rope")   # sequence-indexed cache entries


def sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Absolute sinusoidal embeddings [..., dim] in fp32 (used when
    rope_kind == 'none'); the caller casts to the activations' dtype."""
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / max(1, half)).astype(np.float32)
    ang = positions[..., None].float() * torch.from_numpy(freqs).to(positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[..., :dim]


def onehot_lookup(table: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``toks`` as ``one_hot(toks) @ table``: the
    values a gather gives (one exact product a row, the rest exact zeros),
    for the train loss, where the backward matters.  It is a matrix
    product, whose sum over a row's positions gives the same bits at any
    batch of two or more sequences (the bucketed layout runs a cohort in
    smaller batches than the padded one, and both must give each client the
    same bits) and needs no host synchronisation.  aten's embedding
    backward on a CUDA tensor takes another algorithm at 3,072 indices or
    fewer, and indexing's backward synchronises with the host every step.
    The cost is the output head's again: tokens x vocab x d_model a pass."""
    return F.one_hot(toks, table.shape[0]).to(table.dtype) @ table


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    backend: str = "kernel"

    def __post_init__(self):
        cfg = self.cfg
        if cfg.family not in FAMILIES:
            raise NotImplementedError(f"{cfg.name}: no {cfg.family!r} family; have {FAMILIES}")
        if (cfg.rope_kind == "none") != (cfg.family in UNPOSITIONED):
            raise NotImplementedError(
                f"{cfg.name}: the dense, vlm, moe and hybrid families are ported with RoPE, the "
                f"ssm and audio families with rope_kind 'none'")
        if (cfg.family == "moe") != (cfg.moe is not None and cfg.mla is not None) or \
                (cfg.mtp and cfg.family != "moe"):
            raise NotImplementedError(
                f"{cfg.name}: the moe family is MLA + MoE (both configs set), and only it "
                f"takes mtp")
        if cfg.remat not in REMAT:
            raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}; have {REMAT}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; have {BACKENDS}")

    def init(self, seed: int, device) -> dict:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        # device "meta" gives the shapes alone (it has no generator)
        gen = (None if torch.device(device).type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        init_block = {"ssm": B.ssm_block_init, "hybrid": B.hybrid_block_init,
                      "audio": B.dec_block_init, "moe": B.moe_block_init,
                      }.get(cfg.family, B.dense_block_init)
        p = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dt, device)}
        if cfg.family == "audio":
            for i in range(cfg.enc_layers):
                p.update(B.enc_block_init(gen, cfg, dt, device, f"enc_blocks/{i}/"))
            p["enc_norm/scale"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        for i in range(cfg.n_layers):
            p.update(init_block(gen, cfg, dt, device, f"blocks/{i}/"))
        p["final_norm/scale"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, dt, device)
        if cfg.family == "vlm":
            p["patch_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, dt, device)
        if cfg.mtp:
            p.update(B.moe_block_init(gen, cfg, dt, device, "mtp_block/"))
            p["mtp_proj"] = dense_init(gen, 2 * cfg.d_model, cfg.d_model, dt, device)
        return p

    def _embed(self, params: dict, batch: dict, toks: torch.Tensor, *, train: bool = False):
        """The token embeddings [B, T, D] of ``toks`` (``onehot_lookup`` in
        the train loss, a gather elsewhere: the same values), for the vlm
        family with ``batch["patches"] @ patch_proj`` [B, P, D] prefixed ->
        (h, P)."""
        toks = toks.long()
        h = onehot_lookup(params["embed"], toks) if train else F.embedding(toks, params["embed"])
        h = settle(h)       # a vocab-parallel lookup's partial sums, under a mesh
        if self.cfg.family != "vlm":
            return h, 0
        if "patches" not in batch:
            raise ValueError(f"{self.cfg.name}: a vlm batch needs 'patches' "
                             f"[B, num_patches, d_model]")
        patches = batch["patches"].to(h.dtype) @ params["patch_proj"]
        return torch.cat([patches, h], dim=1), patches.shape[1]

    def _logits(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(params["final_norm/scale"], h, self.cfg.norm_eps)
        return h @ (params["embed"].T if self.cfg.tie_embeddings else params["lm_head"])

    def loss(self, params: dict, batch: dict):
        """Mean next-token cross entropy of ``batch["tokens"]`` [B, T+1]
        (after the vlm family's patches; for the audio family, the decoder
        over the encoder of ``batch["frames"]``) -> (ce + aux, {"ce",
        "aux"}), aux the moe family's load-balance loss summed over layers
        (0 in the other families).  With ``cfg.mtp`` (DeepSeek-V3), the
        MTP block predicts token t+2 from the normed h_t and the embedding
        of token t+1 (``concat(.) @ mtp_proj``, positions 0..T-2), through
        the final norm and the head: the loss adds ``mtp_coef * (mtp_ce +
        mtp_aux)`` and the metrics ``mtp_ce``.  The plain
        attention (the dense family's window ``cfg.sliding_window``; its
        K/V band alone with ``cfg.opt_banded_window``) and the plain SSD
        scan, with no in-place write, so that it runs under autograd and
        ``torch.func.vmap``.  With ``cfg.remat == "full"`` each backbone
        layer (an audio decoder layer with its cross-attention K/V) keeps
        only its inputs and is recomputed in the backward pass
        (``models/remat.py``); the encoder, the MTP block, the final norm
        and the head are not, as in the JAX package.  With
        ``cfg.opt_onehot_xent`` the cross entropies pick the label's logit
        by a one-hot product."""
        cfg = self.cfg
        toks = batch["tokens"]
        inputs, labels = toks[..., :-1], toks[..., 1:]
        h, offset = self._embed(params, batch, inputs, train=True)
        positions = torch.arange(h.shape[1], device=h.device)
        if cfg.family == "audio":
            h = h + sinusoid(positions, cfg.d_model)[None].to(h.dtype)
            enc_out = self._encode(params, batch["frames"], train=True)
        aux = None      # the moe family's, summed over layers
        for i in range(cfg.n_layers):
            prefix = f"blocks/{i}/"
            names = [k for k in params if k.startswith(prefix)]
            # the audio decoder reads the encoder memory twice, V's first
            xs = (h, positions, *([enc_out, enc_out] if cfg.family == "audio" else []),
                  *(params[k] for k in names))
            body = self._layer_body(prefix, names)
            out = checkpoint(body, *xs) if cfg.remat == "full" else body(*xs)
            if cfg.family == "moe":
                h, a = out
                aux = a if aux is None else aux + a
            else:
                h = out
            if cfg.opt_seq_shard:     # sequence-parallel residual stream, on a mesh
                h = shard_model(h, 1)
        onehot = cfg.opt_onehot_xent
        ce = softmax_xent(self._logits(params, h[:, offset:]), labels, onehot).mean()
        if aux is None:
            loss, metrics = ce, {"ce": ce, "aux": torch.zeros_like(ce)}
        else:
            loss, metrics = ce + aux, {"ce": ce, "aux": aux}
        S = inputs.shape[-1]
        if cfg.mtp and S >= 2:
            hn = rmsnorm(params["final_norm/scale"], h[:, offset:], cfg.norm_eps)
            nxt = onehot_lookup(params["embed"], inputs[:, 1:].long())
            comb = torch.cat([hn[:, :-1], nxt], dim=-1) @ params["mtp_proj"]
            hm, mtp_aux = B.moe_block_forward(params, cfg, comb,
                                              torch.arange(S - 1, device=h.device), "mtp_block/")
            mtp_ce = softmax_xent(self._logits(params, hm), labels[:, 1:], onehot).mean()
            loss = loss + cfg.mtp_coef * (mtp_ce + mtp_aux)
            metrics["mtp_ce"] = mtp_ce
        return loss, metrics

    def _layer_body(self, prefix: str, names: list):
        """Layer ``prefix``'s train forward as a function of tensors alone,
        ``(h, positions, [enc_v, enc_k,] *leaves) -> h`` (``(h, aux)`` for the
        moe family), ``leaves`` the parameters ``names`` (the layer's), so
        that :func:`~.remat.checkpoint` can run it: the audio decoder's
        cross-attention K/V of the encoder memory inside it, as in the JAX
        package's checkpointed body.  The audio body takes the memory
        twice, ``(enc_v, enc_k)``, for the V and the K projection: the
        memory's gradient then gathers one projection at a time, V's
        before K's and the last layer's first, the order autograd adds
        them in the plain graph, so that it has the same bits with
        ``remat`` as without (one input would add each layer's two terms
        first)."""
        cfg, fam = self.cfg, self.cfg.family

        def body(h, positions, *rest):
            enc, rest = (rest[:2], rest[2:]) if fam == "audio" else (None, rest)
            p = dict(zip(names, rest))
            if fam == "audio":
                xkv = B.cross_kv(p, cfg, enc[1], prefix, v_memory=enc[0])
                return B.dec_block_forward(p, cfg, h, positions, xkv, prefix)
            if fam == "moe":
                return B.moe_block_forward(p, cfg, h, positions, prefix,
                                           window=cfg.sliding_window)
            if fam == "ssm":
                return B.ssm_block_forward(p, cfg, h, prefix)
            if fam == "hybrid":
                return B.hybrid_block_forward(p, cfg, h, positions, prefix)
            return B.dense_block_forward(p, cfg, h, positions, prefix, window=cfg.sliding_window)

        return body

    # ---------------------------------------------------------------- serve

    def cache_spec(self, batch_size: int, cache_len: int, src_len: int = 0) -> dict:
        """{name: (shape [L, B, ...], dtype)} of the decode cache.  The
        hybrid family's attention cache is a ring of the window's size; the
        moe family's is MLA's latent ``c_kv`` and ``k_rope``; the audio
        family's adds the encoder memory's K/V over ``src_len``
        frames (``cfg.src_frames`` when 0); the ssm family has no attention
        cache, and it and the hybrid family keep the SSD state (fp32) and
        the conv tail."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        L, S, hd = cfg.n_layers, cache_len, cfg.hd()
        if cfg.family == "hybrid":
            S = min(S, cfg.sliding_window or S)
        spec = {}
        if cfg.family == "moe":
            spec["c_kv"] = ((L, batch_size, S, cfg.mla.kv_lora), dt)
            spec["k_rope"] = ((L, batch_size, S, cfg.mla.qk_rope_dim), dt)
        elif cfg.family != "ssm":
            spec["k"] = ((L, batch_size, S, cfg.n_kv_heads, hd), dt)
            spec["v"] = ((L, batch_size, S, cfg.n_kv_heads, hd), dt)
        if cfg.family == "audio":
            src = src_len or cfg.src_frames
            spec["xk"] = ((L, batch_size, src, cfg.n_kv_heads, hd), dt)
            spec["xv"] = ((L, batch_size, src, cfg.n_kv_heads, hd), dt)
        if cfg.family in ("ssm", "hybrid"):
            d_inner, H, P, N = ssm_dims(cfg)
            spec["state"] = ((L, batch_size, H, P, N), torch.float32)
            spec["conv"] = ((L, batch_size, cfg.ssm.conv_width - 1, d_inner + 2 * N), dt)
        return spec

    def init_cache(self, batch_size: int, cache_len: int, device, src_len: int = 0) -> dict:
        layers = {k: torch.zeros(shape, dtype=d, device=device)
                  for k, (shape, d) in self.cache_spec(batch_size, cache_len, src_len).items()}
        return {"layers": layers, "pos": 0}

    def _encode(self, params: dict, frames: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """The audio encoder over frame embeddings [B, S, d_model]: the
        sinusoid added, ``enc_layers`` non-causal blocks (flash, or the
        plain attention in the train loss), the final norm."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        pos = torch.arange(frames.shape[1], device=frames.device)
        h = frames.to(dt) + sinusoid(pos, cfg.d_model)[None].to(dt)
        for i in range(cfg.enc_layers):
            prefix = f"enc_blocks/{i}/"
            h = (B.enc_block_forward(params, cfg, h, pos, prefix) if train else
                 B.enc_block_prefill(params, cfg, h, pos, prefix, backend=self.backend))
        return rmsnorm(params["enc_norm/scale"], h, cfg.norm_eps)

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """Forward over the prompts ``batch["tokens"]`` [B, T] (after the vlm
        family's ``batch["patches"]``; for the audio family, the encoder over
        ``batch["frames"]``), collecting decode-ready caches: -> (logits of
        the last position [B, 1, V], cache at ``pos`` T, or num_patches +
        T for the vlm family).  A dense config's sliding window applies."""
        cfg = self.cfg
        h, _ = self._embed(params, batch, batch["tokens"])
        Bsz, T = h.shape[:2]
        positions = torch.arange(T, device=h.device)
        if cfg.family == "audio":
            h = h + sinusoid(positions, cfg.d_model)[None].to(h.dtype)
            enc_out = self._encode(params, batch["frames"])
        src_len = batch["frames"].shape[1] if cfg.family == "audio" else 0
        spec = self.cache_spec(Bsz, cache_len, src_len)
        layers = {k: [] for k in spec}      # each layer's entry, stacked at the end
        for i in range(cfg.n_layers):
            prefix = f"blocks/{i}/"
            if cfg.family == "audio":
                xk, xv = B.cross_kv(params, cfg, enc_out, prefix)
                h, entry = B.dec_block_prefill(params, cfg, h, positions, (xk, xv), prefix,
                                               backend=self.backend)
                entry.update(xk=xk, xv=xv)
            elif cfg.family == "ssm":
                h, entry = B.ssm_block_prefill(params, cfg, h, prefix, backend=self.backend)
            elif cfg.family == "hybrid":
                h, entry = B.hybrid_block_prefill(params, cfg, h, positions, prefix,
                                                  backend=self.backend)
            elif cfg.family == "moe":
                h, _, entry = B.moe_block_prefill(params, cfg, h, positions, prefix,
                                                  window=cfg.sliding_window)
            else:
                h, entry = B.dense_block_prefill(params, cfg, h, positions, prefix,
                                                 window=cfg.sliding_window, backend=self.backend)
            if cfg.opt_seq_shard:
                h = shard_model(h, 1)
            for name, x in entry.items():   # a copy: a view would keep its layer's tensors alive
                shape, dt = spec[name]
                layers[name].append(_cache_entry(x, shape[2], T).to(dt) if name in SEQ_KEYS else
                                    x.to(dt, copy=True))
        cache = {"layers": {k: torch.stack(xs) for k, xs in layers.items()}, "pos": T}
        return self._logits(params, h[:, -1:]), cache

    def decode_step(self, params: dict, token: torch.Tensor, cache: dict, *, ring: bool = False):
        """token [B, 1] -> (logits [B, 1, V], cache), the cache written in
        place and advanced by one position.  ``ring`` writes the dense,
        vlm, moe and audio decoders' self-attention caches at slot ``pos % S``
        (the JAX package's keyword); the hybrid family's cache is always a
        ring, the ssm family's has no slots."""
        cfg = self.cfg
        pos = cache["pos"]
        h = settle(F.embedding(token.long(), params["embed"]))
        if cfg.family == "audio":
            h = h + sinusoid(torch.full((1,), pos, device=h.device), cfg.d_model)[None].to(h.dtype)
        for i in range(cfg.n_layers):
            prefix = f"blocks/{i}/"
            layer = {k: v[i] for k, v in cache["layers"].items()}
            if cfg.family == "audio":
                h, _ = B.dec_block_decode(params, cfg, h, pos, layer, prefix, ring=ring)
            elif cfg.family == "ssm":
                h, _ = B.ssm_block_decode(params, cfg, h, layer, prefix)
            elif cfg.family == "hybrid":
                h, _ = B.hybrid_block_decode(params, cfg, h, pos, layer, prefix)
            elif cfg.family == "moe":
                h, _ = B.moe_block_decode(params, cfg, h, pos, layer, prefix, ring=ring)
            else:
                h, _ = B.dense_block_decode(params, cfg, h, pos, layer, prefix, ring=ring)
        cache["pos"] = pos + 1
        return self._logits(params, h), cache


def _cache_entry(x: torch.Tensor, S: int, t: int) -> torch.Tensor:
    """A prefill's sequence-indexed entry x [B, t, ...] as the layer's
    [B, S, ...] cache, ring-consistent: slot ``p % S`` holds position p of
    the last ``min(t, S)``, and the slots after t are zeros."""
    start = max(0, t - S)
    if t < S:
        return torch.cat([x, x.new_zeros((x.shape[0], S - t) + tuple(x.shape[2:]))], dim=1)
    j = (torch.arange(S, device=x.device) - start) % S          # slot s holds start + j[s]
    return x[:, start:t][:, j]


def build_model(cfg: ArchConfig, backend: str = "kernel") -> Model:
    return Model(cfg, backend)
