"""Direction-aware codecs — the compressed communication plane, both
directions of the cross-device wire (the port of ``repro.fed.comm.codecs``).

Every round each sampled client ships its update ``Delta_i = y_i - x`` to
the server (the **uplink**) and the server broadcasts the model to the next
cohort (the **downlink**).  A :class:`Codec` is the per-client ``encode ->
wire -> decode`` rule the round driver applies on slot-order ``[C]`` stacks;
aggregation combines the **decoded** updates.

* **uplink** (``fl.uplink``): each client compresses its update
  (:func:`uplink_apply`).  Per-client compressor state (error-feedback
  residuals, DIANA shifts) rides the ``[N+1, ...]`` bank on
  ``ServerState.clients`` under the reserved key ``"uplink"``.
* **downlink** (``fl.downlink``): the server compresses the model's delta
  against a client-held reference (:func:`downlink_apply`), banked under the
  reserved key ``"downlink"``; the client's reconstruction ``ref +
  decode(encode(x - ref))`` is both its round-start point and its next
  reference.  Downlink-capable codecs are the stateless ones.

Protocol (the JAX package's, with the client axis written out):

* ``encode(v, key) -> payload`` / ``decode(payload, key, like) -> v'`` run
  on one *wire leaf* of the whole cohort: ``v`` is ``[C, n]`` (one row a
  slot, ``utils.pytree.to_wire``), ``key`` the ``[C]`` int64 per-slot leaf
  keys (uint32 values).  The payload dict of ``[C, ...]`` tensors IS the wire
  format; ``wire_bits(like)`` charges one client's leaf (``like`` is a
  ``[n]`` tensor, shapes only) and :func:`wire_bits_total` sums a tree.
* ``client_init(params)`` declares one client's uplink state (EF residual
  ``e``, DIANA shift ``h``) over the port's flat params; ``apply`` (DIANA)
  overrides the whole per-client hook.
* ``seeded`` codecs draw their randomness from counter-based keys per
  (seed, client, round) (:func:`round_keys`, :func:`downlink_round_keys`),
  identical on every path and to the JAX package's streams.

The tree-level walk (:func:`tree_roundtrip`) goes over the JAX package's
leaves (the wire view), deriving one subkey per JAX leaf index, so the port
draws the JAX package's random bits and pays its wire bits although it keeps
one tensor per layer.  One wire leaf is one launch of each quantize kernel
for the whole cohort.

Built-ins (:data:`CODECS`): identity (both), qsgd (both), topk (uplink, with
EF), randk (both), ef_qsgd, ef_randk, diana_qsgd, diana_randk, diana_topk
(uplink).
"""
from __future__ import annotations

import inspect
from typing import Callable, NamedTuple

import numpy as np
import torch

from ...configs.base import FLConfig
from ...kernels.quantize import ops as qops
from ...kernels.quantize.ref import BITS_CHOICES, num_chunks, packed_width
from ...kernels.rr_perm.ref import key_combine_torch, stream_key_torch, swap_or_not_torch
from ...utils.pytree import from_wire, to_wire, tree_zeros_like, wire_shapes
from ...utils.tags import SUB_COMM_DOWNLINK, TAG_COMM

# ServerState.clients keys of the comm plane's per-client banks (reserved:
# bind_strategy refuses local chains with a stateful transform of either name)
UPLINK_STATE_KEY = "uplink"
DOWNLINK_STATE_KEY = "downlink"

DIRECTIONS = ("uplink", "downlink")


def round_keys(seed: int, client_id: torch.Tensor, rnd) -> torch.Tensor:
    """Per-client uplink stream keys for one round ([C] int64, uint32
    values): the RR chain's (seed, client, round) key with the comm tag
    folded in."""
    return key_combine_torch(stream_key_torch(seed, client_id, rnd), TAG_COMM)


def downlink_round_keys(seed: int, client_id: torch.Tensor, rnd) -> torch.Tensor:
    """Per-client downlink stream keys: the uplink chain with the downlink
    subtag folded in, so the two directions' streams never correlate."""
    return key_combine_torch(round_keys(seed, client_id, rnd), SUB_COMM_DOWNLINK)


class Codec(NamedTuple):
    """One compression rule.  ``encode``/``decode``/``wire_bits`` are
    wire-leaf-level, ``client_init``/``finalize``/``apply`` tree-level
    (uplink-only).  ``direction`` declares the capability (``"uplink"`` /
    ``"downlink"`` / ``"both"``)."""

    name: str
    encode: Callable                       # (v [C, n], key [C]) -> payload dict
    decode: Callable                       # (payload, key [C], like [C, n]) -> [C, n]
    wire_bits: Callable                    # (like [n]) -> bits (python number)
    client_init: Callable | None = None    # (params) -> uplink state tree
    finalize: Callable | None = None       # (src, dhat, state) -> state'
    seeded: bool = False
    apply: Callable | None = None          # (roundtrip, delta, state, key) -> (delta_hat, state')
    direction: str = "both"


def with_error_feedback(inner: Codec, *, name: str | None = None) -> Codec:
    """EF-SGD: the client compresses ``Delta + e`` and keeps ``e' = (Delta +
    e) - decoded``.  Wire format and accounting are the inner codec's; the
    residual lives on the client, so the composition is uplink-only."""
    if inner.client_init is not None:
        raise ValueError(f"codec {inner.name!r} already keeps per-client state")
    return inner._replace(name=name or f"ef_{inner.name}",
                          client_init=lambda params: {"e": tree_zeros_like(params)},
                          direction="uplink")


def with_diana_shift(inner: Codec, alpha: float, *, name: str | None = None) -> Codec:
    """DIANA-RR learned shifts (Sadiev et al. 2022): ship ``C(Delta - h)``,
    reconstruct ``h + C(Delta - h)``, and move ``h <- h + alpha * C(Delta -
    h)`` at both ends.  Composes with error feedback (the source is then
    ``Delta + e - h``).  Uplink-only."""
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"fl.shift_alpha must be in (0, 1], got {alpha!r}")
    has_ef = inner.client_init is not None
    inner_init = inner.client_init

    def client_init(params):
        d = dict(inner_init(params)) if inner_init is not None else {}
        d["h"] = tree_zeros_like(params)
        return d

    def apply(roundtrip, delta, st, key):
        h = {k: t.float() for k, t in st["h"].items()}
        src = {k: d.float() for k, d in delta.items()}
        if has_ef:
            src = {k: s + st["e"][k].float() for k, s in src.items()}
        c = roundtrip({k: s - h[k] for k, s in src.items()}, key)
        dhat = {k: h0 + c[k] for k, h0 in h.items()}
        st2 = {"h": {k: (h0 + alpha * c[k]).to(st["h"][k].dtype) for k, h0 in h.items()}}
        if has_ef:
            st2["e"] = {k: (s - dhat[k]).to(st["e"][k].dtype) for k, s in src.items()}
        return {k: dhat[k].to(d.dtype) for k, d in delta.items()}, st2

    return inner._replace(name=name or f"diana_{inner.name}", client_init=client_init,
                          apply=apply, direction="uplink")


def tree_roundtrip(codec: Codec) -> Callable:
    """``roundtrip(src, key)``: ``decode(encode(.))`` over a ``[C]``-stacked
    tree, wire leaf by wire leaf in the JAX package's order, each leaf on the
    subkey ``key_combine(key, leaf index)``."""

    def roundtrip(src: dict, key: torch.Tensor) -> dict:
        out = []
        for i, (path, v) in enumerate(to_wire(src)):
            ki = key_combine_torch(key, i)
            out.append((path, codec.decode(codec.encode(v, ki), ki, v)))
        return from_wire(out, src)

    return roundtrip


def uplink_apply(codec: Codec) -> Callable:
    """The cohort's uplink hook ``(deltas, state, keys) -> (delta_hat,
    state')`` over ``[C]`` stacks; ``state`` is ``{}`` for stateless codecs."""
    roundtrip = tree_roundtrip(codec)

    def apply(delta, st, key):
        if codec.apply is not None:
            return codec.apply(roundtrip, delta, st, key)
        if codec.client_init is None:
            return roundtrip(delta, key), st
        # error feedback: compress Delta + e (fp32), bank the new residual
        src = {k: d.float() + st["e"][k].float() for k, d in delta.items()}
        dhat = roundtrip(src, key)
        if codec.finalize is not None:
            ef2 = codec.finalize(src, dhat, st)
        else:
            ef2 = {"e": {k: s - dhat[k] for k, s in src.items()}}
        return {k: dhat[k].to(d.dtype) for k, d in delta.items()}, ef2

    return apply


def downlink_apply(codec: Codec) -> Callable:
    """The broadcast hook ``(params, ref [C], keys [C]) -> params_hat [C]``:
    each slot reconstructs ``ref + decode(encode(params - ref))``.
    ``identity`` broadcasts ``params`` itself (``ref + (x - ref)`` is not
    bitwise ``x`` in float)."""
    if codec.name == "identity":
        return lambda params, ref, key: {k: p.expand(ref[k].shape) for k, p in params.items()}
    roundtrip = tree_roundtrip(codec)

    def apply(params, ref, key):
        delta = {k: p.float() - ref[k].float() for k, p in params.items()}
        dhat = roundtrip(delta, key)
        return {k: (ref[k].float() + dhat[k]).to(p.dtype) for k, p in params.items()}

    return apply


# ---------------------------------------------------------------------------
# Wire accounting (direction-neutral)
# ---------------------------------------------------------------------------


def wire_bits_total(codec: Codec, tree: dict) -> float:
    """Bits one endpoint pays to ship a whole params-shaped payload (over the
    JAX package's leaves: chunk counts are per stacked leaf)."""
    return float(sum(codec.wire_bits(like) for _, like in wire_shapes(tree)))


def dense_bits(params: dict) -> float:
    """The uncompressed cost of shipping a params-shaped tree either way."""
    return float(sum(v.numel() * v.element_size() * 8 for v in params.values()))


def mbytes_per_slot(codec: Codec, params: dict, valid: torch.Tensor) -> torch.Tensor:
    """Per-slot megabytes on the wire this round ([C] fp32; padding pays 0)."""
    return valid.float() * float(np.float32(wire_bits_total(codec, params) / 8e6))


def validate_codec_knobs(fl: FLConfig, direction: str, *needs: str) -> dict:
    """Bind-time bounds checks for one direction's codec knob family
    (``"bits"``, ``"chunk"``, ``"frac"``, ``"backend"``); returns the
    validated values keyed by those short names."""
    if direction not in DIRECTIONS:
        raise ValueError(f"unknown codec direction {direction!r}; have {DIRECTIONS}")
    out: dict = {}
    for knob in needs:
        if knob == "backend":
            # one pack path for both directions: the wire format must match
            # whichever end decodes it
            if fl.uplink_backend not in qops.BACKENDS:
                raise ValueError(
                    f"unknown uplink_backend {fl.uplink_backend!r}; have {qops.BACKENDS}")
            out[knob] = fl.uplink_backend
            continue
        val = getattr(fl, f"{direction}_{knob}")
        if knob == "bits" and val not in BITS_CHOICES:
            raise ValueError(f"fl.{direction}_bits must be one of {BITS_CHOICES}, got {val!r}")
        if knob == "chunk" and val < 1:
            raise ValueError(f"fl.{direction}_chunk must be >= 1, got {val!r}")
        if knob == "frac" and not 0.0 < val <= 1.0:
            raise ValueError(f"fl.{direction}_frac must be in (0, 1], got {val!r}")
        out[knob] = val
    return out


# ---------------------------------------------------------------------------
# Built-in codec factories: make(fl, direction) -> Codec
# ---------------------------------------------------------------------------


def make_identity(fl: FLConfig, direction: str = "uplink") -> Codec:
    """Exact pass-through (the round driver skips it entirely)."""
    return Codec(name="identity", encode=lambda v, key: {"v": v},
                 decode=lambda p, key, like: p["v"],
                 wire_bits=lambda like: like.numel() * like.element_size() * 8)


def _frac_k(frac: float, n: int) -> int:
    return max(1, min(n, int(round(frac * n))))


def make_qsgd(fl: FLConfig, direction: str = "uplink") -> Codec:
    """QSGD stochastic quantization to ``{direction}_bits`` signed levels,
    one fp32 scale per ``{direction}_chunk`` values, through
    ``kernels.quantize`` (``uplink_backend`` picks the path of both
    directions; the two give the same bytes)."""
    k = validate_codec_knobs(fl, direction, "bits", "chunk", "backend")
    bits, chunk, backend = k["bits"], k["chunk"], k["backend"]
    pb = packed_width(chunk, bits)           # validates chunk % (8//bits)

    def encode(v, key):
        nc = num_chunks(v.shape[1], chunk)
        keys = key_combine_torch(key[:, None], torch.arange(nc, device=v.device)[None, :])
        packed, scale = qops.quantize_pack(v.float().contiguous(), keys, chunk=chunk,
                                           bits=bits, backend=backend)
        return {"q": packed, "s": scale}

    def decode(p, key, like):
        return qops.unpack_dequantize(p["q"], p["s"], n=like.shape[1], chunk=chunk,
                                      bits=bits, backend=backend).to(like.dtype)

    def wire_bits(like):
        nc = num_chunks(like.numel(), chunk)
        return nc * pb * 8 + nc * 32         # packed levels + fp32 scales

    return Codec("qsgd", encode, decode, wire_bits, seeded=True)


def make_topk_raw(fl: FLConfig, direction: str = "uplink") -> Codec:
    """Magnitude top-k per wire leaf: the k largest-|.| values plus their
    int32 positions (biased; the registered ``topk`` adds error feedback)."""
    frac = validate_codec_knobs(fl, direction, "frac")["frac"]

    def encode(v, key):
        flat = v.float()
        idx = torch.topk(flat.abs(), _frac_k(frac, flat.shape[1]), dim=1).indices
        return {"v": torch.gather(flat, 1, idx), "i": idx.to(torch.int32)}

    def decode(p, key, like):
        out = torch.zeros(like.shape, dtype=torch.float32, device=like.device)
        return out.scatter_(1, p["i"].long(), p["v"]).to(like.dtype)

    def wire_bits(like):
        return _frac_k(frac, like.numel()) * (32 + 32)   # fp32 value + int32 pos

    return Codec("topk_raw", encode, decode, wire_bits)


def make_randk(fl: FLConfig, direction: str = "uplink") -> Codec:
    """Random-k sparsification with the unbiased ``n/k`` scaling: the first k
    outputs of the swap-or-not permutation of ``[0, n)`` under each slot's
    key, which the decoder regenerates (values-only wire)."""
    frac = validate_codec_knobs(fl, direction, "frac")["frac"]
    rounds = fl.rr_rounds

    def _idx(key, n: int):
        x = torch.arange(_frac_k(frac, n), dtype=torch.int64, device=key.device)[None, :]
        return swap_or_not_torch(x, n, key[:, None], rounds)         # [C, k]

    def encode(v, key):
        return {"v": torch.gather(v.float(), 1, _idx(key, v.shape[1]))}

    def decode(p, key, like):
        n = like.shape[1]
        scale = float(np.float32(n / _frac_k(frac, n)))
        out = torch.zeros(like.shape, dtype=torch.float32, device=like.device)
        return out.scatter_(1, _idx(key, n), p["v"] * scale).to(like.dtype)

    def wire_bits(like):
        return _frac_k(frac, like.numel()) * 32          # values only

    return Codec("randk", encode, decode, wire_bits, seeded=True)


# ---------------------------------------------------------------------------
# Registry: name -> CodecEntry(make, declared direction)
# ---------------------------------------------------------------------------


class CodecEntry(NamedTuple):
    """One :data:`CODECS` record: the factory plus its declared direction.
    ``entry(fl, direction)`` builds the codec; factories without a
    ``direction`` parameter are called as ``make(fl)``."""

    make: Callable
    direction: str = "both"

    def __call__(self, fl: FLConfig, direction: str = "uplink") -> Codec:
        make = self.make
        if isinstance(make, CodecEntry):      # an entry re-registered as-is
            return make(fl, direction)
        try:
            wants = "direction" in inspect.signature(make).parameters
        except (TypeError, ValueError):
            wants = False
        return make(fl, direction) if wants else make(fl)


CODECS: dict[str, CodecEntry] = {
    "identity": CodecEntry(make_identity, "both"),
    "qsgd": CodecEntry(make_qsgd, "both"),
    "topk": CodecEntry(lambda fl, direction="uplink": with_error_feedback(
        make_topk_raw(fl, direction), name="topk"), "uplink"),
    "randk": CodecEntry(make_randk, "both"),
    "ef_qsgd": CodecEntry(lambda fl, direction="uplink": with_error_feedback(
        make_qsgd(fl, direction)), "uplink"),
    "ef_randk": CodecEntry(lambda fl, direction="uplink": with_error_feedback(
        make_randk(fl, direction)), "uplink"),
    "diana_qsgd": CodecEntry(lambda fl, direction="uplink": with_diana_shift(
        make_qsgd(fl, direction), fl.shift_alpha), "uplink"),
    "diana_randk": CodecEntry(lambda fl, direction="uplink": with_diana_shift(
        make_randk(fl, direction), fl.shift_alpha), "uplink"),
    "diana_topk": CodecEntry(lambda fl, direction="uplink": with_diana_shift(
        with_error_feedback(make_topk_raw(fl, direction)), fl.shift_alpha,
        name="diana_topk"), "uplink"),
}


def register_codec(name: str, make: Callable, *, direction: str = "both",
                   overwrite: bool = False) -> None:
    """Register ``make(fl[, direction]) -> Codec`` under ``name``.  A codec
    keeping per-client state (EF, DIANA) is uplink-only, and declaring it
    for the downlink is rejected here."""
    if direction not in ("uplink", "downlink", "both"):
        raise ValueError(f"codec direction must be 'uplink', 'downlink' or 'both', "
                         f"got {direction!r}")
    if not overwrite and name in CODECS:
        raise ValueError(f"codec {name!r} already registered (pass overwrite=True to replace)")
    entry = CodecEntry(make, direction)
    if direction != "uplink":
        try:
            probe = entry(FLConfig())
        except Exception:
            probe = None     # needs non-default knobs; build_codec checks at bind time
        if probe is not None and (probe.client_init is not None or probe.direction == "uplink"):
            raise ValueError(
                f"codec {name!r} declares direction={direction!r} but keeps per-client "
                f"compressor state (an error-feedback residual or DIANA shift), which "
                f"lives on the client while the downlink encoder is the server; register "
                f"it with direction='uplink' or drop the stateful wrapper.")
    CODECS[name] = entry


def build_codec(fl: FLConfig, direction: str = "uplink") -> Codec:
    """Resolve one direction's configured codec (unknown names,
    direction-incapable codecs and bad knob values raise here)."""
    if direction not in DIRECTIONS:
        raise ValueError(f"unknown codec direction {direction!r}; have {DIRECTIONS}")
    name = getattr(fl, direction)
    if name not in CODECS:
        raise ValueError(f"unknown {direction} codec {name!r}; have {sorted(CODECS)}")
    entry = CODECS[name]
    if entry.direction not in ("both", direction):
        capable = sorted(n for n, e in CODECS.items() if e.direction in ("both", direction))
        raise ValueError(f"fl.{direction}={name!r}, but codec {name!r} is registered "
                         f"{entry.direction}-only; {direction}-capable codecs: {capable}")
    codec = entry(fl, direction)
    if direction == "downlink" and (codec.client_init is not None or codec.direction == "uplink"):
        raise ValueError(
            f"fl.downlink={name!r} resolves to a codec keeping per-client compressor "
            f"state (error feedback / DIANA shift), which cannot ride the server's "
            f"broadcast; use a stateless downlink codec (e.g. 'identity', 'qsgd', 'randk').")
    return codec
