"""Config system: model architecture and FL hyperparameters (the port's copy).

The same frozen dataclasses as ``repro.configs.base``, cut to the fields
this port implements: ``ArchConfig`` for the dense, vlm (a patch prefix on
the dense family), hybrid (attention + Mamba2 SSD, ``SSMConfig``) and audio
(encoder-decoder) families with ``reduced()``, and
``FLConfig`` with the knobs of every plane: comm, fleet, robust, privacy
and obs.  It has 70 of the JAX package's 71 fields; the unused
``aggregation`` is left out.  Shared fields keep
the JAX package's names and defaults, so one keyword dict builds both
configs, with one exception: ``uplink_backend`` takes ``"kernel"`` (the
default: the CUDA kernel for a CUDA tensor, the plain torch version for a
CPU tensor) or ``"ref"`` (the plain torch version on any device) where the
JAX package takes ``"pallas"`` / ``"ref"``.  A default of ``"ref"`` would
keep the kernel off the card's main path.  Every server opt (``sgd``,
``momentum``, ``mvr``, ``adam``, ``scaffold``) and local update (``sgd``,
``mvr``, ``scaffold``, ``fedprox`` with ``prox_mu``, ``local_clip`` with
``clip_norm``) binds.  The cohort engine's knobs bind at the JAX package's
defaults (``prefetch=2``, ``participation="iid"``; all four schedules).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD (arXiv:2405.21060)."""

    state_dim: int = 128           # N
    head_dim: int = 64             # P
    num_heads: int = 0             # 0 => derived: expand*d_model/head_dim
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256               # SSD chunk length


@dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str = "unnamed"
    family: Family = "dense"
    citation: str = ""

    # core transformer dims
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 => d_model // n_heads
    d_ff: int = 1024
    vocab: int = 32000

    # attention details
    qkv_bias: bool = False
    rope_kind: Literal["full", "half", "none"] = "full"  # "half" = ChatGLM 2d RoPE
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 => full causal attention

    # optional feature blocks
    ssm: SSMConfig | None = None
    hybrid: bool = False           # Hymba parallel attn+SSM heads

    # encoder-decoder (audio) / multimodal stubs
    enc_layers: int = 0            # >0 => encoder-decoder
    src_frames: int = 1024         # audio frontend stub: #frame embeddings
    num_patches: int = 0           # vlm frontend stub: #patch embeddings

    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests (<=2 layers etc.),
        with the JAX package's defaults: fp32, SSM chunk 32, 2 encoder
        layers over 32 frames, 16 patches, window 64."""
        small: dict = dict(
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            d_ff=min(self.d_ff, 256),
            vocab=min(self.vocab, 512),
            head_dim=32 if self.head_dim else 0,
        )
        small["n_kv_heads"] = min(self.n_kv_heads, small["n_heads"])
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 16), head_dim=32, num_heads=0, chunk=32
            )
        if self.enc_layers:
            small["enc_layers"] = 2
            small["src_frames"] = 32
        if self.num_patches:
            small["num_patches"] = 16
        if self.sliding_window:
            small["sliding_window"] = 64
        small["dtype"] = "float32"
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# FL configuration (the paper's knobs)
# ---------------------------------------------------------------------------

Algorithm = Literal[
    "fedshuffle", "fedavg", "fedavg_so", "fedshuffle_so", "fednova", "fedavg_min",
    "fedavg_mean", "gen",
]
Sampling = Literal["full", "uniform", "independent"]
ServerOpt = Literal["sgd", "momentum", "mvr", "adam", "scaffold"]
CohortMode = Literal["vmapped", "sequential"]
Engine = Literal["legacy", "cohort"]
# Round-batch layout the round step executes:
#   padded   — one [C, K_max] masked loop for the whole cohort (reference)
#   bucketed — slots partitioned into static step buckets; one [C_b, K_b]
#              loop per bucket, results reassembled in slot order so every
#              aggregate is bitwise-identical to the padded layout
ExecMode = Literal["padded", "bucketed"]
# Where the RR index matrices [C, K_max, B] come from:
#   host         — numpy PCG permutations per cohort client (bitwise-identical
#                  to the legacy FederatedPipeline path)
#   host_feistel — the numpy mirror of the swap-or-not cipher
#   device_ref   — the cipher's plain torch version, on the device
#   device       — the cipher as the CUDA kernel (plain torch on a CPU tensor)
RRBackend = Literal["host", "host_feistel", "device_ref", "device"]
# The qsgd pack path of both wire directions: the CUDA kernel for a CUDA
# tensor (plain torch on a CPU tensor), or the plain torch version anywhere
UplinkBackend = Literal["kernel", "ref"]
# Heterogeneous fleet plane (repro_torch.fed.fleet).  Fleet model (FLEETS
# registry; extensible via register_fleet, hence plain str):
#   "homogeneous"  — unit speed, zero latency (with server_mode="sync" and no
#                    faults the fleet plane is fully off — bitwise-frozen)
#   "tiered"       — fleet_tiers discrete device tiers, speeds 1..1/tier_spread
#   "zipf_latency" — Pareto(zipf_alpha)-tailed per-client latency (stragglers)
# Fault scenarios ride FLConfig.faults as a comma-separated list of FAULTS
# registry names ("dropout,straggler,abort"), each with its knobs below.
# Server aggregation mode:
#   "sync"     — the classic synchronous round (the default; frozen contract)
#   "buffered" — FedBuff-style async: cohort_size clients in flight, the
#                server aggregates the first buffer_size arrivals per virtual
#                tick, late updates discounted by the staleness weighting
ServerMode = Literal["sync", "buffered"]
Staleness = Literal["constant", "poly"]
# Observability plane (repro_torch.obs).  "off" (the default): no new metric
# keys, bitwise-identical rounds.  "metrics": the round emits fixed-shape
# distribution summaries (hist_* keys: per-client step counts, update norms,
# staleness, wire bytes, the DP clip scale) and train() folds them into a
# metric registry; "trace": only the host spans (no-ops until a tracer is
# installed, obs.trace.capture or train(telemetry_dir=)); "full": both.
Telemetry = Literal["off", "metrics", "trace", "full"]
# Byzantine-robustness plane (repro_torch.fed.robust).  The defaults
# (attack="none", aggregator="mean", guard="off") keep the plane fully off.
# Attacks (ATTACKS: sign_flip, zero_update, scaled_noise, ipm) rewrite the
# slot-order delta stack before the uplink codec; aggregators (ROBUST_AGGS:
# mean, coordinate_median, trimmed_mean, norm_clip, centered_clip, krum,
# multi_krum) combine over the strategy's bound coefficients on the
# weighted_sum scale; guards: "quarantine" (per-client NaN/Inf/norm-spike
# removal with coefficient renormalization), "reject" (revert a blown
# round's state; the round counter still advances), "full" (both).
Guard = Literal["off", "quarantine", "reject", "full"]
# Privacy plane (repro_torch.fed.privacy).  The defaults (dp="off",
# secagg="off") keep the plane off: no op, no metric key.  dp="on": each
# shipped client update is L2-clipped to dp_clip, and Gaussian noise with
# sigma = dp_noise_mult * dp_clip * max_i |coeff_i| is added to the weighted
# aggregate, drawn counter-based per (seed, round); the host RDP accountant
# reports the cumulative eps(dp_delta) as "dp_epsilon".  secagg="pairwise":
# the weighted updates are encoded in uint32 fixed point (secagg_bits
# fractional bits, after the uplink codec) and blinded with seeded pairwise
# masks that cancel exactly in the modular sum; dropped clients' shares are
# recovered.  It needs aggregator="mean" and no quarantine guard.
DP = Literal["off", "on"]
Secagg = Literal["off", "pairwise"]


@dataclass(frozen=True)
class FLConfig:
    # population
    num_clients: int = 8
    cohort_size: int = 4           # expected #participating clients b
    sampling: Sampling = "uniform"
    # local work
    epochs: int = 1                # E (same for all unless epochs_max > epochs)
    epochs_max: int = 0            # >epochs => E_i ~ U{epochs..epochs_max} per round
    local_batch: int = 1
    k_max: int = 0                 # 0 => derived from data sizes at pipeline build
    # algorithm
    algorithm: Algorithm = "fedshuffle"
    reshuffle: bool = True         # RR vs with-replacement local sampling
    # step sizes
    local_lr: float = 0.1
    server_lr: float = 1.0
    # server optimizer
    server_opt: ServerOpt = "sgd"
    momentum: float = 0.9          # used by "momentum"
    mvr_a: float = 0.1             # MVR a parameter
    mvr_exact: bool = False        # exact eq.(13-14) vs practical approx (App. F)
    local_update: str = ""         # "" => server opt's paired default
    prox_mu: float = 0.1           # fedprox proximal coefficient
    clip_norm: float = 1.0         # local_clip per-step direction-norm bound
    # cohort execution
    cohort_mode: CohortMode = "vmapped"
    accum_dtype: str = "float32"   # sequential-mode delta accumulator dtype
    # execution layout (padding-free bucketed loops for imbalanced local work)
    exec_mode: ExecMode = "padded"
    buckets: int = 4               # max step buckets when exec_mode="bucketed"
    # cohort engine (device-resident data plane; repro_torch.fed.cohort)
    engine: Engine = "legacy"      # "cohort" => device-resident data plane
    rr_backend: RRBackend = "host"
    rr_rounds: int = 24            # swap-or-not cipher rounds (device/feistel RR)
    prefetch: int = 2              # rounds sampled ahead (cohort engine)
    participation: str = "iid"     # cohort schedule (fed.cohort.scheduler)
    # communication plane (repro_torch.fed.comm): each direction routes its
    # own knob family through the shared per-direction validator at bind time
    uplink: str = "identity"       # codec name (key into fed.comm.CODECS)
    uplink_bits: int = 4           # qsgd: bits per value (2 | 4 | 8)
    uplink_chunk: int = 256        # qsgd: values per fp32 scale
    uplink_frac: float = 0.1       # topk/randk: fraction of coords shipped
    uplink_backend: UplinkBackend = "kernel"  # quantize pack path, both directions
    shift_alpha: float = 0.5       # diana_*: shift lr, h += alpha * C(d - h)
    # downlink broadcast (reference-compressed; "identity" keeps the dense
    # broadcast and the op sequence of the plane-off path exactly)
    downlink: str = "identity"     # downlink-capable codec name
    downlink_bits: int = 4         # qsgd: bits per value (2 | 4 | 8)
    downlink_chunk: int = 256      # qsgd: values per fp32 scale
    downlink_frac: float = 0.1     # randk: fraction of coords shipped
    # heterogeneous fleet plane (device tiers, fault injection, async server;
    # see the ServerMode note above and repro_torch.fed.fleet) — the defaults
    # keep the synchronous path bitwise-frozen
    fleet: str = "homogeneous"     # device-tier model (key into fed.fleet.FLEETS)
    fleet_tiers: int = 3           # tiered: number of device speed tiers
    tier_spread: float = 4.0       # tiered: slowest/fastest speed ratio (>= 1)
    tier_latency: float = 1.0      # base per-round latency (virtual-time units)
    zipf_alpha: float = 1.2        # zipf_latency: Pareto tail exponent
    faults: str = ""               # comma-separated fed.fleet.FAULTS scenarios
    drop_prob: float = 0.0         # "dropout": per-(client, round) failure prob
    straggler_prob: float = 0.0    # "straggler": P(round slowed by the factor)
    straggler_factor: float = 8.0  # "straggler": wall-time multiplier (>= 1)
    round_deadline: float = 0.0    # "abort": virtual-time budget cutting steps
    server_mode: ServerMode = "sync"
    buffer_size: int = 16          # buffered: aggregate first K arrivals/tick
    staleness: Staleness = "poly"  # buffered staleness discount kind
    staleness_power: float = 0.5   # poly: weight = (1 + tau) ** -staleness_power
    # observability plane (spans, metric registry, in-round histograms; see
    # the Telemetry note above and repro_torch.obs): "off" adds nothing
    telemetry: Telemetry = "off"
    telemetry_bins: int = 16       # bins per in-round histogram (static shapes)
    # byzantine-robustness plane (adversarial clients, robust aggregation,
    # self-healing guards; see the Guard note above and repro_torch.fed.robust)
    # — the defaults keep the plane bitwise-frozen off
    attack: str = "none"           # adversary model (key into robust.ATTACKS)
    attack_frac: float = 0.0       # expected adversarial fraction of clients
    attack_scale: float = 1.0      # attack magnitude multiplier
    aggregator: str = "mean"       # server combiner (key into robust.ROBUST_AGGS)
    trim_frac: float = 0.1         # trimmed_mean/krum breakdown parameter (0, 0.5)
    guard: Guard = "off"           # self-healing guards (quarantine/reject/full)
    # privacy plane (DP clip + noise + RDP accountant, secure-aggregation
    # simulation; see the DP/Secagg note above and repro_torch.fed.privacy)
    dp: DP = "off"                 # DP-FedShuffle mechanism (clip + noise + eps)
    dp_clip: float = 1.0           # per-update L2 clip bound (DP sensitivity C)
    dp_noise_mult: float = 1.0     # noise multiplier z: sigma = z * sensitivity
    dp_delta: float = 1e-5         # target delta for the eps(delta) report
    secagg: Secagg = "off"         # pairwise-mask secure-aggregation simulation
    secagg_bits: int = 16          # fixed-point fractional bits (1..30)
    # system heterogeneity (Fig. 4): every client is cut short by this many
    # local steps (planned vs actual); the "gen" hybrid algorithm corrects it
    drop_last_steps: int = 0
    # data imbalance
    imbalance: Literal["equal", "lognormal", "zipf"] = "lognormal"
    min_samples: int = 2
    mean_samples: int = 8
    seed: int = 0
