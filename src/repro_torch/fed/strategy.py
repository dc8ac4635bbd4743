"""Composable federated strategies — the paper's Algorithm 4 as an API.

A :class:`FedStrategy` declares the round recipe as a composition of

* a **(c, w~, q) parametrization** (:class:`~repro_torch.core.algorithms.GenSpec`):
  local step-size normalization, aggregation weighting and normalization;
* a **server optimizer** from :data:`SERVER_OPTS` (``sgd`` / ``momentum``
  / ``scaffold``, declared as a :func:`chain` of pseudo-update transforms,
  and the bespoke ``mvr`` (FedShuffleMVR) and ``adam`` updates);
* a **local update rule** from :data:`LOCAL_UPDATES`: a
  :class:`~repro_torch.core.local.ClientChain` of per-step client
  transforms (plain RR-SGD is the empty chain; the MVR-corrected steps,
  SCAFFOLD's control variates, FedProx and per-step clipping are links).
  Transforms may keep persistent per-client state, banked ``[N+1, ...]`` on
  ``ServerState.clients`` beside the comm plane's; binding validates that
  every opt-state key a chain ``needs`` is ``provide``-d by the server opt,
  and that a server opt's ``consumes`` are kept by the chain;
* optionally an **equalized-step pipeline mode** (``fedavg_min`` /
  ``fedavg_mean``), which the data pipeline applies.

:func:`bind_strategy` closes a strategy over a concrete ``FLConfig`` and
``loss_fn`` and yields the hooks the round driver (``repro_torch.fed.rounds``)
calls, the comm plane's two codecs (``fl.uplink`` / ``fl.downlink``,
``repro_torch.fed.comm``) and the per-client state they keep included, the
fleet plane's buffered server (``fl.server_mode="buffered"``: tick-sized,
staleness-discounted coefficients and its counters in the bank,
``repro_torch.fed.fleet``) and the robust plane's combiner
(``fl.aggregator``, ``repro_torch.fed.robust``).  Binding also validates
the telemetry knobs and, with the privacy plane on, its knobs against the
resolved chain (``repro_torch.fed.privacy``).  The port's counterpart of
``repro.fed.strategy``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, NamedTuple

import torch

from ..configs.base import FLConfig
from ..core import algorithms as _alg
from ..core.algorithms import GenSpec, PRESETS, agg_coeff, lr_scale
from ..core.local import (ClientChain, build_cohort_step, build_local_step,
                          chain_client_template, cohort_full_local_gradient, cohort_loss,
                          full_local_gradient, resolve_chain)
from ..data.federated import BucketedBatch
from ..kernels.server_update.ops import apply_fused_update
from ..utils.pytree import tree_copy, tree_map, tree_zeros_like
from .bucketing import run_buckets, slot_inputs
from .comm import DOWNLINK_STATE_KEY, UPLINK_STATE_KEY, build_codec
from ..obs import validate_telemetry_config
from .fleet import (FLEET_STATE_KEY, fleet_active, fleet_client_state, staleness_weights,
                    validate_fleet_config)
from .privacy import privacy_active, validate_privacy_config
from .robust import build_robust_aggregate, robust_active, validate_robust_config
from .server import ServerState


class CohortState(NamedTuple):
    """The cohort's rows of the per-client state bank, in [C] slot order:
    ``old`` as gathered at round start, ``new`` as committed (a padding slot
    carries ``old``, so ``new - old`` is exactly zero there), keyed like
    ``ServerState.clients`` ({name: {field: tree with [C, ...] leaves}}).
    Server transforms fold it into server state (SCAFFOLD's c)."""

    old: Any
    new: Any


class RoundCtx(NamedTuple):
    """Round inputs a server update may need beyond the delta: ``batch`` is
    the device RoundBatch (data / step_mask / meta), ``lr_mult`` the
    schedule multiplier (a 0-dim tensor on the device), and ``momentum`` the
    momentum tree the clients used this round (zeros when the optimizer
    keeps none).  ``cstate`` is the cohort's :class:`CohortState` when a
    plane keeps per-client state (None otherwise).  A None ctx (the legacy
    :func:`repro_torch.fed.server.apply_server` path) applies only the
    parameter step of the optimizer."""

    batch: Any
    lr_mult: Any
    momentum: Any
    cstate: Any = None


# ---------------------------------------------------------------------------
# Local update registry: name -> ClientChain (a declared composition of
# client transforms; see core.local) or, legacy, a raw factory
# make(loss_fn, fl) -> one_client(params, momentum, data, mask, eta).
# ---------------------------------------------------------------------------

LOCAL_UPDATES: dict[str, "ClientChain | Callable"] = {
    "sgd": ClientChain("sgd", ()),
    "mvr": ClientChain("mvr", ("mvr",)),
    "scaffold": ClientChain("scaffold", ("scaffold",)),
    "fedprox": ClientChain("fedprox", ("prox",)),
    "local_clip": ClientChain("local_clip", ("clip",)),
}


def register_local_update(name: str, make: "ClientChain | Callable", *,
                          overwrite: bool = False) -> None:
    """Register a local-update rule: a :class:`~repro_torch.core.local.ClientChain`
    (composable, may keep per-client state) or the legacy raw factory
    ``make(loss_fn, fl) -> one_client(params, momentum, data, mask, eta) ->
    (delta, loss)``."""
    if not overwrite and name in LOCAL_UPDATES:
        raise ValueError(
            f"local update {name!r} already registered (pass overwrite=True to replace)")
    LOCAL_UPDATES[name] = make


class CompiledLocal(NamedTuple):
    """A LOCAL_UPDATES entry closed over (loss_fn, fl): the per-client and
    the cohort step (``core.local``'s signatures), one client's state
    template (None for a stateless rule), the opt-state keys it needs, its
    stateful transforms' names and all its transforms' names."""

    local_step: Callable
    cohort_step: Callable
    client_template: Callable | None
    needs: tuple
    state_names: tuple
    transform_names: tuple


def _compile_local(entry: "ClientChain | Callable", loss_fn: Callable,
                   fl: FLConfig) -> CompiledLocal:
    if isinstance(entry, ClientChain):
        transforms = resolve_chain(entry, loss_fn, fl)
        # the batched cohort step's links see stacked [C] points: their loss
        # is the cohort's (per-slot gradients through one autograd pass)
        cohort_transforms = resolve_chain(entry, cohort_loss(loss_fn), fl)
        return CompiledLocal(
            build_local_step(transforms, loss_fn),
            build_cohort_step(cohort_transforms, loss_fn),
            chain_client_template(transforms),
            tuple(dict.fromkeys(k for t in transforms for k in t.needs)),
            tuple(t.name for t in transforms if t.client_init is not None),
            tuple(t.name for t in transforms))
    inner = entry(loss_fn, fl)        # legacy raw rule: stateless, opt-blind

    def one_client(params, momentum, opt, data, mask, eta, cstate):
        delta, loss = inner(params, momentum, data, mask, eta)
        return delta, loss, cstate

    def cohort(params, momentum, opt, data, mask, eta, cstate, *, stacked=False):
        # a raw rule has no batched form: slot by slot, stacked
        outs = [inner({k: v[c] for k, v in params.items()} if stacked else params, momentum,
                      {k: v[c] for k, v in data.items()}, mask[c], eta[c])
                for c in range(mask.shape[0])]
        return ({k: torch.stack([d[k] for d, _ in outs]) for k in outs[0][0]},
                torch.stack([loss for _, loss in outs]), cstate)

    return CompiledLocal(one_client, cohort, None, (), (), ())


# ---------------------------------------------------------------------------
# Server optimizers: a chain of pseudo-update transforms followed by the
# canonical descent application ``x <- x + (lr * delta').to(x.dtype)``.
# ---------------------------------------------------------------------------


class ServerTransform(NamedTuple):
    """One link of a server chain: ``init(fl, params) -> opt-state slice``
    and ``update(fl, delta, opt, state, ctx) -> (delta', opt-state
    updates)`` (``ctx`` a :class:`RoundCtx`, or None on the legacy path).
    ``provides`` names the opt-state keys ``init`` creates plus any semantic
    capability tags; client transforms declare what they ``need`` against
    these, and binding validates the pairing.  ``consumes`` names the
    stateful client transforms whose cohort state the update folds in."""

    init: Callable
    update: Callable
    provides: tuple = ()
    consumes: tuple = ()


def heavy_ball() -> ServerTransform:
    """Classic heavy-ball: m <- beta*m + Delta; the chain then applies lr*m."""

    def init(fl: FLConfig, params):
        return {"m": tree_zeros_like(params)}

    def update(fl: FLConfig, delta, opt, state, ctx):
        m = {k: fl.momentum * opt["m"][k] + d for k, d in delta.items()}
        return m, {"m": m}

    return ServerTransform(init, update, provides=("m",))


def scaffold_ctl() -> ServerTransform:
    """SCAFFOLD's server control variate: ``c <- c + sum_{i in S} (w_i/p_i)
    * (c_i+ - c_i)``, the w/p-debiased estimate of the population drift of
    the per-client variates the cohort just committed (the paired
    ``scaffold`` client transform).  The pseudo-update passes through."""

    def init(fl: FLConfig, params):
        return {"c": tree_zeros_like(params)}

    def update(fl: FLConfig, delta, opt, state, ctx):
        if ctx is None or ctx.cstate is None:
            return delta, {}
        meta = ctx.batch.meta
        wp = (meta.valid * meta.weight / meta.prob).float()              # [C]
        old, new = ctx.cstate.old["scaffold"]["c"], ctx.cstate.new["scaffold"]["c"]
        c = {k: (c0.float() + torch.einsum("c,c...->...", wp, new[k].float() - old[k].float())
                 ).to(c0.dtype) for k, c0 in opt["c"].items()}
        return delta, {"c": c}

    return ServerTransform(init, update, provides=("c",), consumes=("scaffold",))


class ServerOpt(NamedTuple):
    """A registered server optimizer: ``init(fl, params) -> opt dict`` and
    ``make_update(fl, gen, loss_fn, cohort_mode) -> update(state, delta_agg,
    lr, ctx) -> ServerState`` (``ctx`` a :class:`RoundCtx`; ``cohort_mode``
    as the round driver runs the cohort); ``local_update`` names the
    client-side rule it pairs with by default.  ``provides`` lists the
    opt-state keys / capability tags client transforms may ``need``;
    ``consumes`` the stateful client transforms whose cohort state the
    update reads (binding refuses chains missing them)."""

    name: str
    init: Callable
    make_update: Callable
    local_update: str = "sgd"
    provides: tuple = ()
    consumes: tuple = ()


def chain(name: str, *transforms: ServerTransform, local_update: str = "sgd") -> ServerOpt:
    """Compose pseudo-update transforms into a server optimizer ending in the
    descent application ``x <- x + (lr * delta').to(x.dtype)``."""

    def init(fl: FLConfig, params) -> dict:
        opt: dict = {}
        for t in transforms:
            new = t.init(fl, params)
            dup = set(new) & set(opt)
            if dup:
                raise ValueError(
                    f"server chain {name!r}: transforms collide on opt-state "
                    f"keys {sorted(dup)}")
            opt.update(new)
        return opt

    def make_update(fl: FLConfig, gen: GenSpec, loss_fn, cohort_mode):
        def update(state: ServerState, delta_agg, lr, ctx) -> ServerState:
            opt = dict(state.opt)
            d = delta_agg
            for t in transforms:
                d, new = t.update(fl, d, opt, state, ctx)
                opt.update(new)
            p = {k: a + (lr * d[k]).to(a.dtype) for k, a in state.params.items()}
            return ServerState(params=p, opt=opt, rnd=state.rnd + 1)

        return update

    provides = tuple(dict.fromkeys(k for t in transforms for k in t.provides))
    consumes = tuple(dict.fromkeys(k for t in transforms for k in t.consumes))
    return ServerOpt(name, init, make_update, local_update, provides, consumes)


def _mvr_opt() -> ServerOpt:
    """FedShuffleMVR (§5.1): x still moves by +lr*Delta, but the server
    maintains the gradient estimate m of eq. 14 (exact) or its App. F
    approximation, which clients consume in their corrected local steps.

    App. F runs as one launch of the fused ``server_update`` kernel over all
    parameter tensors (the plain torch version on the CPU), with ``1/eta_l``
    formed on the device: no host synchronisation.  It multiplies by that
    reciprocal where the JAX package divides by ``eta_l``, so m agrees with
    the JAX package's to an ulp of ``ghat``, not bitwise.  The exact eq. 14
    step is torch and uses no kernel: its full local gradients run client by
    client in the sequential cohort mode and batched over the cohort in the
    vmapped one (a bucket at a time in the bucketed layout, reassembled to
    the [C] slot-order stack before the weighted sum)."""

    def init(fl: FLConfig, params) -> dict:
        opt = {"m": tree_zeros_like(params)}    # gradient estimate (eq. 14)
        if fl.mvr_exact:
            # own buffers: params is also ServerState.params
            opt["x_prev"] = tree_copy(params)
        return opt

    def make_update(fl: FLConfig, gen: GenSpec, loss_fn, cohort_mode):
        def update(state: ServerState, delta_agg, lr, ctx) -> ServerState:
            opt = dict(state.opt)
            if ctx is None:
                # the legacy path: the parameter step alone
                p = {k: x + (lr * delta_agg[k]).to(x.dtype) for k, x in state.params.items()}
                return ServerState(params=p, opt=opt, rnd=state.rnd + 1)
            batch, meta, momentum = ctx.batch, ctx.batch.meta, ctx.momentum
            if fl.mvr_exact:
                wp = meta.valid * meta.weight / meta.prob              # [C]

                def grads_at(p):
                    # sum_i (valid w/p)_i * grad f_i(p), fp32
                    if cohort_mode == "vmapped":
                        if isinstance(batch, BucketedBatch):
                            # per bucket, reassembled to the [C] slot-order
                            # stack (zeros where no bucket holds a slot)
                            gs = run_buckets(
                                lambda data, mask: cohort_full_local_gradient(loss_fn, p, data, mask),
                                batch, {k: v.float() for k, v in p.items()})
                        else:
                            gs = cohort_full_local_gradient(loss_fn, p, batch.data,
                                                            batch.step_mask)
                        return {k: torch.einsum("c,c...->...", wp.float(), g)
                                for k, g in gs.items()}
                    # sequential: slot order; a slot no bucket holds adds 0
                    acc = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in p.items()}
                    for c, inputs in enumerate(slot_inputs(batch)):
                        if inputs is not None:
                            g = full_local_gradient(loss_fn, p, *inputs)
                            acc = {k: A + wp[c] * g[k] for k, A in acc.items()}
                    return acc

                g_x = grads_at(state.params)
                g_prev = grads_at(opt["x_prev"])
                # m_new = G_x + (1-a) * (m - G_prev)   [= eq. 14 rearranged]
                opt["m"] = {k: g_x[k] + (1.0 - fl.mvr_a) * (momentum[k].float() - g_prev[k])
                            for k in g_x}
                opt["x_prev"] = state.params
                p = {k: x + (lr * delta_agg[k]).to(x.dtype) for k, x in state.params.items()}
            else:
                # App. F: the gradient estimate from the aggregated update.
                # With FedShuffle's c_i = K_i, Delta_i ~= -eta_l * mean
                # grad_i, so g_hat = -Delta_agg / eta_l.  For unscaled-step
                # strategies (c_i = 1), Delta_i ~= -eta_l * K_i * mean grad_i,
                # so divide by the cohort-average step count too.
                eta_l = fl.local_lr * ctx.lr_mult
                if gen.c == "one":
                    wp_sum = torch.clamp_min(
                        torch.sum(meta.valid * meta.weight / meta.prob), 1e-9)
                    k_bar = torch.sum(meta.valid * (meta.weight / meta.prob)
                                      * meta.num_steps) / wp_sum
                    eta_l = eta_l * k_bar
                p, opt["m"] = apply_fused_update(
                    state.params, delta_agg, {k: v.float() for k, v in momentum.items()},
                    eta_g=lr, a=fl.mvr_a, inv_eta_l=torch.reciprocal(eta_l))
            return ServerState(params=p, opt=opt, rnd=state.rnd + 1)

        return update

    return ServerOpt("mvr", init, make_update, local_update="mvr",
                     provides=("m", "grad_estimate"))


def _adam_opt() -> ServerOpt:
    """FedAdam (Reddi et al. 2020) on g = -Delta.  The bias corrections
    ``1 - b**t`` at ``t = rnd + 1`` are fp32 tensors, as the JAX package
    forms them from its int32 round counter."""

    def init(fl: FLConfig, params) -> dict:
        return {"mu": tree_zeros_like(params), "nu": tree_zeros_like(params)}

    def make_update(fl: FLConfig, gen, loss_fn, cohort_mode):
        def update(state: ServerState, delta_agg, lr, ctx) -> ServerState:
            opt = dict(state.opt)
            b1, b2, eps = 0.9, 0.99, 1e-8
            g = {k: -d for k, d in delta_agg.items()}
            mu = {k: b1 * m0 + (1 - b1) * g[k] for k, m0 in opt["mu"].items()}
            nu = {k: b2 * n0 + (1 - b2) * g[k] * g[k] for k, n0 in opt["nu"].items()}
            like = next(iter(state.params.values()))
            t = torch.full((), state.rnd + 1.0, dtype=torch.float32, device=like.device)
            c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
            p = {k: a - (lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)).to(a.dtype)
                 for k, a in state.params.items()}
            opt["mu"], opt["nu"] = mu, nu
            return ServerState(params=p, opt=opt, rnd=state.rnd + 1)

        return update

    return ServerOpt("adam", init, make_update, provides=("mu", "nu"))


SERVER_OPTS: dict[str, ServerOpt] = {
    "sgd": chain("sgd"),
    "momentum": chain("momentum", heavy_ball()),
    "mvr": _mvr_opt(),
    "adam": _adam_opt(),
    # SCAFFOLD: sgd-style descent + the server control variate, paired with
    # the stateful "scaffold" client chain (per-client variates in the bank)
    "scaffold": chain("scaffold", scaffold_ctl(), local_update="scaffold"),
}


def register_server_opt(opt: ServerOpt, *, overwrite: bool = False) -> None:
    if not overwrite and opt.name in SERVER_OPTS:
        raise ValueError(
            f"server opt {opt.name!r} already registered (pass overwrite=True to replace)")
    SERVER_OPTS[opt.name] = opt


def server_opt_init(fl: FLConfig, params) -> dict:
    if fl.server_opt not in SERVER_OPTS:
        raise ValueError(fl.server_opt)
    return SERVER_OPTS[fl.server_opt].init(fl, params)


# ---------------------------------------------------------------------------
# FedStrategy: the declared composition + its registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FedStrategy:
    """A declared (c, w~, q) x server-opt x local-chain composition.

    ``server_opt=None`` defers to ``FLConfig.server_opt`` at bind time;
    ``local_update=None`` defers to ``FLConfig.local_update`` and then to the
    server opt's paired default.  ``equalize`` marks the strategies that only
    make sense with the equalized-K pipeline mode (Table 4's FedAvgMin /
    FedAvgMean).
    """

    name: str
    gen: GenSpec
    server_opt: str | None = None
    equalize: str | None = None       # None | "min" | "mean"
    local_update: str | None = None

    def with_server_opt(self, server_opt: str) -> "FedStrategy":
        return replace(self, server_opt=server_opt)


STRATEGIES: dict[str, FedStrategy] = {}


def register_strategy(strategy: FedStrategy, *, overwrite: bool = False) -> FedStrategy:
    if not overwrite and strategy.name in STRATEGIES:
        raise ValueError(
            f"strategy {strategy.name!r} already registered (pass overwrite=True to replace)")
    if strategy.equalize not in (None, "min", "mean"):
        raise ValueError(
            f"strategy {strategy.name!r}: equalize must be None, 'min' or "
            f"'mean', got {strategy.equalize!r}")
    for slot, kind, registry in (("c", strategy.gen.c, _alg.C_KINDS),
                                 ("w", strategy.gen.w, _alg.W_KINDS),
                                 ("q", strategy.gen.q, _alg.Q_KINDS)):
        if kind not in registry:
            raise ValueError(f"strategy {strategy.name!r}: unknown {slot}-kind {kind!r}")
    STRATEGIES[strategy.name] = strategy
    return strategy


_EQUALIZED_PRESETS = {"fedavg_min": "min", "fedavg_mean": "mean"}
for _name, _gen in PRESETS.items():
    register_strategy(FedStrategy(name=_name, gen=_gen,
                                  equalize=_EQUALIZED_PRESETS.get(_name)))


def strategy_for(algorithm: "str | FLConfig", *, server_opt: str | None = None) -> FedStrategy:
    """Resolve a config string (or a whole FLConfig) to its FedStrategy."""
    if isinstance(algorithm, FLConfig):
        return strategy_for(algorithm.algorithm, server_opt=algorithm.server_opt)
    if algorithm not in STRATEGIES:
        raise KeyError(f"unknown strategy {algorithm!r}; have {sorted(STRATEGIES)}")
    s = STRATEGIES[algorithm]
    if server_opt is not None:
        if s.server_opt is None:
            s = s.with_server_opt(server_opt)
        elif s.server_opt != server_opt:
            raise ValueError(
                f"strategy {algorithm!r} pins server_opt={s.server_opt!r}; "
                f"requested {server_opt!r}")
    return s


def equalized_mode(algorithm: str) -> str | None:
    """The equalized-step pipeline mode an algorithm requires (None, "min" or
    "mean").  Raises for unregistered algorithm names so typos fail loudly."""
    return strategy_for(algorithm).equalize


# ---------------------------------------------------------------------------
# Binding: close a FedStrategy over (FLConfig, loss_fn) into plain hooks
# ---------------------------------------------------------------------------


class BoundStrategy(NamedTuple):
    name: str
    gen: GenSpec
    local_update: str
    equalize: str | None
    fl: FLConfig
    num_clients: int
    loss_fn: Callable
    init: Callable                     # (params) -> ServerState
    client_transform: Callable         # (meta, lr_mult) -> eta [C]
    agg_coeffs: Callable               # (meta) -> [C]
    aggregate: Callable                # (stacked deltas, meta) -> delta_agg
    server_update: Callable            # (state, delta_agg, lr, ctx) -> ServerState
    local_step: Callable               # (params, momentum, opt, data, mask, eta,
    #                                      cstate) -> (delta, loss, cstate')
    cohort_step: Callable              # the same chain batched over the cohort:
    #                                      (params, momentum, opt, data [C, ...],
    #                                      mask [C, K], eta [C], cstate [C, ...],
    #                                      *, stacked) -> (deltas [C, ...],
    #                                      losses [C], cstate')
    client_state: Callable | None = None  # (params) -> one client's bank row
    #                                      template ({name: {field: tree}}), or
    #                                      None when no plane keeps client state
    codec: object = None               # bound fed.comm.Codec of the uplink
    down_codec: object = None          # bound fed.comm.Codec of the downlink
    #                                      (None for hand-built strategies: the
    #                                      round driver then runs dense)
    chain_state: tuple = ()            # the local chain's stateful transforms:
    #                                      the bank keys its steps read and write
    robust_aggregate: Callable | None = None  # (deltas, coeff, meta) ->
    #                                      delta_agg: the robust plane's combiner
    #                                      over explicit coefficients
    #                                      (fl.aggregator; "mean" is weighted_sum),
    #                                      called only while the plane is on;
    #                                      None (hand-built) falls back to
    #                                      weighted_sum there


def weighted_sum(deltas: dict, coeff: torch.Tensor) -> dict:
    """sum_i coeff_i * Delta_i over the leading client axis of stacked
    deltas (fp32 accumulate, result cast back to the delta dtype)."""
    return {k: torch.einsum("c,c...->...", coeff.float(), t.float()).to(t.dtype)
            for k, t in deltas.items()}


def _check_config(fl: FLConfig) -> None:
    """Bind-time validation of the execution knobs the port implements."""
    if fl.engine not in ("legacy", "cohort"):
        raise ValueError(f"unknown engine {fl.engine!r}; have ('legacy', 'cohort')")
    if fl.exec_mode not in ("padded", "bucketed"):
        raise ValueError(f"unknown exec_mode {fl.exec_mode!r}; have ('padded', 'bucketed')")
    if fl.exec_mode == "bucketed" and fl.buckets < 1:
        raise ValueError(f"fl.buckets must be >= 1, got {fl.buckets}")
    if fl.cohort_mode not in ("vmapped", "sequential"):
        raise ValueError(f"unknown cohort_mode {fl.cohort_mode!r}; have ('vmapped', 'sequential')")
    if fl.engine == "cohort":
        from .cohort.engine import BACKENDS  # deferred: cohort imports rounds
        from .cohort.scheduler import PARTICIPATION

        if fl.rr_backend not in BACKENDS:
            raise ValueError(f"unknown rr_backend {fl.rr_backend!r}; have {BACKENDS}")
        if fl.participation not in PARTICIPATION:
            raise ValueError(
                f"unknown participation schedule {fl.participation!r}; "
                f"have {sorted(PARTICIPATION)}")
        if fl.prefetch < 0:
            raise ValueError(f"fl.prefetch must be >= 0, got {fl.prefetch}")


def bind_strategy(strategy: "FedStrategy | BoundStrategy | None", fl: FLConfig,
                  loss_fn, *, num_clients: int) -> BoundStrategy:
    if isinstance(strategy, BoundStrategy):
        # bind-once-reuse: just validate agreement with what was bound
        if fl is not None and fl != strategy.fl:
            raise ValueError("fl differs from the config this strategy was bound over")
        if num_clients is not None and num_clients != strategy.num_clients:
            raise ValueError("num_clients differs from the bound strategy's")
        if loss_fn is not None and loss_fn is not strategy.loss_fn:
            raise ValueError("loss_fn differs from the one this strategy was bound over")
        return strategy
    if strategy is None:
        strategy = strategy_for(fl)
    pipeline_mode = equalized_mode(fl.algorithm)
    if pipeline_mode != strategy.equalize:
        # the pipeline keys its K-equalization off FLConfig.algorithm; a
        # disagreement would silently run different math than either name says
        raise ValueError(
            f"strategy {strategy.name!r} expects equalized-step pipeline mode "
            f"{strategy.equalize!r}, but FLConfig.algorithm={fl.algorithm!r} "
            f"makes the pipeline apply {pipeline_mode!r}. Set algorithm="
            f"{strategy.name!r} (or register a strategy declaring "
            f"equalize={pipeline_mode!r}).")
    if strategy.server_opt is not None and strategy.server_opt != fl.server_opt:
        raise ValueError(
            f"strategy {strategy.name!r} pins server_opt="
            f"{strategy.server_opt!r} but FLConfig.server_opt is "
            f"{fl.server_opt!r}; make them agree.")
    _check_config(fl)
    # telemetry knobs validated at bind time like every other plane's
    validate_telemetry_config(fl)
    if fleet_active(fl):
        # every fleet-plane knob fails at bind time, not rounds deep into
        # the virtual-clock simulation
        validate_fleet_config(fl)
    if robust_active(fl):
        validate_robust_config(fl)
    server_opt = strategy.server_opt or fl.server_opt
    if server_opt not in SERVER_OPTS:
        raise ValueError(f"unknown server opt {server_opt!r}; have {sorted(SERVER_OPTS)}")
    sdef = SERVER_OPTS[server_opt]
    # local chain resolution: strategy pin > FLConfig.local_update > the
    # server opt's paired default, a pin / config disagreement an error
    if (strategy.local_update is not None and fl.local_update
            and strategy.local_update != fl.local_update):
        raise ValueError(
            f"strategy {strategy.name!r} pins local_update="
            f"{strategy.local_update!r} but FLConfig.local_update is "
            f"{fl.local_update!r}; make them agree.")
    local_update = strategy.local_update or fl.local_update or sdef.local_update
    if local_update not in LOCAL_UPDATES:
        raise ValueError(
            f"unknown local update {local_update!r}; have {sorted(LOCAL_UPDATES)}")
    local = _compile_local(LOCAL_UPDATES[local_update], loss_fn, fl)
    if privacy_active(fl):
        # privacy knobs (dp / secagg) validated against the *resolved* local
        # chain: the per-step clip + DP clip stack is a bind-time error
        validate_privacy_config(fl, transform_names=local.transform_names)
    state_names = local.state_names
    missing_state = [k for k in sdef.consumes if k not in state_names]
    if missing_state:
        raise ValueError(
            f"server opt {server_opt!r} consumes per-client state of client "
            f"transform(s) {missing_state} but local update {local_update!r} "
            f"keeps no such state — the server update would silently run "
            f"without its input.  Pair it with a local update carrying "
            f"{missing_state} (e.g. local_update={missing_state[0]!r}) or "
            f"pick another server opt.")
    missing = [k for k in local.needs if k not in sdef.provides]
    if missing:
        # the round driver zero-fills a missing opt["m"], so e.g. mvr local
        # steps under server_opt="sgd" would quietly degenerate to a
        # (1-a)-biased SGD.  Refuse at bind time.
        raise ValueError(
            f"local update {local_update!r} reads server opt-state key(s) "
            f"{missing} that server opt {server_opt!r} does not maintain "
            f"(provides {list(sdef.provides)}) — the transforms would "
            f"silently consume zeros.  Pick a server opt providing "
            f"{missing} (e.g. "
            + ", ".join(sorted(n for n, o in SERVER_OPTS.items()
                               if all(k in o.provides for k in missing)))
            + ") or a local update that does not need them.")
    # comm plane: both directions resolved and validated at bind time
    codec = build_codec(fl, "uplink")
    down_codec = build_codec(fl, "downlink")
    for key, owner in ((UPLINK_STATE_KEY, "the uplink codec's error-feedback residual"),
                       (DOWNLINK_STATE_KEY, "the downlink broadcast's client-held reference")):
        if key in state_names:
            raise ValueError(
                f"local update {local_update!r} has a stateful client transform named "
                f"{key!r} — that bank key is reserved for {owner}; rename the transform.")
    client_state = local.client_template
    if codec.client_init is not None:
        chain_state = client_state

        def client_state(params):
            # the codec's EF residual / DIANA shift shares the [N+1, ...]
            # bank with the chain's stateful transforms, under the reserved key
            d = dict(chain_state(params)) if chain_state is not None else {}
            d[UPLINK_STATE_KEY] = codec.client_init(params)
            return d

    if down_codec.name != "identity":
        pre_down_state = client_state

        def client_state(params):
            # the broadcast reference every client holds, seeded with the
            # init params (server and client agree by construction)
            d = dict(pre_down_state(params)) if pre_down_state is not None else {}
            d[DOWNLINK_STATE_KEY] = {"ref": params}
            return d

    buffered = fl.server_mode == "buffered"
    if buffered:
        if FLEET_STATE_KEY in state_names:
            raise ValueError(
                f"local update {local_update!r} has a stateful client transform named "
                f"{FLEET_STATE_KEY!r} — that bank key is reserved for the buffered server's "
                f"per-client staleness counters; rename the transform.")
        pre_fleet_state = client_state

        def client_state(params):
            # per-client arrival / staleness counters share the bank under
            # the reserved key, like the codec's EF residual
            d = dict(pre_fleet_state(params)) if pre_fleet_state is not None else {}
            d[FLEET_STATE_KEY] = fleet_client_state(next(iter(params.values())).device)
            return d

    gen = strategy.gen

    def init(params) -> ServerState:
        # copy: the caller keeps ownership of the tree it passed in
        params = tree_copy(params)
        clients = None
        if client_state is not None:
            # one bank row per client + the scratch row (index num_clients)
            # that padding slots aim at
            clients = tree_map(lambda t: t.unsqueeze(0).repeat((num_clients + 1,) + (1,) * t.dim()),
                               client_state(params))
        return ServerState(params=params, opt=sdef.init(fl, params), rnd=0, clients=clients)

    def client_transform(meta, lr_mult):
        """Per-client step sizes eta_l * lr_mult / c_i ([C])."""
        return fl.local_lr * lr_mult * lr_scale(gen, meta)

    def agg_coeffs(meta) -> torch.Tensor:
        # buffered-async: each tick aggregates |S| = buffer_size arrivals (the
        # q normalization's cohort size) and discounts stale updates; the
        # sync path multiplies nothing
        coeff = agg_coeff(gen, meta, num_clients=num_clients,
                          cohort_size=fl.buffer_size if buffered else fl.cohort_size)
        if buffered:
            coeff = coeff * staleness_weights(fl, meta).to(coeff.device)
        return coeff

    def aggregate(deltas, meta):
        return weighted_sum(deltas, agg_coeffs(meta))

    return BoundStrategy(
        name=strategy.name,
        gen=gen,
        local_update=local_update,
        equalize=strategy.equalize,
        fl=fl,
        num_clients=num_clients,
        loss_fn=loss_fn,
        init=init,
        client_transform=client_transform,
        agg_coeffs=agg_coeffs,
        aggregate=aggregate,
        server_update=sdef.make_update(fl, gen, loss_fn, fl.cohort_mode),
        local_step=local.local_step,
        cohort_step=local.cohort_step,
        client_state=client_state,
        chain_state=state_names,
        codec=codec,
        down_codec=down_codec,
        # the same coefficients as aggregate (staleness discounts and all),
        # explicit so the round driver can renormalize them after a quarantine
        robust_aggregate=build_robust_aggregate(fl),
    )


def apply_server_opt(fl: FLConfig, state: ServerState, delta, lr) -> ServerState:
    """Legacy one-shot server application (no round context): runs the
    configured optimizer's parameter step on an aggregated pseudo-update."""
    if fl.server_opt not in SERVER_OPTS:
        raise ValueError(fl.server_opt)
    sdef = SERVER_OPTS[fl.server_opt]
    return sdef.make_update(fl, None, None, fl.cohort_mode)(state, delta, lr, None)
