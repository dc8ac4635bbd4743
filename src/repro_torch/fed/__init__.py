"""The federated-learning layer of the port: strategies, the round driver,
the train loop, the cohort engine and the comm, fleet, robust and privacy
planes.  The same names as ``repro.fed`` exports, but ``jit_round_step``
(compiled round steps are not ported)."""
from ..core.local import (
    CLIENT_TRANSFORMS,
    ClientChain,
    ClientTransform,
    RoundEnd,
    StepCtx,
    register_client_transform,
)
from .rounds import as_device_batch, build_round_step
from .server import ServerState, apply_server, cosine_schedule, init_server, wsd_schedule
from .strategy import (
    LOCAL_UPDATES,
    SERVER_OPTS,
    STRATEGIES,
    BoundStrategy,
    CohortState,
    FedStrategy,
    ServerOpt,
    ServerTransform,
    bind_strategy,
    chain,
    heavy_ball,
    register_local_update,
    register_server_opt,
    register_strategy,
    scaffold_ctl,
    strategy_for,
)
from .cohort.engine import CohortEngine
from .cohort.plan import as_device_plan
from .cohort.plane import DevicePlane, build_plane
from .cohort.prefetch import RoundPrefetcher
from .cohort.scheduler import register_participation
from .comm import CODECS, Codec, build_codec, register_codec, with_error_feedback
from .fleet import (
    FAULTS,
    FLEET_STATE_KEY,
    FLEETS,
    BufferedSchedule,
    FleetModel,
    apply_faults,
    build_fleet,
    fleet_active,
    register_fault,
    register_fleet,
    staleness_weights,
    validate_fleet_config,
)
from .privacy import (
    RDPAccountant,
    accountant_for,
    check_dp_resume,
    dp_active,
    dp_checkpoint_record,
    privacy_active,
    secagg_active,
    secagg_combine,
    validate_privacy_config,
)
from .robust import (
    ATTACKS,
    GUARDS,
    ROBUST_AGGS,
    adversary_mask,
    build_attack,
    build_robust_aggregate,
    register_attack,
    register_robust_agg,
    robust_active,
    validate_robust_config,
)
from .train_loop import train

__all__ = ["as_device_batch", "build_round_step",
           "ServerState", "apply_server",
           "init_server", "wsd_schedule", "cosine_schedule", "train",
           "FedStrategy", "BoundStrategy", "ServerOpt", "ServerTransform",
           "STRATEGIES", "SERVER_OPTS", "LOCAL_UPDATES", "CLIENT_TRANSFORMS",
           "strategy_for", "bind_strategy",
           "register_strategy", "register_server_opt", "register_local_update",
           "register_client_transform", "chain", "heavy_ball", "scaffold_ctl",
           "ClientChain", "ClientTransform", "StepCtx", "RoundEnd",
           "CohortState",
           "CohortEngine", "DevicePlane", "RoundPrefetcher", "as_device_plan",
           "build_plane", "register_participation",
           "CODECS", "Codec", "build_codec", "register_codec",
           "with_error_feedback",
           "FLEETS", "FAULTS", "FLEET_STATE_KEY", "BufferedSchedule",
           "FleetModel", "apply_faults", "build_fleet", "fleet_active",
           "register_fault", "register_fleet", "staleness_weights",
           "validate_fleet_config",
           "ATTACKS", "GUARDS", "ROBUST_AGGS", "adversary_mask",
           "build_attack", "build_robust_aggregate", "register_attack",
           "register_robust_agg", "robust_active", "validate_robust_config",
           "RDPAccountant", "accountant_for", "check_dp_resume", "dp_active",
           "dp_checkpoint_record", "privacy_active", "secagg_active",
           "secagg_combine", "validate_privacy_config"]
