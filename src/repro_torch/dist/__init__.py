"""Distribution layer: sharding rules for params, batches and decode caches,
and the model's explicit layout steps for DTensor inputs."""
from .sharding import (
    P,
    batch_shardings,
    cache_shardings,
    distribute,
    param_spec,
    params_shardings,
    seq_batch_shardings,
)

__all__ = [
    "P", "param_spec", "params_shardings", "batch_shardings",
    "seq_batch_shardings", "cache_shardings", "distribute",
]
