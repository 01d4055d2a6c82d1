"""Distributed-state helpers of the port: checkpointing, liveness and
stragglers (``fault_tolerance``), the AdamW optimizer (``optimizer``),
the LM's opt-in flags (``opts``), and the mesh: the sharding rules
(``sharding``), the layers' hint context (``ctx``) and GPipe
(``pipeline``).  Exports what the JAX package's ``repro.distributed``
does."""
from repro_torch.distributed.sharding import (
    param_sharding,
    batch_sharding,
    cache_sharding,
    opt_sharding,
)
from repro_torch.distributed.optimizer import adamw_init, adamw_update, AdamWConfig

__all__ = [
    "param_sharding",
    "batch_sharding",
    "cache_sharding",
    "opt_sharding",
    "adamw_init",
    "adamw_update",
    "AdamWConfig",
]
