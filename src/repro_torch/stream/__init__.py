"""`repro_torch.stream` — the incremental temporal graph engine and the
real-time detection service, in torch (the port of the JAX package's
``repro.stream``).

* :class:`~repro_torch.stream.store.TemporalGraphStore` — mutable
  sliding-window edge store (a numpy copy of the reference), whose
  exports are ordinary :class:`~repro_torch.graph.csr.TemporalGraph`
  objects, so the compiled plans and the device executor are reused
  unchanged.
* :class:`~repro_torch.stream.delta.DeltaScheduler` — per-ingest
  dirty seeds with per-pattern hop/time radii from the stage-graph IR
  (a copy of the reference).
* :class:`~repro_torch.stream.service.DetectionService` — the
  microbatching ingest loop: each tick re-mines only its dirty frontier
  on the device (the CUDA ``intersect_count`` under the default
  ``backend="kernel"``) and fetches every pattern's counts in ONE host
  sync.

Ticks are transactional, and :mod:`repro_torch.stream.resilience` adds
input quarantine, a write-ahead log + checkpoint recovery path and a
retrying degradation ladder, exercised by :mod:`repro_torch.stream.chaos`.
"""
from repro_torch.stream.chaos import (
    FaultInjector,
    FaultSpec,
    InjectedFault,
    TransientFault,
    make_poisoned_batch,
)
from repro_torch.stream.delta import DeltaPlan, DeltaScheduler
from repro_torch.stream.resilience import (
    DEGRADATION_LADDER,
    BatchValidator,
    ResilienceConfig,
    ResilientDetectionService,
    WriteAheadLog,
)
from repro_torch.stream.service import (
    STREAM_BUCKET_LADDER,
    AlertBatch,
    DetectionService,
    TickReport,
    default_retain,
)
from repro_torch.stream.store import (
    GraphView,
    STORE_STAT_KEYS,
    TemporalGraphStore,
    store_states_equal,
)

__all__ = [
    "TemporalGraphStore",
    "GraphView",
    "STORE_STAT_KEYS",
    "store_states_equal",
    "DeltaScheduler",
    "DeltaPlan",
    "DetectionService",
    "AlertBatch",
    "TickReport",
    "default_retain",
    "STREAM_BUCKET_LADDER",
    "ResilientDetectionService",
    "ResilienceConfig",
    "BatchValidator",
    "WriteAheadLog",
    "DEGRADATION_LADDER",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "TransientFault",
    "make_poisoned_batch",
]
