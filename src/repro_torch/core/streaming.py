"""Deprecated streaming entry point — superseded by :mod:`repro_torch.stream`.

The original ``StreamingMiner`` rebuilt the full CSR snapshot (an
O(E log E) sort) on every ingest batch and re-mined one max-radius dirty
ball for the whole portfolio.  Both halves now live in the streaming
subsystem:

* the mutable sliding-window store + amortized adjacency maintenance is
  :class:`repro_torch.stream.TemporalGraphStore`;
* per-pattern dirty-seed computation is
  :class:`repro_torch.stream.DeltaScheduler`;
* the ingest/mine/score loop is :class:`repro_torch.stream.DetectionService`.

:class:`StreamingMiner` remains as a thin deprecation shim over
``DetectionService`` preserving the old surface (``ingest`` returning
the union dirty seed ids, ``counts``/``graph``/``last_dirty``/
``last_stats``, IR-derived ``hop_radius``/``time_radius``).  Counts are
still incremental == batch-recompute exact (``tests/test_streaming.py``
asserts it, depth-3 patterns included) — ingest just no longer sorts
the world.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["StreamingMiner"]

# once-per-process deprecation gate: a shim constructed inside a hot
# loop (the old API encouraged one miner per portfolio per run, but some
# callers rebuild) must not flood stderr with one warning per instance
_WARNED = False


class StreamingMiner:
    """Deprecated: use :class:`repro_torch.stream.DetectionService` (or
    ``MiningSession.service()``)."""

    def __init__(
        self,
        patterns: Sequence,
        window: int,
        backend: str = "kernel",
        device=None,
    ):
        """`patterns` mixes library names (instantiated at `window`) and
        ready-built :class:`~repro_torch.core.spec.PatternSpec` objects.
        `backend` selects the compiled kernels' pairwise lowering
        (``"kernel"`` | ``"torch"``); `device` places the service (default:
        the CUDA card)."""
        global _WARNED
        if not _WARNED:
            _WARNED = True
            warnings.warn(
                "repro_torch.core.streaming.StreamingMiner is deprecated; use "
                "repro_torch.stream.DetectionService / MiningSession.service()",
                DeprecationWarning,
                stacklevel=2,
            )
        from repro_torch.stream import DetectionService

        self._svc = DetectionService(
            patterns, window=window, backend=backend, device=device
        )
        self.window = int(window)
        self.backend = backend
        self.pattern_names = self._svc.pattern_names
        sched = self._svc.scheduler
        # old portfolio-max locality facts (the scheduler is per-pattern
        # now; these remain for callers that sized things off the max)
        self.hop_radius: int = sched.max_radius
        self.time_radius: Optional[int] = sched.max_time_radius
        self.last_dirty: int = 0
        self.last_stats: Dict[str, int] = dict(self._svc.stats)

    @property
    def n_edges(self) -> int:
        return self._svc.n_edges

    @property
    def graph(self):
        return None if self.n_edges == 0 else self._svc.graph

    @property
    def counts(self) -> Dict[str, np.ndarray]:
        return {n: self._svc.pattern_counts(n) for n in self.pattern_names}

    def ingest(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        t: np.ndarray,
        amount: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Add a batch of transactions; returns the dirty seed-edge ids
        (union over the per-pattern dirty sets) that were re-mined."""
        batch = self._svc.submit(src, dst, t, amount)
        report = batch.report
        self.last_dirty = report.n_dirty
        self.last_stats = report.stats
        plan = self._svc.last_plan
        if plan is None:
            return np.zeros(0, dtype=np.int64)
        return plan.union_dirty
