"""`DeltaScheduler` — per-ingest dirty-seed computation (pillar 2).

Factored out of the old ``StreamingMiner.ingest`` and sharpened three
ways:

* **Per-pattern dirty radii** — the old miner took the max hop/time
  radius over the whole portfolio, so a seed-local pattern (``fan_in``,
  radius 0) re-mined the deep patterns' entire ball every tick.  Here
  every pattern gets its own dirty set from its own IR facts
  (``dirty_radius`` / ``time_radius`` from
  :func:`repro_torch.core.compiler.analyze_stage_graph`), and one BFS with
  per-node hop distances serves all radii at once.
* **Two-sided temporal pruning** — a new edge at ``t_n`` can only change
  a seed ``s`` if some pattern window relates them, i.e.
  ``|t_n - t_s| <= time_radius``; the old miner applied only the lower
  bound, this one prunes both sides.
* **A view plan** — alongside the dirty sets, the scheduler sizes the
  node ball whose rows the re-mine will read (``core``): every node
  within ``hop_depth`` undirected hops of a dirty seed endpoint, with a
  time floor ``t_lo = min(t_new) - 2*max(time_radius) - 1`` when every
  pattern's windows are bounded.  :meth:`TemporalGraphStore.local_view`
  materializes exactly that neighborhood, so per-tick mining cost scales
  with the delta, not the graph.

Soundness of the hop rule is inherited from the compiler's locality
pass: a new edge participates in an instance only by coinciding with a
pattern edge, and every pattern edge has an endpoint within
``dirty_radius`` undirected hops of the seed endpoints.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.compiler import StageGraphIR, analyze_stage_graph
from repro_torch.core.spec import PatternSpec

from repro_torch.stream.store import TemporalGraphStore

__all__ = ["DeltaScheduler", "DeltaPlan"]


@dataclasses.dataclass
class DeltaPlan:
    """One ingest batch's re-mine plan."""

    dirty: Dict[str, np.ndarray]  # pattern -> global seed eids (ascending)
    union_dirty: np.ndarray  # ascending union over patterns
    core_nodes: np.ndarray  # nodes whose rows the re-mine may read
    t_lo: Optional[int]  # time floor for the view (None = unbounded)
    n_live: int  # live edges at plan time
    cold: bool  # first batch: everything is dirty

    @property
    def dirty_fraction(self) -> float:
        """Union dirty seeds over live edges (the < 1 locality gauge)."""
        return len(self.union_dirty) / max(1, self.n_live)


class DeltaScheduler:
    """Derives per-pattern dirty seeds + the shared view ball per ingest.

    Graph-independent: built once from the portfolio's specs (the IR
    analysis runs here, not per tick), then :meth:`plan` is called with
    the store and the new batch.
    """

    def __init__(
        self,
        specs: Sequence[PatternSpec],
        irs: Optional[Dict[str, StageGraphIR]] = None,
    ):
        if len({s.name for s in specs}) != len(specs):
            raise ValueError("duplicate pattern names in streaming portfolio")
        self.specs: Dict[str, PatternSpec] = {s.name: s for s in specs}
        self.irs: Dict[str, StageGraphIR] = irs or {
            s.name: analyze_stage_graph(s) for s in specs
        }
        self.radius: Dict[str, int] = {
            n: ir.dirty_radius for n, ir in self.irs.items()
        }
        self.time_radius: Dict[str, Optional[int]] = {
            n: ir.time_radius for n, ir in self.irs.items()
        }
        self.hop_depth: Dict[str, int] = {
            n: ir.hop_depth for n, ir in self.irs.items()
        }
        self.max_radius: int = max(self.radius.values(), default=0)
        self.max_hop_depth: int = max(self.hop_depth.values(), default=0)
        spans = list(self.time_radius.values())
        self.max_time_radius: Optional[int] = (
            None if (not spans or any(s is None for s in spans)) else max(spans)
        )

    @property
    def pattern_names(self) -> Tuple[str, ...]:
        return tuple(self.specs)

    def view_t_lo(self, t_new_min: int) -> Optional[int]:
        """Time floor of every edge a re-mine of this batch can read:
        dirty seeds sit at ``t >= t_new_min - TR`` and their windows
        reach at most ``TR`` further down."""
        tr = self.max_time_radius
        return None if tr is None else int(t_new_min) - 2 * tr - 1

    def plan(
        self,
        store: TemporalGraphStore,
        new_src: np.ndarray,
        new_dst: np.ndarray,
        new_t: np.ndarray,
        new_eids: np.ndarray,
        cold: bool = False,
    ) -> DeltaPlan:
        new_eids = np.asarray(new_eids, dtype=np.int64)
        if cold or store.n_live == len(new_eids):
            # first batch: no prior counts exist, every live edge is dirty
            eids = store.live_eids()
            dirty = {n: eids for n in self.specs}
            nodes, _ = store.hop_ball(
                np.concatenate([np.asarray(new_src), np.asarray(new_dst)]),
                0,
            )
            return DeltaPlan(
                dirty=dirty,
                union_dirty=eids,
                core_nodes=nodes,
                t_lo=None,
                n_live=store.n_live,
                cold=True,
            )
        touched = np.unique(
            np.concatenate(
                [np.asarray(new_src, np.int64), np.asarray(new_dst, np.int64)]
            )
        )
        t_new_min = int(np.asarray(new_t).min())
        t_new_max = int(np.asarray(new_t).max())

        # one BFS with per-node distances serves every pattern's radius
        ball, ball_dist = store.hop_ball(touched, self.max_radius)
        dist = np.full(store.node_cap, np.iinfo(np.int32).max, dtype=np.int64)
        dist[ball] = ball_dist
        cand_eids, cand_src, cand_dst, cand_t = store.incident_edges(ball)
        md = np.minimum(dist[cand_src], dist[cand_dst])

        dirty: Dict[str, np.ndarray] = {}
        for name in self.specs:
            sel = md <= self.radius[name]
            tr = self.time_radius[name]
            if tr is not None:
                sel &= (cand_t >= t_new_min - tr) & (cand_t <= t_new_max + tr)
            dirty[name] = np.union1d(cand_eids[sel], new_eids)
        all_dirty = new_eids
        for d in dirty.values():
            all_dirty = np.union1d(all_dirty, d)

        # the view core: everything the re-mine can expand — nodes within
        # hop_depth of any dirty seed's endpoints
        if len(all_dirty):
            s, d, _, _ = store.edge_fields(all_dirty)
            seed_nodes = np.concatenate(
                [s.astype(np.int64), d.astype(np.int64)]
            )
            core, _ = store.hop_ball(seed_nodes, self.max_hop_depth)
        else:
            core = np.zeros(0, dtype=np.int64)
        return DeltaPlan(
            dirty=dirty,
            union_dirty=all_dirty,
            core_nodes=core,
            t_lo=self.view_t_lo(t_new_min),
            n_live=store.n_live,
            cold=False,
        )
