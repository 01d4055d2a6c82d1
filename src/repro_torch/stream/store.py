"""`TemporalGraphStore` — the mutable sliding-window edge store behind
`repro_torch.stream` (pillar 1 of the streaming engine).

The batch substrate (:mod:`repro_torch.graph.csr`) is immutable: every ingest
used to pay a full O(E log E) rebuild sort.  This store replaces that
with the "mutable two-level index" the old ``streaming.py`` docstring
promised:

* **Arrival columns** — ``src/dst/t/amount`` appended in arrival order
  with geometric capacity growth.  The arrival position IS the global
  edge id (``eid``), stable forever; counts and alerts are keyed by it.
* **Adjacency runs (two-level index)** — per direction (out/in), edges
  live in a short stack of *runs*.  Each run is a CSR-like segment whose
  rows are sorted by ``(node, t, arrival)``; a new batch becomes one
  sorted run (O(b log b) on the batch only) and runs are merged when the
  geometric size invariant breaks (each run at least ``merge_ratio``
  times larger than the next), so maintenance is amortized O(log) moves
  per edge and NO ingest ever sorts the full edge set.
* **Window eviction** — with ``retain=R``, edges older than
  ``t_high - R`` are swept out of the runs lazily (hysteresis: a sweep
  runs only once the cutoff has advanced by ``R/4``), and the arrival
  columns drop their fully-evicted prefix.  Sound retention for a
  portfolio whose max time radius is ``TR`` and whose feed is at most
  ``L`` late is ``R >= 2*TR + L``: a new edge at ``t_n`` can only dirty
  seeds with ``t_s >= t_n - TR``, and re-mining such a seed reads edges
  with ``t >= t_s - TR >= t_n - 2*TR >= t_high - L - 2*TR``
  (:func:`repro_torch.stream.service.default_retain` computes this; ``L``
  must cover arrival lateness PLUS one microbatch's time span, since a
  batch ingests atomically).
* **Exports** — :meth:`snapshot` materializes the full live graph as a
  regular :class:`~repro_torch.graph.csr.TemporalGraph` (cached and handed out
  zero-copy until the next mutation; this is the batch path).
  :meth:`local_view` materializes only the edges incident to a node ball
  — the per-tick path, whose cost scales with the dirty neighborhood,
  not with the total live edge count.  Both exports are ordinary
  ``TemporalGraph`` objects, so the compiled kernels, the device
  executor, and the schedule cache are reused unchanged.

Out-of-order and duplicate timestamps are first-class: run order is
``(node, t, arrival)`` with a stable tiebreak, and nothing assumes the
feed is time-sorted (only, for eviction soundness, boundedly late).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.graph.csr import (
    TemporalGraph,
    _pow2ceil,
    build_temporal_graph,
    csr_row_offsets,
)

__all__ = [
    "TemporalGraphStore",
    "GraphView",
    "STORE_STAT_KEYS",
    "store_states_equal",
]

STORE_STAT_KEYS = (
    "edges_ingested",
    "edges_evicted",
    "run_merges",
    "maint_moved",  # elements moved by run merges + eviction sweeps
    "evict_sweeps",
    "node_regrowths",
    "snapshot_builds",
    "view_builds",
    "view_edges",
    # edges that arrived BELOW the eviction cutoff — the feed broke the
    # lateness contract the retention rule was derived from.  They are
    # ingested (stale counts, never a crash) but the breach is no longer
    # silent: TickReport surfaces the per-tick delta
    "late_contract_breaches",
)


# ----------------------------------------------------------------------
# exported views
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GraphView:
    """A (possibly local) immutable export of the store.

    ``graph`` is a regular :class:`TemporalGraph` over *local* node/edge
    ids; ``node_ids``/``edge_ids`` map local ids back to the store's
    global ids (both ascending).  ``full`` marks a whole-graph snapshot,
    whose node numbering is the identity.
    """

    graph: TemporalGraph
    node_ids: np.ndarray  # (n_local,) global node ids, ascending
    edge_ids: np.ndarray  # (E_local,) global edge ids, ascending
    full: bool

    def local_seeds(self, eids: np.ndarray) -> np.ndarray:
        """Local edge ids of the given global edge ids (must be present)."""
        eids = np.asarray(eids, dtype=np.int64)
        pos = np.searchsorted(self.edge_ids, eids)
        if pos.size and (
            pos.max(initial=0) >= len(self.edge_ids)
            or not np.array_equal(self.edge_ids[pos], eids)
        ):
            raise KeyError("edge id(s) not present in this view")
        return pos.astype(np.int32)

    def edge_fields(
        self, eids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, t, amount) of the given *global* edge ids, resolved
        from the view's own arrays (store dtypes: int32/int32/int64/f32).

        Equivalent to the store's :meth:`TemporalGraphStore.edge_fields`
        for every edge the view holds — but immune to store mutation, so
        a pipelined tick can score/resolve against the exact graph its
        counts came from even after the NEXT tick's ingest evicted some
        of these edges from the live window."""
        pos = self.local_seeds(eids)
        g = self.graph
        return (
            self.node_ids[g.src[pos]].astype(np.int32),
            self.node_ids[g.dst[pos]].astype(np.int32),
            g.t[pos].astype(np.int64),
            g.amount[pos].astype(np.float32),
        )


# ----------------------------------------------------------------------
# one sorted run of one direction's adjacency
# ----------------------------------------------------------------------
@dataclasses.dataclass
class _Run:
    """Rows sorted by (major node, t, arrival); ``indptr`` spans the
    store's node capacity."""

    indptr: np.ndarray  # (node_cap+1,) int64
    nbr: np.ndarray  # (n,) int32 — minor endpoint
    t: np.ndarray  # (n,) int64
    eid: np.ndarray  # (n,) int64

    @property
    def n(self) -> int:
        return len(self.nbr)


def _run_from_batch(
    major: np.ndarray,
    minor: np.ndarray,
    t: np.ndarray,
    eid: np.ndarray,
    node_cap: int,
) -> _Run:
    order = np.lexsort((t, major))  # stable: arrival breaks (major, t) ties
    counts = np.bincount(major, minlength=node_cap)
    indptr = np.zeros(node_cap + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return _Run(
        indptr=indptr,
        nbr=minor[order].astype(np.int32),
        t=t[order].astype(np.int64),
        eid=eid[order].astype(np.int64),
    )


def _run_majors(run: _Run) -> np.ndarray:
    return np.repeat(
        np.arange(len(run.indptr) - 1, dtype=np.int64), np.diff(run.indptr)
    )


def _merge_runs(a: _Run, b: _Run, node_cap: int) -> _Run:
    """Stable linear merge of two (major, t, arrival)-sorted runs.

    Vectorized two-sided ``searchsorted`` on a composite (major, t) key:
    no sort of the combined data.  ``a`` must be the OLDER run so equal
    (major, t) keys keep arrival order.  Falls back to a stable lexsort
    when the composite key would overflow int64 (astronomical t only).
    """
    n = a.n + b.n
    out_nbr = np.empty(n, dtype=np.int32)
    out_t = np.empty(n, dtype=np.int64)
    out_eid = np.empty(n, dtype=np.int64)
    maj_a, maj_b = _run_majors(a), _run_majors(b)
    t_max = int(max(a.t.max(initial=0), b.t.max(initial=0)))
    scale = t_max + 2
    if node_cap * scale < 2**62:
        key_a = maj_a * scale + (a.t + 1)
        key_b = maj_b * scale + (b.t + 1)
        pos_a = np.arange(a.n, dtype=np.int64) + np.searchsorted(
            key_b, key_a, side="left"
        )
        pos_b = np.arange(b.n, dtype=np.int64) + np.searchsorted(
            key_a, key_b, side="right"
        )
    else:  # pragma: no cover - composite-key overflow guard
        maj = np.concatenate([maj_a, maj_b])
        tt = np.concatenate([a.t, b.t])
        order = np.lexsort((tt, maj))
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n, dtype=np.int64)
        pos_a, pos_b = inv[: a.n], inv[a.n :]
    for out, va, vb in (
        (out_nbr, a.nbr, b.nbr),
        (out_t, a.t, b.t),
        (out_eid, a.eid, b.eid),
    ):
        out[pos_a] = va
        out[pos_b] = vb
    return _Run(indptr=a.indptr + b.indptr, nbr=out_nbr, t=out_t, eid=out_eid)


class _RunStack:
    """One direction's adjacency: a geometric stack of sorted runs."""

    def __init__(self, node_cap: int, merge_ratio: float):
        self.runs: List[_Run] = []
        self.node_cap = node_cap
        self.merge_ratio = float(merge_ratio)

    @property
    def n(self) -> int:
        return sum(r.n for r in self.runs)

    def grow_nodes(self, new_cap: int) -> None:
        pad = new_cap - self.node_cap
        for r in self.runs:
            r.indptr = np.concatenate(
                [r.indptr, np.full(pad, r.indptr[-1], dtype=np.int64)]
            )
        self.node_cap = new_cap

    def push(self, run: _Run, stats: Dict[str, int]) -> None:
        self.runs.append(run)
        self._restore_invariant(stats)

    def _restore_invariant(self, stats: Dict[str, int]) -> None:
        # each run must be >= ratio x the size of the next-newer one —
        # that keeps the stack O(log) deep and merge moves amortized
        # O(log) per edge.  Pushes only ever break the invariant at the
        # top, but eviction sweeps can shrink runs anywhere, so scan
        # until stable (the stack is logarithmic: this is cheap).
        changed = True
        while changed:
            changed = False
            for i in range(len(self.runs) - 1):
                if self.runs[i].n < self.merge_ratio * max(1, self.runs[i + 1].n):
                    b = self.runs.pop(i + 1)
                    a = self.runs.pop(i)
                    stats["run_merges"] += 1
                    stats["maint_moved"] += a.n + b.n
                    self.runs.insert(i, _merge_runs(a, b, self.node_cap))
                    changed = True
                    break

    def evict(self, cutoff: int, stats: Dict[str, int]) -> int:
        """Drop every edge with t < cutoff; returns how many went."""
        gone = 0
        kept: List[_Run] = []
        for r in self.runs:
            keep = r.t >= cutoff
            k = int(keep.sum())
            if k == r.n:
                kept.append(r)
                continue
            gone += r.n - k
            stats["maint_moved"] += r.n
            if k == 0:
                continue
            maj = _run_majors(r)[keep]
            counts = np.bincount(maj, minlength=self.node_cap)
            indptr = np.zeros(self.node_cap + 1, dtype=np.int64)
            np.cumsum(counts, out=indptr[1:])
            kept.append(
                _Run(indptr=indptr, nbr=r.nbr[keep], t=r.t[keep], eid=r.eid[keep])
            )
        self.runs = kept
        self._restore_invariant(stats)
        return gone

    def gather(
        self, nodes: np.ndarray, t_lo: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(major, minor, t, eid) of the rows of `nodes`, all runs."""
        majors, minors, ts, eids = [], [], [], []
        nodes = np.asarray(nodes, dtype=np.int64)
        for r in self.runs:
            offs, lens = csr_row_offsets(r.indptr, nodes)
            if offs.size == 0:
                continue
            maj = np.repeat(nodes, lens)
            mi, tt, ei = r.nbr[offs], r.t[offs], r.eid[offs]
            if t_lo is not None:
                keep = tt >= t_lo
                maj, mi, tt, ei = maj[keep], mi[keep], tt[keep], ei[keep]
            majors.append(maj)
            minors.append(mi.astype(np.int64))
            ts.append(tt)
            eids.append(ei)
        if not majors:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z.copy(), z.copy()
        return (
            np.concatenate(majors),
            np.concatenate(minors),
            np.concatenate(ts),
            np.concatenate(eids),
        )

    def all_eids(self) -> np.ndarray:
        if not self.runs:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate([r.eid for r in self.runs])


# ----------------------------------------------------------------------
# the store
# ----------------------------------------------------------------------
class TemporalGraphStore:
    """Mutable sliding-window temporal multigraph (see module docstring).

    ``retain=None`` keeps everything (the drop-in replacement for the old
    rebuild-per-ingest miner); ``retain=R`` evicts edges older than
    ``t_high - R`` from the adjacency index.  Eviction never changes any
    mined count *provided* ``R`` satisfies the retention rule — it only
    bounds memory and per-tick work.
    """

    def __init__(
        self,
        retain: Optional[int] = None,
        node_capacity: int = 64,
        merge_ratio: float = 2.0,
    ):
        if retain is not None and retain < 0:
            raise ValueError("retain must be >= 0 (or None for unbounded)")
        self.retain = retain
        self.node_cap = _pow2ceil(max(2, node_capacity))
        self._out = _RunStack(self.node_cap, merge_ratio)
        self._in = _RunStack(self.node_cap, merge_ratio)
        # arrival columns (eid-ordered, with an evicted-prefix base)
        self._base = 0  # global eid of column row 0
        self._len = 0  # live column rows
        cap = 1024
        self._src = np.zeros(cap, dtype=np.int32)
        self._dst = np.zeros(cap, dtype=np.int32)
        self._t = np.zeros(cap, dtype=np.int64)
        self._amt = np.zeros(cap, dtype=np.float32)
        self._max_node = -1
        self.t_high = -1  # max timestamp ever seen
        self._cutoff = 0  # live edges have t >= _cutoff
        self._snap: Optional[GraphView] = None
        self.stats: Dict[str, int] = {k: 0 for k in STORE_STAT_KEYS}

    # -- basic facts ----------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return self._max_node + 1

    @property
    def n_edges_total(self) -> int:
        """Global edge ids handed out so far (monotonic, eviction-proof)."""
        return self._base + self._len

    @property
    def n_live(self) -> int:
        return self._out.n

    @property
    def cutoff(self) -> int:
        return self._cutoff

    def live_eids(self) -> np.ndarray:
        out = self._out.all_eids()
        out.sort()
        return out

    def edge_fields(
        self, eids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, t, amount) of the given global edge ids."""
        rows = np.asarray(eids, dtype=np.int64) - self._base
        if rows.size and (rows.min() < 0 or rows.max() >= self._len):
            raise KeyError("edge id out of the retained arrival range")
        return (
            self._src[rows],
            self._dst[rows],
            self._t[rows],
            self._amt[rows],
        )

    # -- ingest ---------------------------------------------------------
    def _grow_columns(self, n_more: int) -> None:
        need = self._len + n_more
        cap = len(self._src)
        if need <= cap:
            return
        new_cap = _pow2ceil(need)
        for name in ("_src", "_dst", "_t", "_amt"):
            old = getattr(self, name)
            grown = np.zeros(new_cap, dtype=old.dtype)
            grown[: self._len] = old[: self._len]
            setattr(self, name, grown)

    def _grow_nodes(self, max_id: int) -> None:
        if max_id < self.node_cap:
            return
        new_cap = _pow2ceil(max_id + 1)
        self._out.grow_nodes(new_cap)
        self._in.grow_nodes(new_cap)
        self.node_cap = new_cap
        self.stats["node_regrowths"] += 1

    def ingest(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        t: np.ndarray,
        amount: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Append a transaction batch; returns the new global edge ids.

        Accepts empty batches, unseen node ids (node capacity grows
        geometrically), out-of-order timestamps, and duplicates.
        """
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        t = np.asarray(t, dtype=np.int64)
        if not (len(src) == len(dst) == len(t)):
            raise ValueError("src/dst/t length mismatch")
        n = len(src)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        if t.min() < 0:
            raise ValueError("timestamps must be non-negative")
        if int(min(src.min(), dst.min())) < 0:
            raise ValueError("node ids must be non-negative")
        amount = (
            np.ones(n, dtype=np.float32)
            if amount is None
            else np.asarray(amount, dtype=np.float32)
        )
        self._snap = None
        self._grow_nodes(int(max(src.max(), dst.max())))
        self._grow_columns(n)
        lo = self._len
        self._src[lo : lo + n] = src
        self._dst[lo : lo + n] = dst
        self._t[lo : lo + n] = t
        self._amt[lo : lo + n] = amount
        self._len += n
        eids = np.arange(self._base + lo, self._base + lo + n, dtype=np.int64)
        maj_src = src.astype(np.int64)
        maj_dst = dst.astype(np.int64)
        self._out.push(
            _run_from_batch(maj_src, maj_dst, t, eids, self.node_cap), self.stats
        )
        self._in.push(
            _run_from_batch(maj_dst, maj_src, t, eids, self.node_cap), self.stats
        )
        self._max_node = max(self._max_node, int(max(src.max(), dst.max())))
        self.t_high = max(self.t_high, int(t.max()))
        self.stats["edges_ingested"] += n
        if self.retain is not None:
            self.stats["late_contract_breaches"] += int((t < self._cutoff).sum())
        self._maybe_evict(int(t.min()))
        return eids

    def _maybe_evict(self, batch_t_min: int) -> None:
        if self.retain is None:
            return
        # clamp at the current batch's min t: a just-ingested edge must
        # stay live through its own tick's re-mine (a feed later than the
        # retention contract allows degrades gracefully to stale counts
        # instead of crashing the planner)
        cutoff = min(self.t_high - self.retain, batch_t_min)
        # hysteresis: sweep only once the window has moved a quarter-turn
        if cutoff <= self._cutoff + max(1, self.retain // 4):
            return
        self._snap = None
        gone = self._out.evict(cutoff, self.stats)
        self._in.evict(cutoff, self.stats)
        self._cutoff = cutoff
        self.stats["edges_evicted"] += gone
        self.stats["evict_sweeps"] += 1
        # drop the fully-evicted arrival prefix (feeds are only boundedly
        # late, so the prefix tracks the cutoff)
        alive = self._t[: self._len] >= cutoff
        drop = int(np.argmax(alive)) if alive.any() else self._len
        if drop == 0:
            return
        for name in ("_src", "_dst", "_t", "_amt"):
            old = getattr(self, name)
            setattr(self, name, old[drop:].copy())
        self._base += drop
        self._len -= drop

    # -- graph queries over the runs ------------------------------------
    def hop_ball(
        self, seeds: np.ndarray, radius: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Undirected `radius`-hop ball over live edges.

        Returns (nodes ascending, hop distance per node) — each BFS layer
        is one vectorized run-row gather, as in the old miner's ball but
        without materializing the global CSR first.
        """
        dist = np.full(self.node_cap, -1, dtype=np.int32)
        frontier = np.unique(np.asarray(seeds, dtype=np.int64))
        frontier = frontier[frontier <= self._max_node]
        dist[frontier] = 0
        for hop in range(1, radius + 1):
            if frontier.size == 0:
                break
            _, mo, _, _ = self._out.gather(frontier)
            _, mi, _, _ = self._in.gather(frontier)
            nxt = np.unique(np.concatenate([mo, mi]))
            frontier = nxt[dist[nxt] < 0]
            dist[frontier] = hop
        nodes = np.nonzero(dist >= 0)[0].astype(np.int64)
        return nodes, dist[nodes]

    def incident_edges(
        self, nodes: np.ndarray, t_lo: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Distinct live edges with an endpoint in `nodes`:
        (eid, src, dst, t), eid-ascending."""
        _, mo, to, eo = self._out.gather(nodes, t_lo)
        _, mi, ti, ei = self._in.gather(nodes, t_lo)
        eids = np.unique(np.concatenate([eo, ei]))
        src, dst, t, _ = self.edge_fields(eids)
        return eids, src.astype(np.int64), dst.astype(np.int64), t

    # -- exports --------------------------------------------------------
    def snapshot(self) -> GraphView:
        """The full live graph as a TemporalGraph (cached; zero-copy on
        repeated calls until the next mutation).  This is the batch
        path: it pays one CSR build over the live edges — the per-tick
        incremental path uses :meth:`local_view` instead."""
        if self._snap is not None:
            return self._snap
        eids = self.live_eids()
        src, dst, t, amt = self.edge_fields(eids)
        n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
        g = build_temporal_graph(src, dst, t, amt, n_nodes=n)
        self._snap = GraphView(
            graph=g,
            node_ids=np.arange(n, dtype=np.int64),
            edge_ids=eids,
            full=True,
        )
        self.stats["snapshot_builds"] += 1
        return self._snap

    def local_view(
        self,
        core_nodes: np.ndarray,
        t_lo: Optional[int] = None,
        node_floor: int = 0,
    ) -> GraphView:
        """The sub-multigraph of every live edge incident to `core_nodes`
        (optionally only edges with ``t >= t_lo``), with compact local
        node ids padded to a power of two so device kernel traces are
        shared across ticks.

        ``node_floor`` raises the padded local node count (pow2-ceiled
        with the actual count): the streaming service passes its
        high-water mark so consecutive ticks' views share one canonical
        shape signature instead of bouncing across pow2 classes.

        Rows of core nodes are complete in the view (above ``t_lo``);
        rows of halo endpoints are partial and must not be expanded —
        the delta scheduler sizes the core so mining only ever reads
        core rows.
        """
        eids, _, _, _ = self.incident_edges(core_nodes, t_lo)
        src_g, dst_g, tt, amt = self.edge_fields(eids)
        nodes = np.unique(np.concatenate([src_g, dst_g])).astype(np.int64)
        lsrc = np.searchsorted(nodes, src_g).astype(np.int32)
        ldst = np.searchsorted(nodes, dst_g).astype(np.int32)
        n_local = _pow2ceil(max(2, len(nodes), int(node_floor)))
        g = build_temporal_graph(lsrc, ldst, tt, amt, n_nodes=n_local)
        self.stats["view_builds"] += 1
        self.stats["view_edges"] += len(eids)
        return GraphView(graph=g, node_ids=nodes, edge_ids=eids, full=False)

    # -- transactional ingest (staged tick rollback) --------------------
    def begin(self) -> dict:
        """O(log E) transactional memo of the complete mutable state.

        Nothing mutates run payload arrays in place — pushes append runs,
        merges/evictions replace run objects with new ones, column
        reallocations build new arrays, and in-place column writes only
        land past ``_len`` — so holding *references* to the current run
        arrays and columns plus the scalar state is an exact snapshot.
        :meth:`rollback` restores it bit-for-bit (chaos tests assert via
        :meth:`state_dict` equality)."""
        return {
            "base": self._base,
            "len": self._len,
            "max_node": self._max_node,
            "t_high": self.t_high,
            "cutoff": self._cutoff,
            "node_cap": self.node_cap,
            "cols": (self._src, self._dst, self._t, self._amt),
            "out": [(r.indptr, r.nbr, r.t, r.eid) for r in self._out.runs],
            "in": [(r.indptr, r.nbr, r.t, r.eid) for r in self._in.runs],
            "stats": dict(self.stats),
            "snap": self._snap,
        }

    def rollback(self, memo: dict) -> None:
        """Restore the exact state captured by :meth:`begin` — the other
        half of a transactional tick (a failed mine/score/witness stage
        must leave the store as if its ingest never happened)."""
        self._base = memo["base"]
        self._len = memo["len"]
        self._max_node = memo["max_node"]
        self.t_high = memo["t_high"]
        self._cutoff = memo["cutoff"]
        self.node_cap = memo["node_cap"]
        self._src, self._dst, self._t, self._amt = memo["cols"]
        for stack, key in ((self._out, "out"), (self._in, "in")):
            stack.node_cap = memo["node_cap"]
            # grow_nodes reassigns indptr on live run objects, so rebuild
            # runs from the memo'd array references
            stack.runs = [
                _Run(indptr=i, nbr=nb, t=t, eid=e)
                for i, nb, t, e in memo[key]
            ]
        self.stats = dict(memo["stats"])
        self._snap = memo["snap"]

    # -- durable state (checkpoint/restore) -----------------------------
    def state_dict(self) -> dict:
        """Complete store state as a FIXED-structure pytree of numpy
        arrays (checkpointable via
        :func:`repro_torch.distributed.checkpoint.save_checkpoint`): arrival
        columns trimmed to the live length, each direction's run index
        with the stacked ``indptr`` matrix + concatenated payload columns
        + per-run sizes, the scalar state packed into ``meta``, and the
        counters packed in ``STORE_STAT_KEYS`` order.  The structure does
        not depend on the run count, so a fresh store's
        :meth:`state_dict` is a valid ``tree_like`` for restore."""

        def pack(stack: _RunStack) -> dict:
            runs = stack.runs
            return {
                "indptr": (
                    np.stack([r.indptr for r in runs])
                    if runs
                    else np.zeros((0, self.node_cap + 1), np.int64)
                ),
                "nbr": (
                    np.concatenate([r.nbr for r in runs])
                    if runs
                    else np.zeros(0, np.int32)
                ),
                "t": (
                    np.concatenate([r.t for r in runs])
                    if runs
                    else np.zeros(0, np.int64)
                ),
                "eid": (
                    np.concatenate([r.eid for r in runs])
                    if runs
                    else np.zeros(0, np.int64)
                ),
                "sizes": np.array([r.n for r in runs], np.int64),
            }

        return {
            "cols": {
                "src": self._src[: self._len].copy(),
                "dst": self._dst[: self._len].copy(),
                "t": self._t[: self._len].copy(),
                "amt": self._amt[: self._len].copy(),
            },
            "out": pack(self._out),
            "in": pack(self._in),
            "meta": np.array(
                [
                    self._base,
                    self._len,
                    self._max_node,
                    self.t_high,
                    self._cutoff,
                    self.node_cap,
                    -1 if self.retain is None else self.retain,
                ],
                np.int64,
            ),
            "stats": np.array(
                [self.stats[k] for k in STORE_STAT_KEYS], np.int64
            ),
        }

    def load_state(self, state: dict) -> None:
        """Restore from a :meth:`state_dict` tree (bit-exact, run index
        included — post-restore mining, maintenance, and counters behave
        exactly as the checkpointed store would)."""
        state = {
            k: (
                {kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict)
                else np.asarray(v)
            )
            for k, v in state.items()
        }
        base, length, max_node, t_high, cutoff, node_cap, retain = (
            int(x) for x in state["meta"]
        )
        self._base = base
        self._len = length
        self._max_node = max_node
        self.t_high = t_high
        self._cutoff = cutoff
        self.node_cap = node_cap
        self.retain = None if retain < 0 else retain
        cap = _pow2ceil(max(1024, length))
        for name, dtype in (
            ("src", np.int32),
            ("dst", np.int32),
            ("t", np.int64),
            ("amt", np.float32),
        ):
            col = np.zeros(cap, dtype=dtype)
            col[:length] = state["cols"][name].astype(dtype)
            setattr(self, "_" + name, col)

        def unpack(stack: _RunStack, packed: dict) -> None:
            stack.node_cap = node_cap
            sizes = packed["sizes"].astype(np.int64)
            offs = np.zeros(len(sizes) + 1, np.int64)
            np.cumsum(sizes, out=offs[1:])
            stack.runs = [
                _Run(
                    indptr=packed["indptr"][i].astype(np.int64),
                    nbr=packed["nbr"][offs[i] : offs[i + 1]].astype(np.int32),
                    t=packed["t"][offs[i] : offs[i + 1]].astype(np.int64),
                    eid=packed["eid"][offs[i] : offs[i + 1]].astype(np.int64),
                )
                for i in range(len(sizes))
            ]

        unpack(self._out, state["out"])
        unpack(self._in, state["in"])
        self.stats = {
            k: int(v) for k, v in zip(STORE_STAT_KEYS, state["stats"])
        }
        self._snap = None


def store_states_equal(a: dict, b: dict, ignore_stats: bool = False) -> bool:
    """Bit-exact equality of two :meth:`TemporalGraphStore.state_dict`
    trees (the assertion primitive of the chaos/rollback tests)."""
    for key in a:
        if ignore_stats and key == "stats":
            continue
        va, vb = a[key], b[key]
        if isinstance(va, dict):
            if set(va) != set(vb) or not all(
                np.array_equal(np.asarray(va[k]), np.asarray(vb[k])) for k in va
            ):
                return False
        elif not np.array_equal(np.asarray(va), np.asarray(vb)):
            return False
    return True
