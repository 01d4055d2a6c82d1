"""`DetectionService` — the real-time detection loop, in torch (the port
of the JAX package's ``repro.stream.service``).

``submit(txns) -> AlertBatch`` is the whole lifecycle of one microbatch,
split into a device-async **dispatch** phase and a host-sync **commit**
phase:

1. **ingest** into the :class:`~repro_torch.stream.store.TemporalGraphStore`
   (amortized maintenance, window eviction);
2. **plan** the delta with the :class:`~repro_torch.stream.delta.DeltaScheduler`
   (per-pattern dirty seeds + the view ball);
3. **mine** the dirty frontier as a *portfolio*: every registered
   pattern's dirty seeds are dispatched against ONE shared tick view and
   device mirror (``mine_async`` — no per-pattern host sync), with
   per-pattern kernel caches AND shape-keyed schedule caches shared
   across ticks.  View shapes are pow2-padded under monotone high-water
   floors, so warm ticks replay earlier ticks' launch shapes (the JAX
   package's JIT traces) instead of minting new ones;
4. **gather** every pattern's device-resident count vector in ONE
   blocking fetch (:func:`repro_torch.core.shard.gather`,
   ``mode="portfolio"``: one device-side concatenation, one copy) — the
   tick's single host sync and its transactional commit point;
5. **score** the re-mined seeds through the `repro_torch.ml` feature layout
   (base transaction columns + one column per registered pattern —
   exactly :func:`repro_torch.api.featurize` order, so an offline-trained
   classifier's ``predict_proba`` plugs in as ``scorer=``), apply the
   per-pattern count ``thresholds``, and emit an :class:`AlertBatch`
   carrying the executor/store counter glossary for the tick;
6. **evidence** (``witnesses=k``): every alert seed whose count was
   recomputed this tick is witness-mined (:mod:`repro_torch.witness`) on
   the SAME tick-local view and device mirror the counting pass used, the
   hop edge ids translated compact->global through ``view.edge_ids`` and
   resolved against the view's own arrival columns into concrete
   ``(src, dst, t, amount)`` transaction hops an analyst can act on.

Where it runs: the device mirror and every launch live on ``device``
(default: the CUDA card; the CPU only when asked).  ``backend="kernel"``
(default) sends the ``pw`` buckets of every tick's counting mine through
the CUDA ``intersect_count``; ``"torch"`` broadcasts the compare cube
inline.  Witness extraction broadcasts its compare cube on both, as the
JAX package does (the kernel returns counts, not positions).

``pipeline=True`` overlaps consecutive ticks: ``submit`` dispatches tick
N+1 (ingest/plan/mine launches) while tick N's device mining is still in
flight, THEN commits tick N (gather/score/evidence) and returns its
alerts — so ``submit`` returns the *previous* tick's :class:`AlertBatch`
(``None`` on the first call) and :meth:`flush` drains the tail.  The
commit stays the transactional boundary: a tick that fails anywhere
before its gather completes rolls back bit-exactly, including the
already-ingested successor (whose input is surfaced on
:attr:`orphaned` for replay).

Incremental counts are guaranteed equal to a batch recompute over the
full edge history (``tests/test_stream_service.py`` asserts it pattern
by pattern, eviction and out-of-order feeds included; the pipelined path
is asserted bit-exact against the sequential path in
``tests/test_stream_pipeline.py``).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import executor, shard
from repro_torch.core.compiler import CompiledPattern, schedule_cache_cap_for
from repro_torch.core.patterns import build_pattern
from repro_torch.core.spec import PatternSpec
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.stream.delta import DeltaPlan, DeltaScheduler
from repro_torch.stream.store import GraphView, TemporalGraphStore
from repro_torch.witness import witness_layout
from repro_torch.witness.extract import mine_witnesses

__all__ = [
    "DetectionService",
    "AlertBatch",
    "TickReport",
    "default_retain",
    "STREAM_BUCKET_LADDER",
]

BASE_FEATURES = ("src", "dst", "amount")

# default bucket ladder for streaming ticks — deliberately coarse (two
# classes) so the (strategy, per-dim class) kernel-trace combo space
# saturates during warm-up and steady-state ticks re-trace nothing; see
# the DetectionService ctor comment
STREAM_BUCKET_LADDER = (32, 1024)

logger = logging.getLogger("repro_torch.stream")


def default_retain(
    scheduler: DeltaScheduler, lateness: int = 0
) -> Optional[int]:
    """Sound sliding-window retention for a portfolio: ``2*TR + L``.

    A new edge at ``t_n >= t_high - L`` dirties only seeds with
    ``t_s >= t_n - TR``, whose re-mine reads edges with
    ``t >= t_s - TR >= t_high - L - 2*TR``.  ``None`` (keep everything)
    when any pattern's windows are unbounded — no eviction is sound
    then.

    ``lateness`` is the EFFECTIVE lateness of the feed: arrival lateness
    *plus the time span of one microbatch* (a batch ingests atomically,
    so its earliest edge is "late" by the batch span relative to its
    latest).  Feeds later than the contract degrade gracefully — stale
    counts on out-of-contract seeds, never a crash."""
    tr = scheduler.max_time_radius
    return None if tr is None else 2 * tr + int(lateness)


# ----------------------------------------------------------------------
# tick outputs
# ----------------------------------------------------------------------
@dataclasses.dataclass
class TickReport:
    """Observability record of one ``submit`` call."""

    tick: int
    n_new: int
    n_live: int
    n_dirty: int  # union over patterns
    dirty: Dict[str, int]  # per-pattern dirty seed counts
    dirty_fraction: float  # union / live (the < 1 locality gauge)
    path: str  # "local" | "full" | "cold" | "empty"
    view_nodes: int
    view_edges: int
    seconds: float
    stats: Dict[str, int]  # executor counter deltas (STAT_KEYS glossary)
    store: Dict[str, int]  # store counter deltas (STORE_STAT_KEYS)
    # per-stage wall breakdown (milliseconds).  mine_ms covers the async
    # dispatch (view build + launches) PLUS the commit-side gather — the
    # device wait lands there, so under pipelining it absorbs the
    # overlapped successor dispatch and is NOT a pure device-time gauge
    ingest_ms: float = 0.0
    plan_ms: float = 0.0
    mine_ms: float = 0.0
    score_ms: float = 0.0
    # resilience counters (zero on a bare DetectionService; populated by
    # repro_torch.stream.resilience and the store's lateness-contract counter)
    rejected: int = 0  # rows dropped by schema validation (whole batch)
    quarantined: int = 0  # rows dead-lettered by the input quarantine
    late_contract_breach: int = 0  # ingested rows below the eviction cutoff
    degraded: Tuple[str, ...] = ()  # degradation-ladder steps this tick
    retries: int = 0  # transient-failure retries before this tick committed
    # observability (repro_torch.obs): fresh launch shapes (the JAX
    # package's JIT traces) minted this tick — a warm ("local"/"full")
    # tick should replay cached shapes, so a nonzero value there is a
    # latency smell and logs a warning
    trace_misses: int = 0
    # id of the tick's "tick" span when tracing was enabled (joins the
    # report to its span tree in flight-recorder dumps and audit logs)
    span_id: Optional[int] = None


@dataclasses.dataclass
class AlertBatch:
    """Scored detections of one tick, array-of-columns style.

    Rows cover every seed whose feature row *changed* this tick and
    crossed a threshold; ``counts[:, j]`` is the current participation
    count in pattern ``columns[j]`` and ``triggered[:, j]`` marks which
    pattern(s) fired.

    ``evidence`` (services built with ``witnesses=k``) carries, per row,
    a dict mapping each pattern that fired AND was re-mined this tick to
    its top-k witnesses — each witness a list of resolved hop dicts
    ``{stage, eid, src, dst, t, amount}`` (see
    :meth:`repro_torch.witness.Witnesses.resolve`).  A fired pattern whose
    count carried over from an earlier tick is absent from the dict (its
    witnesses were attached when it was last re-mined)."""

    eids: np.ndarray  # (n,) global edge ids
    src: np.ndarray
    dst: np.ndarray
    t: np.ndarray
    amount: np.ndarray
    counts: np.ndarray  # (n, P) int64
    score: np.ndarray  # (n,) float32
    triggered: np.ndarray  # (n, P) bool
    columns: Tuple[str, ...]
    report: TickReport
    evidence: Optional[List[Dict[str, list]]] = None

    def __len__(self) -> int:
        return len(self.eids)

    def top(self, k: int = 10) -> "AlertBatch":
        order = np.argsort(-self.score, kind="stable")[:k]
        return dataclasses.replace(
            self,
            eids=self.eids[order],
            src=self.src[order],
            dst=self.dst[order],
            t=self.t[order],
            amount=self.amount[order],
            counts=self.counts[order],
            score=self.score[order],
            triggered=self.triggered[order],
            evidence=(
                None
                if self.evidence is None
                else [self.evidence[i] for i in order]
            ),
        )

    def to_rows(self) -> List[dict]:
        rows = []
        for i in range(len(self.eids)):
            fired = [c for j, c in enumerate(self.columns) if self.triggered[i, j]]
            row = {
                "eid": int(self.eids[i]),
                "src": int(self.src[i]),
                "dst": int(self.dst[i]),
                "t": int(self.t[i]),
                "amount": float(self.amount[i]),
                "score": float(self.score[i]),
                "patterns": fired,
                "counts": {
                    c: int(self.counts[i, j])
                    for j, c in enumerate(self.columns)
                },
            }
            if self.evidence is not None:
                row["evidence"] = self.evidence[i]
            rows.append(row)
        return rows


PatternLike = Union[str, PatternSpec]


@dataclasses.dataclass
class _InflightTick:
    """One dispatched-but-uncommitted tick: every host-side artifact the
    commit phase (gather/score/evidence/report) needs, snapshotted at
    dispatch time so the commit stays correct even after a successor
    tick has mutated the store and the resilience wrapper has reset its
    per-call plumbing (notes/deadline/count-only)."""

    txn: Optional[dict]  # rollback memo (pipelined path; None in _tick)
    t0: float
    tick: int
    input: tuple  # coerced (src, dst, t, amount) — orphan replay payload
    stats: Dict[str, int]
    span_id: Optional[int]
    notes: Dict[str, object]
    deadline: Optional[float]
    count_only: bool
    n_new: int = 0
    path: str = "empty"
    plan: Optional[DeltaPlan] = None
    view: Optional[GraphView] = None
    dg: object = None
    vecs: Dict[str, object] = dataclasses.field(default_factory=dict)
    seed_map: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    cps: Dict[str, CompiledPattern] = dataclasses.field(default_factory=dict)
    mined: Dict[str, set] = dataclasses.field(default_factory=dict)
    n_live: int = 0
    store_delta: Dict[str, int] = dataclasses.field(default_factory=dict)
    trace_misses: int = 0
    ingest_ms: float = 0.0
    plan_ms: float = 0.0
    mine_ms: float = 0.0


# ----------------------------------------------------------------------
# the service
# ----------------------------------------------------------------------
class DetectionService:
    """Microbatching real-time AML detection over a pattern portfolio.

    >>> svc = DetectionService(["fan_in", "cycle3"], window=4096,
    ...                        thresholds={"cycle3": 1, "fan_in": 8})
    >>> batch = svc.submit(src, dst, t, amount)
    >>> batch.to_rows(), batch.report.dirty_fraction

    ``patterns`` mixes library names (instantiated at ``window``),
    ready-built :class:`PatternSpec` objects, and `repro_torch.api` builders.
    ``thresholds`` maps pattern name -> minimal participation count that
    raises an alert (patterns without a threshold contribute features
    only).  ``scorer`` is an optional ``(n, F) -> (n,)`` probability
    function over :attr:`feature_columns` (e.g. a fitted
    ``repro_torch.ml.GBDTClassifier().predict_proba``); without one, the score
    is the max threshold-normalized count.  ``retain`` is the store's
    sliding window ("auto" derives the sound ``2*TR + lateness`` bound,
    ``None`` keeps everything).  ``witnesses=k`` attaches to every alert
    the top-k matching edge tuples per fired pattern, resolved into
    ``(src, dst, t, amount)`` hops (:attr:`AlertBatch.evidence`).
    ``device`` places the per-tick device mirror and every launch:
    ``None`` means the CUDA card (raising when there is none);
    ``device="cpu"`` runs the plain PyTorch path.
    ``backend`` is the compiled plans' kernel backend: ``"kernel"``
    (default, the CUDA ``intersect_count``) or ``"torch"`` — the
    counterparts of the JAX service's ``"pallas"`` and ``"xla"``.

    ``pipeline=True`` double-buffers ticks: ``submit`` returns the
    PREVIOUS tick's alerts (``None`` on the first call) and overlaps the
    new tick's host-side dispatch with the old tick's in-flight device
    mining; :meth:`flush` commits the tail.  ``schedule_cache_cap``
    bounds each pattern's shape-keyed schedule cache (default: sized
    from the portfolio via :func:`schedule_cache_cap_for`).
    """

    def __init__(
        self,
        patterns: Sequence[PatternLike],
        window: int,
        *,
        backend: str = "kernel",
        thresholds: Optional[Dict[str, int]] = None,
        scorer: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        retain: Union[int, str, None] = None,
        lateness: int = 0,
        full_remine_fraction: float = 0.5,
        node_capacity: int = 64,
        witnesses: int = 0,
        pipeline: bool = False,
        schedule_cache_cap: Optional[int] = None,
        ladder: Optional[Tuple[int, ...]] = None,
        chaos=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.window = int(window)
        self.backend = backend
        self.witnesses = int(witnesses)
        self.pipeline = bool(pipeline)
        # streaming bucket ladder: much coarser than the batch default.
        # Warm ticks must RE-TRACE NOTHING, and every distinct
        # (strategy, per-dim class) combo is one kernel trace — the batch
        # ladder's pow4 classes cross-multiply over dims into hundreds of
        # combos that a shifting live-window degree distribution keeps
        # minting for dozens of ticks.  Two classes bound the combo space
        # so it saturates within the warm-up; the extra per-row padding
        # is masked compute, exactness is ladder-independent.
        self.ladder = STREAM_BUCKET_LADDER if ladder is None else tuple(ladder)
        # fault-injection harness (repro_torch.stream.chaos.FaultInjector);
        # None in production — the hooks are no-ops then
        self.chaos = chaos
        specs = [
            p
            if isinstance(p, PatternSpec)
            else (
                p.build()
                if hasattr(p, "build") and not isinstance(p, str)
                else build_pattern(p, self.window)
            )
            for p in patterns
        ]
        self.scheduler = DeltaScheduler(specs)
        self._specs = self.scheduler.specs
        self._irs = self.scheduler.irs
        self.pattern_names = self.scheduler.pattern_names
        unknown = set(thresholds or ()) - set(self.pattern_names)
        if unknown:
            raise ValueError(f"thresholds for unregistered patterns: {unknown}")
        self.thresholds = dict(thresholds or {})
        self.scorer = scorer
        if retain == "auto":
            retain = default_retain(self.scheduler, lateness)
        self.store = TemporalGraphStore(
            retain=retain, node_capacity=node_capacity
        )
        self.full_remine_fraction = float(full_remine_fraction)
        # per-pattern participation counts, indexed by global edge id
        self.counts: Dict[str, np.ndarray] = {
            n: np.zeros(0, dtype=np.int64) for n in self.pattern_names
        }
        # per-pattern kernel-callable caches shared ACROSS ticks: view
        # shapes are pow2-padded, so tick k+1 replays tick k's callables
        self._kernels: Dict[str, dict] = {n: {} for n in self.pattern_names}
        self._trace_keys: Dict[str, set] = {n: set() for n in self.pattern_names}
        # per-pattern shape-keyed schedule caches, also shared across
        # ticks (the per-tick CompiledPattern is a throwaway facade; the
        # caches carry all cross-tick state).  The cap follows the same
        # portfolio-sized rule the sharded executor uses for partitions.
        self._sched_caches: Dict[str, OrderedDict] = {
            n: OrderedDict() for n in self.pattern_names
        }
        self.schedule_cache_cap = (
            schedule_cache_cap_for(len(self.pattern_names))
            if schedule_cache_cap is None
            else int(schedule_cache_cap)
        )
        # monotone high-water pad floors: device-mirror dims per view
        # kind plus ONE shared degree floor, so the max_deg-derived
        # binary-search iteration count baked into kernel trace keys is
        # uniform across the local/full paths and never shrinks.
        # Deliberately NOT part of the tick rollback memo — oversizing
        # stays exact after a rollback, shrinking would remint traces.
        self._pad_floors: Dict[str, int] = {
            "local_nodes": 1,
            "local_edges": 1,
            "full_nodes": 1,
            "full_edges": 1,
            "deg": 1,
            "view_nodes": 0,  # local_view compact-node floor
        }
        if self.witnesses:
            # fail at construction, not mid-stream, if a registered
            # pattern's stage shape has no witness lowering
            for n in self.pattern_names:
                witness_layout(self._irs[n])
        # tick-local mining context (view, device mirror, per-pattern
        # plans, per-pattern freshly-mined seed sets) kept alive between
        # commit's gather and _finish so alert seeds can be witness-mined
        # on the exact graph their counts came from
        self._tick_ctx: Optional[tuple] = None
        self.tick = 0
        self.last_report: Optional[TickReport] = None
        self.last_plan: Optional[DeltaPlan] = None
        # lifetime executor counters (STAT_KEYS glossary)
        self.stats = executor.new_stats()
        # transactional-tick state: per-tick undo log of counts writes
        # (appended by the commit-phase gather, replayed backwards on
        # rollback)
        self._txn_counts_undo: List[tuple] = []
        # pipelining state: the dispatched-but-uncommitted tick, the
        # committed-batch queue submit/flush drain, and
        # ``(tick, (src, dst, t, amount), notes)`` records of ticks whose
        # ingest was rolled back by their own commit failure (resubmit to
        # recover them; the resilience wrapper replays them automatically)
        self._inflight: Optional[_InflightTick] = None
        self._done: deque = deque()
        self.orphaned: List[Tuple[int, tuple, dict]] = []
        # submit/flush are serialized: concurrent submitters multiplex
        # onto one logical tick stream (RLock — the resilience wrapper
        # re-enters)
        self._lock = threading.RLock()
        # resilience plumbing (set per tick by ResilientDetectionService;
        # inert defaults on a bare service)
        self._tick_notes: Dict[str, object] = {}
        self._tick_deadline: Optional[float] = None  # perf_counter instant
        self._count_only = False  # ladder rung: skip score/alert stages
        # observability (repro_torch.obs): flight recorder keeps the last N
        # tick reports (+ span trees when tracing is on) for postmortem
        # dumps; _tick_span_id joins the report to its "tick" span
        self.flight = FlightRecorder()
        self._tick_span_id: Optional[int] = None

    # -- feature layout (repro_torch.ml contract) -----------------------------
    @property
    def feature_columns(self) -> Tuple[str, ...]:
        """Feature layout of ``scorer`` inputs: base transaction columns
        then one pattern-count column per registered pattern — the same
        order :func:`repro_torch.api.featurize` produces, so offline-trained
        models transfer."""
        return BASE_FEATURES + self.pattern_names

    @property
    def graph(self):
        """Full live graph (batch export; cached between mutations)."""
        return self.store.snapshot().graph

    @property
    def n_edges(self) -> int:
        return self.store.n_live

    def _grow_counts(self) -> None:
        n = self.store.n_edges_total
        for name, arr in self.counts.items():
            if len(arr) < n:
                grown = np.zeros(max(n, 2 * len(arr)), dtype=np.int64)
                grown[: len(arr)] = arr
                self.counts[name] = grown

    def pattern_counts(self, name: str) -> np.ndarray:
        """Counts of `name` aligned to global edge ids [0, n_edges_total)."""
        return self.counts[name][: self.store.n_edges_total]

    # -- transactional ticks --------------------------------------------
    def _fire(self, point: str, tick: Optional[int] = None) -> None:
        """Chaos fault point (no-op without an injector).  ``tick``
        overrides the attributed tick number — commit-phase points of a
        pipelined tick fire after the successor has already bumped
        ``self.tick``."""
        if self.chaos is not None:
            self.chaos.fire(point, self.tick if tick is None else tick)

    def _begin_tick(self) -> dict:
        """Stage the tick: memo of everything :meth:`_rollback_tick` must
        restore if any stage (ingest/mine/gather/score/witness) fails."""
        self._txn_counts_undo = []
        return {
            "store": self.store.begin(),
            "tick": self.tick,
            "stats": dict(self.stats),
            "last_report": self.last_report,
            "last_plan": self.last_plan,
        }

    def _rollback_tick(self, txn: dict) -> None:
        """Roll the store, counts, and tick counters back to the staged
        pre-tick state — bit-exact (asserted by the chaos tests against a
        pre-fault :meth:`TemporalGraphStore.state_dict` snapshot).  The
        store memo restore is total, so rolling back to tick N's memo
        also undoes any successor tick's ingest (the pipelined
        commit-failure path relies on this)."""
        self.store.rollback(txn["store"])
        for name, seeds, old in reversed(self._txn_counts_undo):
            self.counts[name][seeds] = old
        self._txn_counts_undo = []
        self.tick = txn["tick"]
        self.stats = dict(txn["stats"])
        self.last_report = txn["last_report"]
        self.last_plan = txn["last_plan"]
        self._tick_ctx = None

    # -- mining (dispatch phase) ----------------------------------------
    def _device_mirror(self, view: GraphView):
        """Pow2-padded device mirror of the tick view under the monotone
        high-water floors — consecutive ticks present ONE canonical shape
        family per path, so kernel traces replay instead of reminting."""
        f = self._pad_floors
        kn, ke = (
            ("full_nodes", "full_edges")
            if view.full
            else ("local_nodes", "local_edges")
        )
        dg = view.graph.to_device(
            pad=True,
            floor_nodes=f[kn],
            floor_edges=f[ke],
            floor_deg=f["deg"],
            device=self.device,
        )
        f[kn] = max(f[kn], dg.n_nodes)
        f[ke] = max(f[ke], dg.n_edges)
        f["deg"] = max(f["deg"], dg.max_deg)
        return dg

    def _dispatch_mine(
        self, plan: DeltaPlan, view: GraphView, stats: Dict[str, int]
    ) -> tuple:
        """Portfolio dispatch: launch EVERY pattern's dirty re-mine
        against the shared tick view/device mirror without a single host
        sync — the per-pattern device count vectors stay in flight until
        the commit-phase gather fetches them all at once."""
        dg = self._device_mirror(view)
        vals_cache: Dict[str, np.ndarray] = {}
        vecs: Dict[str, object] = {}
        seed_map: Dict[str, np.ndarray] = {}
        cps: Dict[str, CompiledPattern] = {}
        mined: Dict[str, set] = {}
        for name in self.pattern_names:
            seeds = plan.dirty.get(name)
            if seeds is None or len(seeds) == 0:
                continue
            cp = CompiledPattern(
                self._specs[name],
                view.graph,
                device_graph=dg,
                vals_cache=vals_cache,
                backend=self.backend,
                ir=self._irs[name],
                kernels_cache=self._kernels[name],
                trace_keys=self._trace_keys[name],
                schedule_cache=self._sched_caches[name],
                schedule_cache_cap=self.schedule_cache_cap,
                schedule_mode="shape",
                ladder=self.ladder,
            )
            vecs[name] = cp.mine_async(view.local_seeds(seeds), stats=stats)
            self._fire("mine")
            seed_map[name] = seeds
            if self.witnesses:
                cps[name] = cp
                mined[name] = set(int(e) for e in seeds)
        stats["jit_cache_entries"] = sum(
            len(s) for s in self._trace_keys.values()
        )
        return dg, vecs, seed_map, cps, mined

    def _gather_counts(self, inflight: _InflightTick) -> None:
        """The tick's ONE host sync: fetch every pattern's finished count
        vector in a single device transfer, then apply the counts writes
        under the undo log — this is the transactional commit point."""
        host = shard.gather(inflight.vecs, inflight.stats, mode="portfolio")
        for name, seeds in inflight.seed_map.items():
            vals = np.asarray(host[name])[: len(seeds)].astype(np.int64)
            # stage the overwritten counts so _rollback_tick can undo a
            # partially-committed tick bit-exactly (arrays were grown at
            # plan time, so writing `old` back always lands in the live
            # buffer)
            self._txn_counts_undo.append(
                (name, seeds, self.counts[name][seeds].copy())
            )
            self.counts[name][seeds] = vals

    def _extract_evidence(
        self,
        eids: np.ndarray,
        triggered: np.ndarray,
        stats: Dict[str, int],
        tick: Optional[int] = None,
    ) -> List[Dict[str, list]]:
        """Top-k witnesses for every (alert seed, fired pattern) pair
        whose count was recomputed this tick, witness-mined on the tick's
        own view/device mirror and resolved into transaction hops."""
        self._fire("witness", tick)
        out: List[Dict[str, list]] = [dict() for _ in range(len(eids))]
        if self._tick_ctx is None:
            return out
        view, dg, cps, mined = self._tick_ctx
        for j, name in enumerate(self.pattern_names):
            cp = cps.get(name)
            if cp is None:
                continue
            fresh = mined[name]
            rows = [
                i
                for i in range(len(eids))
                if triggered[i, j] and int(eids[i]) in fresh
            ]
            if not rows:
                continue
            before = dict(cp.stats)
            sub = np.asarray(eids[rows], dtype=np.int64)
            w = mine_witnesses(
                cp, view.local_seeds(sub), self.witnesses, dg=dg
            )
            for k in stats:
                stats[k] += cp.stats[k] - before[k]
            # resolve against the VIEW's arrival columns, not the store's
            # — under pipelining the store already holds the successor
            # tick's ingest (and may have evicted below the view window)
            resolved = w.translate(view.edge_ids).resolve(view.edge_fields)
            for r, i in enumerate(rows):
                out[i][name] = resolved[r]
        stats["jit_cache_entries"] = sum(
            len(s) for s in self._trace_keys.values()
        )
        return out

    def _score(
        self,
        eids: np.ndarray,
        view: GraphView,
        tick: Optional[int] = None,
    ) -> Tuple[np.ndarray, ...]:
        self._fire("score", tick)
        # view-resolved arrival columns: eviction-immune and correct even
        # after a successor tick's ingest (pipelined commit)
        src, dst, t, amt = view.edge_fields(eids)
        counts = np.stack(
            [self.counts[n][eids] for n in self.pattern_names], axis=1
        )
        triggered = np.zeros(counts.shape, dtype=bool)
        norm = np.zeros(counts.shape, dtype=np.float32)
        for j, name in enumerate(self.pattern_names):
            thr = self.thresholds.get(name)
            if thr is None:
                continue
            triggered[:, j] = counts[:, j] >= thr
            norm[:, j] = counts[:, j].astype(np.float32) / float(thr)
        if self.scorer is not None:
            feats = np.concatenate(
                [
                    np.stack(
                        [
                            src.astype(np.float32),
                            dst.astype(np.float32),
                            amt.astype(np.float32),
                        ],
                        axis=1,
                    ),
                    counts.astype(np.float32),
                ],
                axis=1,
            )
            score = np.asarray(self.scorer(feats), dtype=np.float32).reshape(-1)
        else:
            score = norm.max(axis=1) if counts.shape[1] else np.zeros(len(eids))
        keep = triggered.any(axis=1)
        return (
            eids[keep],
            src[keep],
            dst[keep],
            t[keep],
            amt[keep],
            counts[keep],
            score[keep].astype(np.float32),
            triggered[keep],
        )

    # -- the ingest loop ------------------------------------------------
    def submit(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        t: np.ndarray,
        amount: Optional[np.ndarray] = None,
    ) -> Optional[AlertBatch]:
        """Ingest one transaction microbatch, re-mine its dirty frontier,
        and return the scored alerts + the tick report.

        The tick is **transactional**: a failure anywhere in
        ingest/mine/gather/score/witness rolls the store, counts, and
        tick counters back to the pre-call state bit-exactly before the
        exception propagates — a failed tick never leaves the service
        diverged from the batch oracle.

        With ``pipeline=True`` the call dispatches THIS tick and commits
        the PREVIOUS one, returning the previous tick's
        :class:`AlertBatch` (``None`` on the first call — drain the tail
        with :meth:`flush`)."""
        with self._lock:
            if self.pipeline:
                return self._submit_pipelined(src, dst, t, amount)
            if self._inflight is not None:
                # pipelining was just switched off (e.g. a WAL replay):
                # settle the overlapped tail before going synchronous
                self.flush()
            txn = self._begin_tick()
            with obs_trace.span("tick", tick=self.tick + 1) as sp:
                self._tick_span_id = sp.span_id
                try:
                    batch = self._tick(src, dst, t, amount)
                except BaseException:
                    self._rollback_tick(txn)
                    raise
            # record AFTER the span closes so the flight entry carries
            # the complete per-stage span tree of the tick
            self.flight.record(batch.report, span_id=batch.report.span_id)
            return batch

    def _submit_pipelined(
        self, src, dst, t, amount
    ) -> Optional[AlertBatch]:
        txn = self._begin_tick()
        with obs_trace.span(
            "tick", tick=self.tick + 1, pipelined=True
        ) as sp:
            self._tick_span_id = sp.span_id
            try:
                inflight = self._tick_dispatch(src, dst, t, amount, txn=txn)
            except BaseException:
                # only THIS dispatch is rolled back; the predecessor's
                # in-flight tick is untouched and still committable
                self._rollback_tick(txn)
                raise
        prev, self._inflight = self._inflight, inflight
        if prev is not None:
            self._commit_inflight(prev, successor=inflight)
        return self._done.popleft() if self._done else None

    def _commit_inflight(
        self,
        prev: _InflightTick,
        successor: Optional[_InflightTick] = None,
    ) -> None:
        """Commit a dispatched tick (gather -> score -> report).  The
        commit-phase spans live under their own ``tick:commit`` root —
        the dispatch-phase tree stays attached to the tick's original
        ``tick`` span, so the two trees together represent the overlap."""
        with obs_trace.span(
            "tick:commit",
            tick=prev.tick,
            overlapped=successor is not None,
        ):
            try:
                batch = self._tick_commit(prev)
            except BaseException:
                # rolling back to prev's memo undoes prev's ingest AND
                # the successor's (the store restore is total), so
                # prev's input must re-enter the stream before anything
                # else: surface it (with its report notes) on
                # ``orphaned``.  The successor's input is the caller's
                # current batch — the caller already holds it.
                self._inflight = None
                self.orphaned.append((prev.tick, prev.input, prev.notes))
                self._rollback_tick(prev.txn)
                raise
        self.flight.record(batch.report, span_id=batch.report.span_id)
        # prev is now committed: refresh the successor's rollback memo so
        # a later failure lands on the committed-prev state (the memo was
        # taken before prev's commit folded its stats/report)
        if self._inflight is not None and self._inflight.txn is not None:
            self._inflight.txn["stats"] = dict(self.stats)
            self._inflight.txn["last_report"] = self.last_report
            self._inflight.txn["last_plan"] = self.last_plan
        self._done.append(batch)

    def flush(self) -> List[AlertBatch]:
        """Commit the in-flight tick (if any) and drain every committed
        batch the pipelined ``submit`` has not yet returned.  A no-op
        returning ``[]`` on a synchronous service."""
        with self._lock:
            prev, self._inflight = self._inflight, None
            if prev is not None:
                self._commit_inflight(prev, successor=None)
            out = list(self._done)
            self._done.clear()
            return out

    def _tick(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        t: np.ndarray,
        amount: Optional[np.ndarray] = None,
    ) -> AlertBatch:
        """One synchronous tick: dispatch + commit back to back.

        NOTE for subclassers: the pipelined path does NOT route through
        ``_tick`` — it calls :meth:`_tick_dispatch` and
        :meth:`_tick_commit` directly so the two phases can interleave
        across submits.  Stage-level extensions belong on those hooks
        (see the ROADMAP streaming-engine migration note)."""
        return self._tick_commit(self._tick_dispatch(src, dst, t, amount))

    def _tick_dispatch(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        t: np.ndarray,
        amount: Optional[np.ndarray] = None,
        txn: Optional[dict] = None,
    ) -> _InflightTick:
        """Host-side phase of a tick: ingest, delta plan, view build, and
        async portfolio mine dispatch.  Returns without any host sync —
        the device is free to overlap the launched mining with whatever
        the host does next (under ``pipeline=True``: the NEXT tick's
        dispatch)."""
        t0 = time.perf_counter()
        self.tick += 1
        self._tick_ctx = None
        traces_before = sum(len(s) for s in self._trace_keys.values())
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        t = np.asarray(t, dtype=np.int64)
        store_before = dict(self.store.stats)
        stats = executor.new_stats()
        inflight = _InflightTick(
            txn=txn,
            t0=t0,
            tick=self.tick,
            input=(src, dst, t, amount),
            stats=stats,
            span_id=self._tick_span_id,
            notes=dict(self._tick_notes),
            deadline=self._tick_deadline,
            count_only=self._count_only,
        )
        if len(src) == 0:
            inflight.n_live = self.store.n_live
            inflight.store_delta = {
                k: self.store.stats[k] - store_before.get(k, 0)
                for k in self.store.stats
            }
            return inflight
        cold = self.store.n_live == 0
        ts = time.perf_counter()
        with obs_trace.span("tick:ingest", n_rows=len(src)):
            eids = self.store.ingest(src, dst, t, amount)
            self._fire("ingest")
        inflight.ingest_ms = (time.perf_counter() - ts) * 1e3
        ts = time.perf_counter()
        with obs_trace.span("tick:plan"):
            plan = self.scheduler.plan(
                self.store, src, dst, t, eids, cold=cold
            )
            self._grow_counts()
        inflight.plan_ms = (time.perf_counter() - ts) * 1e3
        use_full = plan.cold or (
            plan.dirty_fraction >= self.full_remine_fraction
        )
        path = "cold" if plan.cold else ("full" if use_full else "local")
        ts = time.perf_counter()
        with obs_trace.span(
            "tick:mine", stats=stats, path=path, n_dirty=len(plan.union_dirty)
        ):
            if use_full:
                view = self.store.snapshot()
            else:
                view = self.store.local_view(
                    plan.core_nodes,
                    plan.t_lo,
                    node_floor=self._pad_floors["view_nodes"],
                )
                self._pad_floors["view_nodes"] = max(
                    self._pad_floors["view_nodes"], view.graph.n_nodes
                )
            dg, vecs, seed_map, cps, mined = self._dispatch_mine(
                plan, view, stats
            )
        inflight.mine_ms = (time.perf_counter() - ts) * 1e3
        inflight.n_new = len(eids)
        inflight.path = path
        inflight.plan = plan
        inflight.view = view
        inflight.dg = dg
        inflight.vecs = vecs
        inflight.seed_map = seed_map
        inflight.cps = cps
        inflight.mined = mined
        inflight.n_live = self.store.n_live
        # store deltas close at dispatch end: the store only mutates
        # during dispatch, and under pipelining the successor's ingest
        # would otherwise leak into this tick's report
        inflight.store_delta = {
            k: self.store.stats[k] - store_before.get(k, 0)
            for k in self.store.stats
        }
        # launch shapes are minted at dispatch; snapshotting the delta
        # here keeps a pipelined successor's fresh shapes out of this
        # tick's miss count (witness-stage shapes are added by _finish
        # around the extraction itself)
        inflight.trace_misses = max(
            0,
            sum(len(s) for s in self._trace_keys.values()) - traces_before,
        )
        return inflight

    def _tick_commit(self, inflight: _InflightTick) -> AlertBatch:
        """Host-sync phase of a tick: ONE portfolio gather fetches every
        pattern's finished device counts (the transactional commit
        point), then score/evidence/report run on the tick's own
        dispatch-time view."""
        if inflight.vecs:
            ts = time.perf_counter()
            with obs_trace.span(
                "tick:gather",
                stats=inflight.stats,
                tick=inflight.tick,
                n_patterns=len(inflight.vecs),
            ):
                self._gather_counts(inflight)
            self._fire("gather", inflight.tick)
            inflight.mine_ms += (time.perf_counter() - ts) * 1e3
        self._tick_ctx = (
            (inflight.view, inflight.dg, inflight.cps, inflight.mined)
            if self.witnesses and inflight.cps
            else None
        )
        batch = self._finish(inflight)
        self._txn_counts_undo = []  # committed: nothing left to undo
        return batch

    def _finish(self, inflight: _InflightTick) -> AlertBatch:
        # score + evidence BEFORE the stats/seconds snapshot, so witness
        # mining is accounted to this tick's report
        plan, view, stats = inflight.plan, inflight.view, inflight.stats
        notes = inflight.notes
        degraded = list(notes.get("degraded", ()))
        scored = None
        evidence = [] if self.witnesses else None
        score_ms = 0.0
        witness_traces_before = sum(
            len(s) for s in self._trace_keys.values()
        )
        if (
            plan is not None
            and len(plan.union_dirty)
            and not inflight.count_only
        ):
            ts = time.perf_counter()
            with obs_trace.span("tick:score", n_seeds=len(plan.union_dirty)):
                scored = self._score(plan.union_dirty, view, inflight.tick)
            score_ms = (time.perf_counter() - ts) * 1e3
            if self.witnesses:
                # in-tick shed: if the deadline budget is already blown,
                # drop evidence extraction (the most expensive optional
                # stage) rather than blow it further
                if (
                    inflight.deadline is not None
                    and time.perf_counter() > inflight.deadline
                ):
                    if "witnesses_off" not in degraded:
                        degraded.append("witnesses_off")
                else:
                    with obs_trace.span(
                        "tick:witness", stats=stats, n_alerts=len(scored[0])
                    ):
                        evidence = self._extract_evidence(
                            scored[0], scored[7], stats, inflight.tick
                        )
        for k in self.stats:
            if k == "jit_cache_entries":  # a gauge, not a counter
                self.stats[k] = max(self.stats[k], stats[k])
            else:
                self.stats[k] += stats[k]
        # fresh launch shapes minted this tick: the dispatch-phase delta
        # was snapshotted into the inflight record; add whatever the
        # witness stage just minted
        trace_misses = inflight.trace_misses + max(
            0,
            sum(len(s) for s in self._trace_keys.values())
            - witness_traces_before,
        )
        if trace_misses and inflight.path in ("local", "full"):
            logger.warning(
                "tick %d (%s path) minted %d fresh launch shape(s) — warm "
                "ticks should replay cached shapes; check the pow2 "
                "padding ladder / view-shape churn",
                inflight.tick,
                inflight.path,
                trace_misses,
            )
        report = TickReport(
            tick=inflight.tick,
            n_new=inflight.n_new,
            n_live=inflight.n_live,
            n_dirty=0 if plan is None else len(plan.union_dirty),
            dirty=(
                {}
                if plan is None
                else {n: len(d) for n, d in plan.dirty.items()}
            ),
            dirty_fraction=0.0 if plan is None else plan.dirty_fraction,
            path=inflight.path,
            view_nodes=0 if view is None else len(view.node_ids),
            view_edges=0 if view is None else len(view.edge_ids),
            seconds=time.perf_counter() - inflight.t0,
            stats=stats,
            store=inflight.store_delta,
            ingest_ms=inflight.ingest_ms,
            plan_ms=inflight.plan_ms,
            mine_ms=inflight.mine_ms,
            score_ms=score_ms,
            rejected=int(notes.get("rejected", 0)),
            quarantined=int(notes.get("quarantined", 0)),
            # breaches counted by the store on ingest, plus rows the
            # quarantine dead-lettered for lateness before the store
            # ever saw them (resilience late_policy="quarantine")
            late_contract_breach=int(
                inflight.store_delta.get("late_contract_breaches", 0)
            )
            + int(notes.get("late", 0)),
            degraded=tuple(degraded),
            retries=int(notes.get("retries", 0)),
            trace_misses=trace_misses,
            span_id=inflight.span_id,
        )
        self.last_report = report
        self.last_plan = plan
        # fold the tick into the global metrics registry (repro_torch.obs)
        reg = obs_metrics.get_registry()
        reg.histogram(
            "repro_stream_tick_seconds", help="end-to-end tick latency"
        ).observe(report.seconds)
        reg.counter(
            "repro_stream_trace_misses_total",
            help="fresh JIT traces minted by streaming ticks",
        ).inc(trace_misses)
        obs_metrics.observe_stats(stats, "repro_executor")
        obs_metrics.observe_stats(inflight.store_delta, "repro_store")
        if scored is None:
            empty = np.zeros(0, dtype=np.int64)
            return AlertBatch(
                eids=empty,
                src=np.zeros(0, np.int32),
                dst=np.zeros(0, np.int32),
                t=np.zeros(0, np.int64),
                amount=np.zeros(0, np.float32),
                counts=np.zeros((0, len(self.pattern_names)), np.int64),
                score=np.zeros(0, np.float32),
                triggered=np.zeros((0, len(self.pattern_names)), bool),
                columns=self.pattern_names,
                report=report,
                evidence=evidence,
            )
        (eids, s, d, tt, amt, counts, score, trig) = scored
        return AlertBatch(
            eids=eids,
            src=s,
            dst=d,
            t=tt,
            amount=amt,
            counts=counts,
            score=score,
            triggered=trig,
            columns=self.pattern_names,
            report=report,
            evidence=evidence,
        )

    # -- batch parity ---------------------------------------------------
    def recompute_counts(self, name: str) -> np.ndarray:
        """Counts of `name` recomputed from scratch on the live graph
        (the equivalence oracle for incremental mining; O(E) batch
        work — tests and benchmarks only)."""
        view = self.store.snapshot()
        cp = CompiledPattern(
            self._specs[name],
            view.graph,
            backend=self.backend,
            ir=self._irs[name],
            device=self.device,
        )
        return cp.mine()
