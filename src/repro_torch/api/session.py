"""Portfolio mining sessions (the `repro_torch.api` front-end), in torch.

The port of the JAX package's ``repro.api.session``.  AML detection runs
a *portfolio* of typologies over one shared graph, so the portfolio — not
the single pattern — is the unit of work.  :class:`MiningSession`
registers many patterns, runs ONE shared analysis, and mines everything:

* every compiled plan is **canonicalized and hashed** (stage names are
  renamed in schedule order), so structurally identical patterns share a
  single compiled plan and a single mining pass;
* **seed-local patterns** (no frontiers, no intersect: fan_in, fan_out,
  deg_in, deg_out, cycle2, stack, ...) are **fused into one portfolio
  kernel callable**: their count stages are deduplicated across patterns
  and evaluated in a single pass over the seed batch, with one host sync;
* the remaining patterns compile against a **shared device graph** and a
  **session-level host requirement cache**, and each syncs once.

So a compiled portfolio mine costs ``host_syncs == 1 + n_compiled``, as
in the JAX package.

Where it runs: on the CUDA card by default (``device=None``); the CPU
only when the caller passes ``device="cpu"``.  There is no silent
fallback.  Backends: ``"compiled"`` (default), ``"oracle"`` (the numpy GFP
enumerator), ``"streaming"`` (single-shot ingest through
:class:`repro_torch.stream.DetectionService`), ``"partitioned"``
(degree-balanced edge partitions mined in turn through the same compiled
plans) and ``"sharded"`` (every partition's launches dispatched to its
own device via :mod:`repro_torch.core.shard`, per-device resident
accumulators, ONE blocking gather per mine).  ``mine(witnesses=k)``
(compiled backend) returns, next to the counts, the top-k matching edge
tuples of every seed (:class:`repro_torch.witness.Witnesses`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import executor, ops
from repro_torch.core.compiler import (
    BATCH_ELEM_CAP,
    BUCKET_LADDER,
    CompiledPattern,
    StageGraphIR,
    analyze_stage_graph,
    schedule_cache_cap_for,
)
from repro_torch.core.spec import (
    Neigh,
    NodeRef,
    PatternSpec,
    SetExpr,
    Stage,
    StageT,
    TimeBound,
    Window,
    _SeedT,
)
from repro_torch.api.dsl import PatternBuilder
from repro_torch.device import h2d, resolve_device, to_host
from repro_torch.graph.csr import TemporalGraph
from repro_torch.kernels.window_search import ops as ws_ops
from repro_torch.obs import trace as obs_trace

__all__ = [
    "MiningSession",
    "MiningResult",
    "canonical_key",
    "canonicalize",
    "mine_features",
    "featurize",
]

BACKENDS = ("compiled", "oracle", "streaming", "partitioned", "sharded")


# ----------------------------------------------------------------------
# canonicalization: structural plan identity across stage renamings
# ----------------------------------------------------------------------
def _rename_stage(st: Stage, m: Dict[str, str]) -> Stage:
    def rref(r: NodeRef) -> NodeRef:
        return NodeRef(m.get(r.name, r.name))

    def rneigh(n: Neigh) -> Neigh:
        return Neigh(rref(n.node), n.direction)

    def ropn(o):
        if isinstance(o, SetExpr):
            return SetExpr(o.op, rneigh(o.left), rneigh(o.right))
        if isinstance(o, Neigh):
            return rneigh(o)
        return o

    def rbound(b: TimeBound) -> TimeBound:
        if isinstance(b.anchor, StageT):
            return TimeBound(StageT(m.get(b.anchor.name, b.anchor.name)), b.offset)
        return b

    def rwin(w: Window) -> Window:
        return Window(rbound(w.after), rbound(w.until))

    return dataclasses.replace(
        st,
        name=m.get(st.name, st.name),
        operand=ropn(st.operand) if st.operand is not None else None,
        operands=(
            tuple(rneigh(x) for x in st.operands) if st.operands is not None else None
        ),
        edge_src=rref(st.edge_src) if st.edge_src is not None else None,
        edge_dst=rref(st.edge_dst) if st.edge_dst is not None else None,
        skip_eq=tuple(sorted((rref(r) for r in st.skip_eq), key=lambda r: r.name)),
        window=rwin(st.window),
        window2=rwin(st.window2),
        factors=(
            tuple(m.get(f, f) for f in st.factors) if st.factors is not None else None
        ),
    )


def canonicalize(spec: PatternSpec) -> Tuple[Stage, ...]:
    """Stages in schedule order with names rewritten to s0..sk and skip
    sets sorted — a structural identity that ignores the author's naming
    and (partially) listing order.  Conservative: two canonical forms
    being different does not prove the patterns differ, but equal forms
    are guaranteed-identical plans."""
    schedule = spec.topo_order()
    m = {st.name: f"s{i}" for i, st in enumerate(schedule)}
    return tuple(_rename_stage(st, m) for st in schedule)


def canonical_key(spec: PatternSpec) -> str:
    """Stable hash of the canonicalized stage tuple."""
    return hashlib.sha1(repr(canonicalize(spec)).encode()).hexdigest()[:16]


# ----------------------------------------------------------------------
# seed-local fusion: one kernel for the whole windowed-degree family
# ----------------------------------------------------------------------
def _bound_key(tb: TimeBound):
    if tb.anchor is None:
        return ("abs", int(tb.offset))
    assert isinstance(tb.anchor, _SeedT), "seed-local stages anchor at the seed"
    return ("seed", int(tb.offset))


def _window_key(w: Window):
    return (_bound_key(w.after), _bound_key(w.until))


def _unit_key(st: Stage):
    if st.op == "count_window":
        return ("cw", st.operand.node.name, st.operand.direction, _window_key(st.window))
    if st.op == "count_edges":
        return ("ce", st.edge_src.name, st.edge_dst.name, _window_key(st.window))
    raise TypeError(st.op)


def _is_seed_local(ir: StageGraphIR) -> bool:
    return not ir.frontiers and ir.intersect is None


class _FusedSeedPlan:
    """All seed-local patterns of a session lowered to ONE kernel callable.

    Count stages are deduplicated across patterns by
    ``(op, node, direction, window)``; the callable evaluates every unique
    unit over the seed batch in a single launch per chunk, and pattern
    outputs (possibly ``product`` combinations) are assembled host-side.
    ``backend="kernel"`` runs each unit's windowed search as one launch of
    the ``window_search`` kernel, ``"torch"`` as the eager plain searches.
    """

    def __init__(
        self,
        members: Dict[str, PatternSpec],  # canonical key -> representative
        graph: TemporalGraph,
        device_graph,
        batch_elem_cap: int = BATCH_ELEM_CAP,
        backend: str = "kernel",
    ):
        self.g = graph
        self.dg = device_graph
        self.batch_elem_cap = int(batch_elem_cap)
        self.backend = backend
        self.n_iters = ops.n_iters_for(self.dg.max_deg)
        self._unit_keys: List[tuple] = []
        self._unit_stages: List[Stage] = []
        # canonical key -> tuple of unit indices multiplied into the emit
        self.emits: Dict[str, Tuple[int, ...]] = {}
        for key, spec in members.items():
            self.emits[key] = self._resolve_emit(spec, spec.emit_stage)
        # one callable per requested unit subset (a subset mine must not
        # launch — or get charged for — unrequested patterns' units)
        self._built: Dict[Tuple[int, ...], Callable] = {}
        self._build_lock = threading.Lock()

    # -- unit registry --------------------------------------------------
    def _unit_index(self, st: Stage) -> int:
        k = _unit_key(st)
        try:
            return self._unit_keys.index(k)
        except ValueError:
            self._unit_keys.append(k)
            self._unit_stages.append(st)
            return len(self._unit_keys) - 1

    def _resolve_emit(self, spec: PatternSpec, st: Stage) -> Tuple[int, ...]:
        if st.op == "product":
            by_name = {s.name: s for s in spec.stages}
            out: Tuple[int, ...] = ()
            for f in st.factors:
                out += self._resolve_emit(spec, by_name[f])
            return out
        return (self._unit_index(st),)

    @property
    def n_units(self) -> int:
        return len(self._unit_stages)

    def units_for(self, keys) -> Tuple[int, ...]:
        """Sorted unit indices needed to emit the given canonical keys."""
        return tuple(sorted({i for k in keys for i in self.emits[k]}))


    # -- lowering -------------------------------------------------------
    def _build(self, unit_sel: Tuple[int, ...]) -> Callable:
        units = tuple(self._unit_stages[i] for i in unit_sel)
        n_iters = self.n_iters
        srch = ws_ops if self.backend == "kernel" else ops

        def bound(tb: TimeBound, t):
            if tb.anchor is None:
                return int(tb.offset)
            return t + int(tb.offset)

        def kernel(dg, s, d, t):
            env = {"seed.src": s, "seed.dst": d}
            cols = []
            for st in units:
                a = bound(st.window.after, t)
                u = bound(st.window.until, t)
                if st.op == "count_window":
                    if st.operand.direction == "out":
                        indptr, t_sorted = dg.out_indptr, dg.out_t_sorted
                    else:
                        indptr, t_sorted = dg.in_indptr, dg.in_t_sorted
                    cols.append(
                        srch.count_window(
                            t_sorted, indptr, env[st.operand.node.name], a, u, n_iters
                        )
                    )
                else:  # count_edges between two bound seed endpoints
                    cols.append(
                        srch.count_id_in_window(
                            dg.out_nbr,
                            dg.out_t,
                            dg.out_indptr,
                            env[st.edge_src.name],
                            env[st.edge_dst.name],
                            a,
                            u,
                            n_iters,
                        )
                    )
            # a column may broadcast from a 0-d bound: give each (B,)
            return torch.stack([c.expand(s.shape) for c in cols], dim=1)  # (B, U)

        return kernel

    # -- execution ------------------------------------------------------
    def launch_units(
        self,
        seed_eids: np.ndarray,
        stats: Dict[str, int],
        unit_sel: Optional[Tuple[int, ...]] = None,
        dg=None,
        device=None,
        coalesce: int = 1,
    ) -> torch.Tensor:
        """Dispatch the fused pass WITHOUT the final host sync: returns
        the device-resident ``(padded_n, len(unit_sel))`` int32 unit
        matrix (rows past ``len(seed_eids)`` are padding).

        ``dg``/``device`` override the resident graph mirror and launch
        placement: the sharded executor passes one replica and device per
        partition (launches land on the replica's device; ``device``, when
        given, must be of its kind).  The unit callables are shared.
        ``coalesce > 1`` merges equal-width chunk runs into fatter
        launches (:func:`executor.coalesce_widths`), the sharded
        executor's dispatch-overhead knob."""
        if unit_sel is None:
            unit_sel = tuple(range(self.n_units))
        n_units = len(unit_sel)
        fn = self._built.get(unit_sel)  # lock-free warm path
        if fn is None:
            with self._build_lock:
                fn = self._built.get(unit_sel)
                if fn is None:
                    fn = self._build(unit_sel)
                    self._built[unit_sel] = fn
        g = self.g
        dg = self.dg if dg is None else dg
        if device is not None and torch.device(device).type != dg.device.type:
            raise ValueError(f"device {device} differs from the graph mirror's {dg.device}")
        n = len(seed_eids)
        if n == 0 or n_units == 0:
            return torch.zeros((n, n_units), dtype=torch.int32, device=dg.device)
        widths = executor.chunk_widths(n, self.batch_elem_cap, n_units)
        if coalesce > 1:
            widths = executor.coalesce_widths(widths, coalesce)
        total = sum(widths)
        # one padded staging buffer (padding only ever lands in the tail
        # chunk), one host→device transfer for the whole batch
        with obs_trace.span(
            "stage", stats=stats, strat="fused", n_seeds=n
        ):
            staging = np.zeros((3, total), np.int32)
            staging[:2] = -1
            staging[0, :n] = g.src[seed_eids]
            staging[1, :n] = g.dst[seed_eids]
            staging[2, :n] = g.t[seed_eids]
            dev_s, dev_d, dev_t = h2d(staging, dg.device).unbind(0)
            stats["bytes_h2d"] += int(staging.nbytes)
        with obs_trace.span(
            "launch", stats=stats, strat="fused", n_chunks=len(widths)
        ):
            chunks = []
            s0 = 0
            for w in widths:
                sl = slice(s0, s0 + w)
                chunks.append(fn(dg, dev_s[sl], dev_d[sl], dev_t[sl]))
                stats["kernel_calls"] += 1
                stats["padded_elements"] += w * n_units
                s0 += w
            return chunks[0] if len(chunks) == 1 else torch.cat(chunks)

    def mine_units(
        self,
        seed_eids: np.ndarray,
        stats: Dict[str, int],
        unit_sel: Optional[Tuple[int, ...]] = None,
    ) -> np.ndarray:
        """(n_seeds, len(unit_sel)) int64 unit values; one kernel launch
        per (ladder-padded) seed chunk regardless of how many patterns
        fused.  `unit_sel` (default: all units) restricts the launch to
        the units the requested patterns actually need.

        Device-resident: the staging buffer moves with a single
        host→device copy, per-chunk launches stay asynchronous on device
        slices, and the finished unit matrix comes back in ONE blocking
        device→host transfer."""
        n = len(seed_eids)
        if unit_sel is None:
            unit_sel = tuple(range(self.n_units))
        if n == 0 or len(unit_sel) == 0:
            return np.zeros((n, len(unit_sel)), dtype=np.int64)
        dev_out = self.launch_units(seed_eids, stats, unit_sel)
        with obs_trace.span("gather", stats=stats, mode="fused"):
            host = to_host(dev_out)  # THE one host sync of the fused pass
            stats["host_syncs"] += 1
            stats["bytes_d2h"] += int(host.nbytes)
        return host[:n].astype(np.int64)

    def assemble(
        self, key: str, unit_vals: np.ndarray, unit_sel: Tuple[int, ...]
    ) -> np.ndarray:
        """Pattern output from unit columns (product factors multiply)."""
        idxs = [unit_sel.index(i) for i in self.emits[key]]
        col = unit_vals[:, idxs[0]].copy()
        for i in idxs[1:]:
            col *= unit_vals[:, i]
        return col


# ----------------------------------------------------------------------
# results
# ----------------------------------------------------------------------
@dataclasses.dataclass
class MiningResult:
    """Structured portfolio mining output.

    ``counts[:, j]`` is the participation count of every requested seed
    edge in pattern ``columns[j]``.  ``seconds`` is per-pattern wall time;
    patterns listed in ``fused`` were mined by ONE shared kernel pass, and
    each reports that shared pass's wall time (not additive).  ``stats``
    are this call's deltas of the executor counters (see
    :data:`repro_torch.core.executor.STAT_KEYS`): kernel launches, padded
    elements, branch items, host syncs (exactly one per compiled plan and
    one for the fused pass), staging bytes h2d/d2h, new launch shapes,
    and bucket-schedule cache hits.

    Sharded mines (``backend="sharded"``) also report per-shard
    observability: ``per_shard_seconds`` (per-shard dispatch walls,
    measured on concurrent per-device dispatch threads, so they overlap
    and do NOT sum to the mine wall), ``dispatch_wall_s`` (the true
    window of the overlapped dispatch), ``gather_mode`` (``"collective"``
    when the shards' rows were reduced on the device, ``"host"`` for the
    time-shared ``n_parts > n_devices`` fallback), ``shard_stats`` (one
    executor counter dict per shard), ``shard_devices`` (the device each
    shard ran on) and ``worker_liveness``; :meth:`dispatch_overlap_ratio`
    and :meth:`shard_balance` summarize them.  A sharded mine's
    ``stats["host_syncs"]`` is exactly 1 in either gather mode.
    """

    columns: Tuple[str, ...]
    counts: np.ndarray  # (n_seeds, n_patterns) int64
    backend: str
    n_seeds: int
    seconds: Dict[str, float]
    stats: Dict[str, int]
    fused: Tuple[str, ...] = ()
    # witness mode (mine(witnesses=k)): per-pattern
    # :class:`repro_torch.witness.Witnesses` — top-k matching edge tuples
    # per seed, aligned with ``counts`` rows
    witnesses: Optional[Dict[str, object]] = None
    # partitioned mines: per-part walls and the partition plan
    per_part_seconds: Optional[List[float]] = None
    partition_plan: Optional[object] = None
    per_shard_seconds: Optional[List[float]] = None
    shard_stats: Optional[List[Dict[str, int]]] = None
    shard_devices: Optional[Tuple[str, ...]] = None
    dispatch_wall_s: Optional[float] = None
    gather_mode: Optional[str] = None
    # per-device dispatch-worker liveness (heartbeat instants, beat
    # counts, wall medians, flagged stragglers): sharded mines only
    worker_liveness: Optional[dict] = None

    def dispatch_overlap_ratio(self) -> Optional[float]:
        """Sum of per-shard dispatch walls over the overlapped dispatch
        window: 1.0 means fully serialized dispatch, ``n_shards`` means
        perfect overlap.  None unless ``backend="sharded"``."""
        if self.per_shard_seconds is None or not self.dispatch_wall_s:
            return None
        return float(sum(self.per_shard_seconds) / self.dispatch_wall_s)

    def column(self, name: str) -> np.ndarray:
        return self.counts[:, self.columns.index(name)]

    def shard_balance(self) -> Optional[Dict[str, float]]:
        """Predicted vs achieved load balance of a sharded mine: the
        partitioner's cost-model skew next to the realized kernel-call
        and padded-element skews (max over shards / mean; 1.0 = perfectly
        balanced).  None unless ``backend="sharded"``."""
        if self.shard_stats is None or self.partition_plan is None:
            return None

        def skew(xs) -> float:
            xs = np.asarray(xs, dtype=np.float64)
            m = xs.mean() if xs.size else 0.0
            return float(xs.max() / m) if m > 0 else 1.0

        return {
            "predicted_cost_skew": float(self.partition_plan.skew),
            "kernel_call_skew": skew([s["kernel_calls"] for s in self.shard_stats]),
            "padded_element_skew": skew([s["padded_elements"] for s in self.shard_stats]),
        }

    def as_features(self) -> np.ndarray:
        """float32 feature block, one column per pattern."""
        return self.counts.astype(np.float32)

    def totals(self) -> Dict[str, int]:
        return {c: int(self.counts[:, j].sum()) for j, c in enumerate(self.columns)}


# ----------------------------------------------------------------------
# the session
# ----------------------------------------------------------------------
PatternLike = Union[str, PatternSpec, PatternBuilder]


class MiningSession:
    """Register a pattern portfolio once, compile once, mine everything.

    >>> session = MiningSession(graph, window=4096)   # on the CUDA card
    >>> session.register("fan_in", "cycle3", my_builder, my_spec)
    >>> res = session.mine()              # all registered patterns
    >>> res.column("cycle3"), res.stats["kernel_calls"]

    ``window`` is the default window used to instantiate library patterns
    referenced by name.  ``device`` places the graph mirror and every
    launch: ``None`` means the CUDA card and raises when there is none;
    pass ``device="cpu"`` to run the plain PyTorch path on the CPU.

    ``kernel_backend`` selects the lowering of the pairwise compare cube
    in every compiled plan: ``"kernel"`` (default) routes it, and the
    pairwise ``count_edges``, through the hand-written CUDA
    ``intersect_count`` kernel (its plain PyTorch version on the CPU);
    ``"torch"`` broadcasts it inline.  They are the counterparts of the
    JAX session's ``"pallas"`` and ``"xla"``.  The JAX session defaults to
    ``kernel_backend="xla"``, which keeps its own Pallas kernel off its
    main path; this port defaults to the kernel, so its main path runs
    it.  Under ``"kernel"`` the compiled and fused plans also run their
    windowed searches, and the compiled plans their whole bs1 / bs2
    intersect steps, as ``window_search`` launches, under ``"torch"`` as
    eager ops; witness extraction always goes through the
    ``window_search`` wrapper.  Counts are identical either way.

    ``shard_coalesce`` is the sharded backend's chunk-coalescing factor
    (runs of up to this many equal-width chunks merge into one launch per
    device; 1 disables), and ``shard_heartbeat_dir`` turns on file-backed
    per-device dispatch-worker heartbeats (liveness is reported on
    ``MiningResult.worker_liveness`` either way).
    """

    def __init__(
        self,
        graph: Optional[TemporalGraph] = None,
        *,
        window: Optional[int] = None,
        ladder: Tuple[int, ...] = BUCKET_LADDER,
        batch_elem_cap: int = BATCH_ELEM_CAP,
        kernel_backend: str = "kernel",
        device=None,
        shard_coalesce: int = 4,
        shard_heartbeat_dir: Optional[str] = None,
    ):
        self.graph = graph
        self.window = window
        self.ladder = tuple(ladder)
        self.batch_elem_cap = int(batch_elem_cap)
        self.kernel_backend = kernel_backend
        self.device = resolve_device(device)
        self.shard_coalesce = int(shard_coalesce)
        self.shard_heartbeat_dir = shard_heartbeat_dir
        self._specs: Dict[str, PatternSpec] = {}  # name -> spec (reg. order)
        self._canon_of: Dict[str, str] = {}  # name -> canonical key
        self._members: Dict[str, PatternSpec] = {}  # key -> representative
        self._irs: Dict[str, StageGraphIR] = {}  # key -> IR
        # shared backend state (one per session, every plan reuses it);
        # the requirement cache is shared across every compiled plan, so
        # all plans share one lock
        self._dg = None
        self._vals_cache: Dict[str, np.ndarray] = {}
        self._vals_lock = threading.Lock()
        self._compiled: Dict[str, CompiledPattern] = {}
        # witness mode bypasses seed-local fusion (a fused launch has no
        # per-pattern compare cube to select witnesses from), so fused
        # patterns get an on-demand standalone plan cached here
        self._wit_compiled: Dict[str, CompiledPattern] = {}
        self._fused: Optional[_FusedSeedPlan] = None
        self._oracles: Dict[str, object] = {}  # key -> GFPReference
        self._shard_ctx = None  # per-device graph replicas (sharded backend)
        self._analyzed = False
        # lifetime counters (mirrors CompiledPattern.stats, portfolio-wide)
        self.stats = executor.new_stats()

    # -- registration ---------------------------------------------------
    def _as_spec(self, pat: PatternLike, window: Optional[int]) -> PatternSpec:
        if isinstance(pat, PatternSpec):
            return pat
        if isinstance(pat, PatternBuilder):
            return pat.build()
        if isinstance(pat, str):
            from repro_torch.core.patterns import build_pattern

            w = window if window is not None else self.window
            if w is None:
                raise ValueError(
                    f"registering library pattern {pat!r} by name needs a "
                    f"window (pass window= to the session or to register())"
                )
            return build_pattern(pat, int(w))
        raise TypeError(f"cannot register {pat!r} as a pattern")

    def register(
        self, *patterns: PatternLike, window: Optional[int] = None
    ) -> "MiningSession":
        """Add patterns (library names, PatternSpecs, or builders) to the
        portfolio.  Chainable.  Re-registering an identical pattern is a
        no-op; a different pattern under a taken name is an error."""
        for pat in patterns:
            spec = self._as_spec(pat, window)
            key = canonical_key(spec)
            if spec.name in self._specs:
                if self._canon_of[spec.name] == key:
                    continue
                raise ValueError(
                    f"pattern name {spec.name!r} already registered with a "
                    f"different structure"
                )
            self._specs[spec.name] = spec
            self._canon_of[spec.name] = key
            if key not in self._members:
                self._members[key] = spec
                self._irs[key] = analyze_stage_graph(spec)
                self._analyzed = False  # new plan: fusion must be redone
        return self

    @property
    def pattern_names(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    # -- shared analysis / compilation ---------------------------------
    def compile(self) -> "MiningSession":
        """Run the shared portfolio analysis: canonical dedup (done at
        registration), seed-local fusion, and compiled-plan construction
        against one shared device graph + requirement cache."""
        if self._analyzed:
            return self
        if self.graph is None:
            raise ValueError("session has no graph; pass one to MiningSession()")
        if self._dg is None:
            self._dg = self.graph.to_device(device=self.device)
        fused_members = {
            k: s for k, s in self._members.items() if _is_seed_local(self._irs[k])
        }
        # keep the existing fused plan (and its callables) when a new
        # registration didn't change the seed-local member set
        if self._fused is None or set(self._fused.emits) != set(fused_members):
            self._fused = _FusedSeedPlan(
                fused_members,
                self.graph,
                self._dg,
                self.batch_elem_cap,
                backend=self.kernel_backend,
            )
        for key, spec in self._members.items():
            if key in fused_members or key in self._compiled:
                continue
            self._compiled[key] = CompiledPattern(
                spec,
                self.graph,
                ladder=self.ladder,
                batch_elem_cap=self.batch_elem_cap,
                device_graph=self._dg,
                vals_cache=self._vals_cache,
                vals_lock=self._vals_lock,
                backend=self.kernel_backend,
            )
        self._analyzed = True
        return self

    def plan_text(self) -> str:
        """Human-readable portfolio plan: fusion groups + compiled plans."""
        self.compile()
        lines = [f"portfolio of {len(self._specs)} patterns "
                 f"({len(self._members)} unique plans)"]
        fused = [n for n in self._specs if self._canon_of[n] in self._fused.emits]
        if fused:
            lines.append(
                f"  fused seed-local kernel: {', '.join(fused)} "
                f"({self._fused.n_units} deduped count units, 1 launch/batch)"
            )
        for name in self._specs:
            key = self._canon_of[name]
            if key in self._compiled:
                aliases = [m for m in self._specs if self._canon_of[m] == key]
                tag = f" [shared by {', '.join(aliases)}]" if len(aliases) > 1 else ""
                lines.append(f"  compiled {name}{tag}:")
                lines += [
                    "    " + ln for ln in self._compiled[key].plan_text().splitlines()
                ]
        return "\n".join(lines)

    # -- mining ---------------------------------------------------------
    def _resolve_names(self, patterns) -> List[str]:
        if patterns is None:
            return list(self._specs)
        if isinstance(patterns, (str, PatternSpec, PatternBuilder)):
            patterns = [patterns]
        names = []
        for pat in patterns:
            if isinstance(pat, str) and pat in self._specs:
                names.append(pat)
            else:
                spec = self._as_spec(pat, None)
                self.register(spec)
                names.append(spec.name)
        return names

    def _mine_compiled(
        self, names: List[str], seeds: np.ndarray
    ) -> Tuple[np.ndarray, Dict[str, float], Tuple[str, ...], Dict[str, int]]:
        """One compiled portfolio pass over `seeds`; shared-kernel columns
        are computed in a single fused launch group."""
        self.compile()
        stats = executor.new_stats()
        out = np.zeros((len(seeds), len(names)), dtype=np.int64)
        seconds: Dict[str, float] = {}
        fused_cols = [
            (j, n) for j, n in enumerate(names) if self._canon_of[n] in self._fused.emits
        ]
        if fused_cols:
            unit_sel = self._fused.units_for({self._canon_of[n] for _, n in fused_cols})
            t0 = time.perf_counter()
            unit_vals = self._fused.mine_units(seeds, stats, unit_sel)
            dt = time.perf_counter() - t0
            for j, n in fused_cols:
                out[:, j] = self._fused.assemble(self._canon_of[n], unit_vals, unit_sel)
                seconds[n] = dt  # shared fused-pass wall time (not additive)
        done: Dict[str, Tuple[np.ndarray, float]] = {}
        for j, n in enumerate(names):
            key = self._canon_of[n]
            if key not in self._compiled:
                continue
            if key not in done:
                cp = self._compiled[key]
                before = dict(cp.stats)
                t0 = time.perf_counter()
                col = cp.mine(seeds)
                done[key] = (col, time.perf_counter() - t0)
                for k in stats:
                    stats[k] += cp.stats[k] - before[k]
            out[:, j], seconds[n] = done[key]
        for k in stats:
            self.stats[k] += stats[k]
        return out, seconds, tuple(n for _, n in fused_cols), stats

    def _compiled_for(self, key: str) -> CompiledPattern:
        """A standalone compiled plan for a canonical key — the regular
        plan when one exists, else (seed-local patterns, normally served
        by the fused kernel) an on-demand plan sharing the session's
        device graph and requirement cache."""
        cp = self._compiled.get(key)
        if cp is not None:
            return cp
        cp = self._wit_compiled.get(key)
        if cp is None:
            cp = CompiledPattern(
                self._members[key],
                self.graph,
                ladder=self.ladder,
                batch_elem_cap=self.batch_elem_cap,
                device_graph=self._dg,
                vals_cache=self._vals_cache,
                vals_lock=self._vals_lock,
                backend=self.kernel_backend,
                ir=self._irs[key],
            )
            self._wit_compiled[key] = cp
        return cp

    def _mine_witnesses(
        self, names: List[str], seeds: np.ndarray, k: int
    ) -> MiningResult:
        """The witness-mode portfolio pass: one witness mine per unique
        plan (each with its single combined counts+ids host sync); counts
        come straight from the witness kernels, so no counting pass runs."""
        self.compile()
        stats = executor.new_stats()
        out = np.zeros((len(seeds), len(names)), dtype=np.int64)
        seconds: Dict[str, float] = {}
        wits: Dict[str, object] = {}
        done: Dict[str, Tuple[object, float]] = {}
        for j, n in enumerate(names):
            key = self._canon_of[n]
            if key not in done:
                cp = self._compiled_for(key)
                before = dict(cp.stats)
                t0 = time.perf_counter()
                w = cp.mine(seeds, witnesses=k)
                done[key] = (w, time.perf_counter() - t0)
                for kk in stats:
                    stats[kk] += cp.stats[kk] - before[kk]
            w, dt = done[key]
            out[:, j] = w.counts
            seconds[n] = dt
            wits[n] = w
        for kk in stats:
            self.stats[kk] += stats[kk]
        return MiningResult(
            columns=tuple(names),
            counts=out,
            backend="compiled",
            n_seeds=len(seeds),
            seconds=seconds,
            stats=stats,
            witnesses=wits,
        )

    def mine(
        self,
        patterns: Optional[Sequence[PatternLike]] = None,
        seeds: Optional[np.ndarray] = None,
        backend: str = "compiled",
        n_parts: Optional[int] = None,
        witnesses: int = 0,
    ) -> MiningResult:
        """Mine the requested patterns (default: every registered one)
        over `seeds` (default: every edge) and return a MiningResult.

        ``n_parts`` applies to the partition-based backends: default 4
        for ``"partitioned"`` and one partition per mining device for
        ``"sharded"`` (round-robin when it exceeds the device count; the
        devices are the visible cards, or on the CPU the lanes of
        :func:`repro_torch.launch.mesh.ensure_host_devices`).

        ``witnesses=k`` (compiled backend only) returns, per pattern and
        seed, the top-k matching edge tuples next to the counts — see
        :class:`repro_torch.witness.Witnesses`; ``result.witnesses[name]``."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
        if self.graph is None:
            raise ValueError("session has no graph; pass one to MiningSession()")
        if witnesses and backend != "compiled":
            raise ValueError(
                "witnesses=k is a compiled-backend feature (device-side "
                f"selection over the compare cubes); got backend={backend!r}"
            )
        names = self._resolve_names(patterns)
        g = self.graph
        if seeds is None:
            seeds = np.arange(g.n_edges, dtype=np.int32)
        seeds = np.asarray(seeds, dtype=np.int32)

        if witnesses:
            return self._mine_witnesses(names, seeds, int(witnesses))

        if backend == "compiled":
            counts, seconds, fused, stats = self._mine_compiled(names, seeds)
            return MiningResult(
                columns=tuple(names),
                counts=counts,
                backend=backend,
                n_seeds=len(seeds),
                seconds=seconds,
                stats=stats,
                fused=fused,
            )

        if backend == "oracle":
            from repro_torch.core.oracle import GFPReference

            counts = np.zeros((len(seeds), len(names)), dtype=np.int64)
            seconds: Dict[str, float] = {}
            done: Dict[str, Tuple[np.ndarray, float]] = {}
            for j, n in enumerate(names):
                key = self._canon_of[n]
                if key not in done:
                    if key not in self._oracles:
                        self._oracles[key] = GFPReference(self._members[key], g)
                    t0 = time.perf_counter()
                    col = self._oracles[key].mine(seeds)
                    done[key] = (col, time.perf_counter() - t0)
                counts[:, j], seconds[n] = done[key]
            return MiningResult(
                columns=tuple(names),
                counts=counts,
                backend=backend,
                n_seeds=len(seeds),
                seconds=seconds,
                stats=executor.new_stats(),
            )

        if backend == "streaming":
            svc = self.service(names)
            t0 = time.perf_counter()
            svc.submit(g.src, g.dst, g.t, g.amount)
            dt = time.perf_counter() - t0
            counts = np.stack(
                [svc.pattern_counts(n)[seeds] for n in names], axis=1
            )
            stats = dict(svc.last_report.stats)
            for k in self.stats:
                self.stats[k] += stats[k]
            return MiningResult(
                columns=tuple(names),
                counts=counts,
                backend=backend,
                n_seeds=len(seeds),
                seconds={n: dt for n in names},
                stats=stats,
            )

        if backend == "sharded":
            return self._mine_sharded(names, seeds, n_parts)

        # partitioned: degree-balanced parts mined in turn through the
        # SAME compiled plans (kernel caches and _vals_cache are shared,
        # so later parts build no new callables).  Reassembly scatters
        # through the plan's slot->input-position map, so every
        # occurrence of a duplicated seed id gets its count.
        from repro_torch.graph.partition import partition_edges

        plan = partition_edges(g, 4 if n_parts is None else n_parts, edge_ids=seeds)
        counts = np.zeros((len(seeds), len(names)), dtype=np.int64)
        seconds = {n: 0.0 for n in names}
        stats = executor.new_stats()
        fused: Tuple[str, ...] = ()
        per_part: List[float] = []
        for p in range(plan.n_parts):
            ids = plan.edge_ids[p][plan.valid[p]]
            rows = plan.positions[p][plan.valid[p]]
            t0 = time.perf_counter()
            part_counts, part_seconds, fused, part_stats = self._mine_compiled(
                names, ids
            )
            per_part.append(time.perf_counter() - t0)
            counts[rows] = part_counts
            for n in names:
                seconds[n] += part_seconds.get(n, 0.0)
            for k in stats:
                stats[k] += part_stats[k]
        return MiningResult(
            columns=tuple(names),
            counts=counts,
            backend=backend,
            n_seeds=len(seeds),
            seconds=seconds,
            stats=stats,
            fused=fused,
            per_part_seconds=per_part,
            partition_plan=plan,
        )

    def _mine_sharded(
        self, names: List[str], seeds: np.ndarray, n_parts: Optional[int]
    ) -> MiningResult:
        """One multi-device sharded pass (see :mod:`repro_torch.core.shard`):
        cost-balanced partitions dispatched concurrently (one dispatch
        thread per device, schedule builds overlapping device work),
        per-device resident accumulators, a device-side cross-shard
        reduction when partitions map 1:1 onto devices, and exactly ONE
        blocking host sync: the fetch of the gathered result (already
        reduced, under the collective)."""
        from repro_torch.core import shard
        from repro_torch.graph.partition import partition_edges

        self.compile()
        if self._shard_ctx is None:
            self._shard_ctx = shard.ShardContext(
                self._dg, heartbeat_dir=self.shard_heartbeat_dir
            )
        ctx = self._shard_ctx
        if n_parts is None:
            n_parts = ctx.n_devices
        plan = partition_edges(self.graph, n_parts, edge_ids=seeds)

        fused_cols = [
            (j, n) for j, n in enumerate(names) if self._canon_of[n] in self._fused.emits
        ]
        unit_sel: Tuple[int, ...] = ()
        if fused_cols:
            unit_sel = self._fused.units_for({self._canon_of[n] for _, n in fused_cols})
        compiled_keys: List[str] = []
        for n in names:
            key = self._canon_of[n]
            if key in self._compiled and key not in compiled_keys:
                compiled_keys.append(key)
                cp = self._compiled[key]
                # keep every shard's schedule resident across mines: the
                # streaming service's sizing rule for portfolio caches
                cp.schedule_cache_cap = max(
                    cp.schedule_cache_cap, schedule_cache_cap_for(plan.n_parts)
                )

        coalesce = self.shard_coalesce

        def launch(p, ids, dgr, device, st):
            outs = {}
            if fused_cols:
                outs["__fused__"] = self._fused.launch_units(
                    ids, st, unit_sel, dg=dgr, device=device, coalesce=coalesce
                )
            for key in compiled_keys:
                outs[key] = self._compiled[key].mine_async(
                    ids, dg=dgr, device=device, stats=st, coalesce=coalesce
                )
            return outs

        stats = executor.new_stats()
        t0 = time.perf_counter()
        run = shard.run_sharded(plan, launch, ctx, stats)
        wall = time.perf_counter() - t0

        counts = np.zeros((len(seeds), len(names)), dtype=np.int64)
        if run.gather_mode == "collective":
            # the device sum already reduced every shard's placed rows:
            # each output is full-length, in input order
            host = run.host_outs
            if fused_cols:
                unit_vals = np.asarray(host["__fused__"], dtype=np.int64)
                for j, n in fused_cols:
                    counts[:, j] = self._fused.assemble(self._canon_of[n], unit_vals, unit_sel)
            for j, n in enumerate(names):
                key = self._canon_of[n]
                if key in self._compiled:
                    counts[:, j] = np.asarray(host[key], dtype=np.int64)
        else:
            # host gather: scatter each shard's ragged outputs through the
            # plan's slot -> input-position map (duplicate seed ids land on
            # their own rows)
            for p in range(plan.n_parts):
                rows = plan.positions[p][plan.valid[p]]
                if len(rows) == 0:
                    continue
                out_p = run.host_outs[p]
                if fused_cols:
                    unit_vals = np.asarray(out_p["__fused__"])[: len(rows)].astype(np.int64)
                    for j, n in fused_cols:
                        counts[rows, j] = self._fused.assemble(self._canon_of[n], unit_vals, unit_sel)
                for j, n in enumerate(names):
                    key = self._canon_of[n]
                    if key in self._compiled:
                        counts[rows, j] = np.asarray(out_p[key], dtype=np.int64)
        for k in stats:
            self.stats[k] += stats[k]
        return MiningResult(
            columns=tuple(names),
            counts=counts,
            backend="sharded",
            n_seeds=len(seeds),
            # one shared device-parallel pass: every pattern reports the
            # whole mine's wall (not additive across patterns or shards)
            seconds={n: wall for n in names},
            stats=stats,
            fused=tuple(n for _, n in fused_cols),
            partition_plan=plan,
            per_shard_seconds=run.shard_walls,
            shard_stats=run.shard_stats,
            shard_devices=tuple(run.shard_devices),
            dispatch_wall_s=run.dispatch_wall_s,
            gather_mode=run.gather_mode,
            worker_liveness=run.worker_liveness,
        )

    # -- streaming ------------------------------------------------------
    def service(
        self, patterns: Optional[Sequence[PatternLike]] = None, **kwargs
    ):
        """A :class:`repro_torch.stream.DetectionService` over the
        session's portfolio: incremental ingest with per-pattern dirty
        radii derived from the same registered specs, on the session's
        device and kernel backend.  ``kwargs`` pass through
        (``thresholds=``, ``scorer=``, ``retain=``, ``pipeline=``,
        ``schedule_cache_cap=``, ...)."""
        from repro_torch.stream import DetectionService

        names = self._resolve_names(patterns)
        kwargs.setdefault("backend", self.kernel_backend)
        kwargs.setdefault("device", self.device)
        return DetectionService(
            [self._specs[n] for n in names],
            window=self.window or 0,
            **kwargs,
        )

    def streaming(self, patterns: Optional[Sequence[PatternLike]] = None):
        """Deprecated: a :class:`~repro_torch.core.streaming.StreamingMiner`
        shim over the session's portfolio.  Use :meth:`service` for the
        streaming subsystem's full surface (alerts, per-pattern dirty
        sets, eviction)."""
        import warnings

        from repro_torch.core.streaming import StreamingMiner

        warnings.warn(
            "MiningSession.streaming() is deprecated; use "
            "MiningSession.service()",
            DeprecationWarning,
            stacklevel=2,
        )
        names = self._resolve_names(patterns)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return StreamingMiner(
                [self._specs[n] for n in names],
                window=self.window or 0,
                backend=self.kernel_backend,
                device=self.device,
            )


# ----------------------------------------------------------------------
# feature-extraction entry points (successors of repro_torch.core.features)
# ----------------------------------------------------------------------
def mine_features(
    g: TemporalGraph,
    window: int,
    patterns: Sequence[PatternLike],
    backend: str = "compiled",
    seed_eids: Optional[np.ndarray] = None,
    session: Optional[MiningSession] = None,
    device=None,
) -> np.ndarray:
    """Pattern-count feature block via a (possibly caller-shared) session;
    a new session is placed on ``device`` (the CUDA card by default)."""
    if session is None:
        session = MiningSession(g, window=window, device=device)
    session.register(*patterns)
    res = session.mine(list(patterns), seeds=seed_eids, backend=backend)
    return res.as_features()


def featurize(
    g: TemporalGraph,
    window: int,
    patterns: Union[None, str, Sequence[PatternLike]] = None,
    backend: str = "compiled",
    session: Optional[MiningSession] = None,
    device=None,
) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Full feature matrix: base transaction columns + mined counts.

    `patterns` may be an explicit sequence (names / specs / builders) or a
    feature-group name (``"full"``, ``"deep"``, ``"full_deep"``, ...); a
    new session is placed on ``device`` (the CUDA card by default)."""
    from repro_torch.core.features import BASE_COLUMNS, base_features
    from repro_torch.core.patterns import feature_pattern_set

    if patterns is None:
        patterns = feature_pattern_set("full")
    elif isinstance(patterns, str):
        patterns = feature_pattern_set(patterns)
    base = base_features(g)
    if len(patterns) == 0:
        return base, BASE_COLUMNS
    if session is None:
        session = MiningSession(g, window=window, device=device)
    session.register(*patterns)
    res = session.mine(list(patterns), backend=backend)
    return np.concatenate([base, res.as_features()], axis=1), BASE_COLUMNS + res.columns
