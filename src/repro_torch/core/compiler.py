"""Domain-specific compiler: PatternSpec -> torch mining kernels (paper §6).

The port of the JAX package's ``repro.core.compiler``.  The host half is a
copy of the reference: the graph-independent front-end
(:func:`analyze_stage_graph`: validate → dependency analysis → frontier
chaining → locality/anchor-span analysis) and the graph-dependent
back-end's host work (per-bucket strategy selection bs1 / bs2 / pw, per-
level power-of-two bucketing, hub-tail sweeps, per-branch hub
decomposition, chunking, staging, and the schedule LRU with its locks).

The device half is rewritten in torch:

* :meth:`CompiledPattern._build_kernel` lowers the stage graph for one
  (strategy, bucket dims, sweep grid) combination onto
  :mod:`repro_torch.core.ops` over nested padded query shapes
  ``(B, D1, ..., Dk[, DA][, DB])``.  The hub-tail sweep grid runs as a
  Python loop INSIDE the kernel callable (counts are additive across the
  grid), so a swept bucket is still one ``kernel_calls`` entry.
* ``backend="kernel"`` (the default) routes the pairwise (``pw``) compare
  cube and the pairwise ``count_edges`` through the hand-written CUDA
  ``intersect_count`` kernel (:mod:`repro_torch.kernels.intersect_count`)
  — the counterpart of the JAX package's ``backend="pallas"``.
  ``backend="torch"`` broadcasts the cube inline in torch ops — the
  counterpart of ``"xla"``.  The JAX package defaults to ``"xla"``, so its
  main path never reaches its own Pallas kernel; the port defaults to the
  kernel so that its main path does.  Counts are identical either way.
  ``backend="kernel"`` also runs every windowed search (difference
  frontiers, ``count_edges`` and ``count_window``) as one launch of the
  hand-written ``window_search`` kernel
  (:mod:`repro_torch.kernels.window_search`), where the JAX package's
  jitted bucket programs run ``repro.core.ops``' ``fori_loop`` searches,
  and each whole bs1 / bs2 intersect step (expansion, masks, search and
  sum) as one launch of its ``intersect_step`` entry, with the intersect
  dim's hub sweep offsets inside the launch: the callable's sweep loop
  then runs the frontier dims' combos alone.  ``"torch"`` keeps the eager
  ops of :mod:`repro_torch.core.ops`.
* PyTorch runs eagerly, so there is no trace: the ``_kernels`` cache holds
  the built callables and ``jit_cache_entries`` counts the same
  launch-shape keys the JAX package counts as traces.

Execution (:mod:`repro_torch.core.executor`) stages each bucket group
with one host→device copy, launches asynchronously into a device-resident
int32 accumulator, and syncs exactly once per ``mine()``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import executor, ops
from repro_torch.kernels.intersect_count import ops as ic_ops
from repro_torch.kernels.window_search import ops as ws_ops
from repro_torch.obs import trace as obs_trace
from repro_torch.core.spec import (
    NEG_INF,
    POS_INF,
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
from repro_torch.device import resolve_device
from repro_torch.graph.csr import DeviceGraph, TemporalGraph, csr_row_offsets

__all__ = [
    "CompiledPattern",
    "compile_pattern",
    "analyze_stage_graph",
    "StageGraphIR",
    "StageNode",
    "BUCKET_LADDER",
    "BACKENDS",
]

BACKENDS = ("kernel", "torch")

BUCKET_LADDER = (4, 16, 64, 256, 1024)
BATCH_ELEM_CAP = 1 << 22  # max padded elements materialized per kernel call
INVALID = np.int32(2**31 - 1)
SEED_NAMES = ("seed.src", "seed.dst")
# cost-model constants (relative op costs, calibrated on the CPU backend;
# the ratio is what matters: one binary-search probe ≈ gather + compare)
C_SEARCH_PER_ITER = 4.0 * 5.0  # 4 lower_bounds x gather-heavy iteration
C_COMPARE = 1.0
# seeds whose best padded strategy exceeds this are decomposed into
# per-branch work items (the paper's two-phase "deep tail" post-processing):
# the level-1 frontier is expanded host-side and every branch is re-bucketed
# by its OWN degrees at every level.  Sweeping this threshold
# (EXPERIMENTS.md §Perf-mining M4) showed the bulk path's max-over-branches
# padding loses even for mildly hub-adjacent seeds: 2^11 beat 2^21 by 30x on
# scatter-gather — per-branch decomposition is the right default for ALL
# deep work, with the bulk path kept for genuinely uniform low-degree seeds
BRANCH_DECOMP_COST = float(1 << 11)


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def schedule_cache_cap_for(n_slots: int) -> int:
    """Schedule-LRU capacity for a caller that keeps ``n_slots``
    schedule keys concurrently hot (shard partitions, a streaming
    portfolio's launch profiles): one slot each plus one spare so a
    transient extra key never evicts a hot entry, floored at the
    single-plan default of 8."""
    return max(8, int(n_slots) + 1)


_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def _max(a, b):
    """Elementwise int32 max where either side may be a Python int."""
    if not isinstance(a, torch.Tensor):
        return b.clamp_min(a)
    if not isinstance(b, torch.Tensor):
        return a.clamp_min(b)
    return torch.maximum(a, b)


def _min(a, b):
    """Elementwise int32 min where either side may be a Python int."""
    if not isinstance(a, torch.Tensor):
        return b.clamp_max(a)
    if not isinstance(b, torch.Tensor):
        return a.clamp_max(b)
    return torch.minimum(a, b)


def _linear_in(ir: "StageGraphIR", name: str, target: str) -> bool:
    """Whether stage ``name``'s count is linear in stage ``target``'s: it is
    ``target``, or a product with exactly one factor that reads ``target``
    and is itself linear in it.  A sum over ``target``'s sweep offsets can
    then be taken before ``name`` instead of after."""

    def reads(n: str) -> bool:
        st = ir.nodes[n].stage
        return n == target or (st.op == "product" and any(reads(f) for f in st.factors))

    if name == target:
        return True
    st = ir.nodes[name].stage
    if st.op != "product":
        return False
    hits = [f for f in st.factors if reads(f)]
    return len(hits) == 1 and _linear_in(ir, hits[0], target)


def _kernel_pair_count(
    lead: Tuple[int, ...],
    d_a: int,
    d_b: int,
    x_ids,
    x_t,
    y_ids,
    y_t,
    a_lo,
    a_hi,
    b_lo,
    b_hi,
    ordered: bool,
):
    """Route a pairwise compare cube through the intersect_count kernel.

    The query shape ``lead = (B, W1..Wk)`` is flattened to kernel rows.
    The x (frontier) tile is broadcast to ``(rows, Da)``; ``x_t`` may be
    None (no a-side time: unordered, with the a window unbounded).  The y
    (fixed) tile is ``(B, Db)``, one row per seed, and goes to the kernel as
    it is: kernel row r reads fixed row ``r // (W1 * ... * Wk)``.  Window
    bounds must be constant along the D axes (they anchor at seed or
    frontier stage times, never at the expansion element); a Python int
    goes in by value, a bound constant along W1..Wk as one value per seed
    (no copy), and only a bound that varies along W1..Wk is broadcast to
    ``(rows,)``.
    """

    def tile(a, w):
        return a.expand(lead + (w,)).reshape(-1, w).contiguous()

    def bound(a):
        if not isinstance(a, torch.Tensor):
            return int(a)
        a = a.to(torch.int32)
        if a.dim() and a.shape[0] == lead[0] and a.numel() == lead[0]:
            return a.reshape(-1)  # one per seed: read at the fixed side's rate
        return a.expand(lead + (1,)).reshape(-1).contiguous()

    cnt = ic_ops.intersect_count(
        tile(x_ids, d_a),
        None if x_t is None else tile(x_t, d_a),
        y_ids.contiguous(),
        y_t.contiguous(),
        bound(a_lo),
        bound(a_hi),
        bound(b_lo),
        bound(b_hi),
        ordered=ordered,
    )
    return cnt.reshape(lead)


def _ladder_class(req: np.ndarray, ladder=BUCKET_LADDER) -> np.ndarray:
    """Smallest ladder entry >= req; len(ladder) means hub tail."""
    return np.searchsorted(np.asarray(ladder), req, side="left").astype(np.int32)


def _sides(opn) -> List[Neigh]:
    """All Neigh operands a for_all reads (including difference RHS)."""
    if isinstance(opn, SetExpr):
        return [opn.left, opn.right]
    return [opn]


def _expand_sides(opn) -> List[Neigh]:
    """The Neigh operands whose rows actually *produce* frontier items
    (a difference's RHS is only a membership filter)."""
    if isinstance(opn, SetExpr):
        return [opn.left, opn.right] if opn.op == "union" else [opn.left]
    return [opn]


# ----------------------------------------------------------------------
# stage-graph IR
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StageNode:
    """One node of the stage-graph IR: a stage plus its dataflow edges."""

    stage: Stage
    deps: Tuple[str, ...]  # stage names this node reads (dataflow in-edges)
    role: str  # "frontier" | "intersect" | "count" | "product"
    level: int  # frontier nesting level (1-based); 0 for seed-level stages


@dataclasses.dataclass
class StageGraphIR:
    """Analyzed stage graph: schedule, frontier chain, locality facts."""

    spec: PatternSpec
    nodes: Dict[str, StageNode]
    schedule: Tuple[Stage, ...]  # topological order
    frontiers: Tuple[Stage, ...]  # nesting order; frontier i owns axis i
    intersect: Optional[Stage]
    counts: Tuple[Stage, ...]  # non-frontier/intersect stages, scheduled
    emit: Stage
    ce_pw: Optional[Stage]  # count_edges eligible for the pairwise strategy
    node_dist: Dict[str, int]  # hop distance of every bound node (seeds = 0)
    hop_depth: int  # max hop distance any pattern node reaches
    dirty_radius: int  # ball radius for incremental dirty frontiers
    time_radius: Optional[int]  # max |t_edge - t_seed|; None = unbounded
    est: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def n_levels(self) -> int:
        return len(self.frontiers)


def _pass_dependencies(spec: PatternSpec) -> Tuple[Tuple[Stage, ...], Dict[str, Tuple[str, ...]]]:
    """Dependency-analysis pass: topological schedule + dataflow edges.

    `PatternSpec.validate()` (the validate pass) has already run in the
    spec constructor; `topo_order` raises on cyclic dataflow.
    """
    schedule = spec.topo_order()
    deps = {st.name: spec.dependencies(st) for st in schedule}
    return schedule, deps


def _pass_frontier_chain(
    spec: PatternSpec, schedule: Tuple[Stage, ...]
) -> Tuple[Tuple[Stage, ...], Optional[Stage], Tuple[Stage, ...], Optional[Stage]]:
    """Frontier-chaining pass: order for_all stages into nesting levels,
    place the intersect, and pick the pairwise-eligible count stage."""
    frontiers = tuple(st for st in schedule if st.op == "for_all")
    levels = {st.name: i + 1 for i, st in enumerate(frontiers)}

    intersects = [st for st in schedule if st.op == "intersect"]
    if len(intersects) > 1:
        raise NotImplementedError(
            "compiler lowers at most one intersect stage; chain for_all "
            "frontiers to express deeper programs"
        )
    inter = intersects[0] if intersects else None
    if inter is not None and inter.operands[1].node.name not in SEED_NAMES:
        raise NotImplementedError(
            "intersect fixed side must be a seed endpoint"
        )

    # StageT anchors on a union frontier are undefined (a union is a node
    # *set*: the representative's edge time is not canonical)
    union_names = {
        f.name
        for f in frontiers
        if isinstance(f.operand, SetExpr) and f.operand.op == "union"
    }
    if union_names:
        for st in schedule:
            for b in (
                st.window.after,
                st.window.until,
                st.window2.after,
                st.window2.until,
            ):
                if isinstance(b.anchor, StageT) and b.anchor.name in union_names:
                    raise NotImplementedError(
                        "StageT anchor on a union frontier is undefined"
                    )

    counts = tuple(
        st for st in schedule if st.op not in ("for_all", "intersect")
    )
    # a count_edges (frontier var -> fixed node) may lower pairwise, but
    # only when the pattern has no intersect competing for the fixed-row
    # expansion slot (library patterns never have both)
    ce_pw = None
    if inter is None:
        for st in counts:
            if (
                st.op == "count_edges"
                and st.edge_src.name in levels
                and st.edge_dst.name in SEED_NAMES
            ):
                ce_pw = st
                break
    return frontiers, inter, counts, ce_pw


def _pass_locality(
    schedule: Tuple[Stage, ...], frontiers: Tuple[Stage, ...]
) -> Tuple[Dict[str, int], int, int]:
    """Locality pass: hop distances, hop depth, and the dirty-ball radius.

    ``dirty_radius`` is the max over pattern *edges* of the minimum
    endpoint distance: a new graph edge can only participate in an
    instance if it coincides with a pattern edge, and that pattern edge
    has an endpoint within ``dirty_radius`` undirected hops of the seed
    endpoints — so re-mining the ball of that radius around a new edge's
    endpoints covers every affected seed.
    """
    dist = {"seed.src": 0, "seed.dst": 0}
    for f in frontiers:
        dist[f.name] = 1 + max(
            dist[s.node.name] for s in _expand_sides(f.operand)
        )
    hop = max(dist.values())
    dirty = 0
    for st in schedule:
        if st.op == "for_all":
            dirty = max(
                dirty, max(dist[s.node.name] for s in _sides(st.operand))
            )
        elif st.op == "intersect":
            # the witness node y is a real graph neighbor of BOTH sides
            # (edges a.node-y and y-b.node must exist), so its distance
            # is 1 + min of theirs; each intersect edge then contributes
            # its own min endpoint distance
            d_a, d_b = dist[st.operands[0].node.name], dist[st.operands[1].node.name]
            d_y = 1 + min(d_a, d_b)
            dirty = max(dirty, min(d_a, d_y), min(d_b, d_y))
            hop = max(hop, d_y)
        elif st.op == "count_edges":
            dirty = max(
                dirty, min(dist[st.edge_src.name], dist[st.edge_dst.name])
            )
        elif st.op == "count_window":
            d = dist[st.operand.node.name]
            dirty = max(dirty, d)
            hop = max(hop, d + 1)
    return dist, hop, dirty


def _span_of_bound(tb: TimeBound, spans: Dict[str, Optional[int]]) -> Optional[int]:
    if tb.anchor is None:
        return None  # absolute/unbounded: no seed-relative bound
    if isinstance(tb.anchor, _SeedT):
        return abs(int(tb.offset))
    s = spans.get(tb.anchor.name)
    return None if s is None else s + abs(int(tb.offset))


def _span_of_window(win: Window, spans: Dict[str, Optional[int]]) -> Optional[int]:
    a = _span_of_bound(win.after, spans)
    u = _span_of_bound(win.until, spans)
    return None if a is None or u is None else max(a, u)


def _pass_time_radius(schedule: Tuple[Stage, ...]) -> Optional[int]:
    """Temporal-locality pass: max |t_edge - t_seed| over all windows,
    propagated through StageT anchor chains.  None = unbounded (some
    pattern edge is checked over all time, e.g. a difference membership)."""
    spans: Dict[str, Optional[int]] = {}
    radius: Optional[int] = 0

    def bump(s: Optional[int]) -> None:
        nonlocal radius
        if radius is None:
            return
        radius = None if s is None else max(radius, s)

    for st in schedule:
        if st.op == "for_all":
            s = _span_of_window(st.window, spans)
            spans[st.name] = s
            bump(s)
            if isinstance(st.operand, SetExpr) and st.operand.op == "difference":
                bump(None)  # membership edges are checked over all time
        elif st.op == "intersect":
            bump(_span_of_window(st.window, spans))
            bump(_span_of_window(st.window2, spans))
        elif st.op in ("count_edges", "count_window"):
            bump(_span_of_window(st.window, spans))
    return radius


def analyze_stage_graph(spec: PatternSpec) -> StageGraphIR:
    """Run the graph-independent front-end passes: validate (already done
    by the spec constructor) → dependency analysis → frontier chaining →
    locality/anchor-span analysis.  The result is everything a backend —
    or the streaming layer — needs to know about the pattern's shape."""
    schedule, deps = _pass_dependencies(spec)
    frontiers, inter, counts, ce_pw = _pass_frontier_chain(spec, schedule)
    levels = {st.name: i + 1 for i, st in enumerate(frontiers)}
    node_dist, hop_depth, dirty_radius = _pass_locality(schedule, frontiers)
    time_radius = _pass_time_radius(schedule)
    nodes = {}
    for st in schedule:
        role = {
            "for_all": "frontier",
            "intersect": "intersect",
            "product": "product",
        }.get(st.op, "count")
        nodes[st.name] = StageNode(
            stage=st,
            deps=deps[st.name],
            role=role,
            level=levels.get(st.name, 0),
        )
    return StageGraphIR(
        spec=spec,
        nodes=nodes,
        schedule=schedule,
        frontiers=frontiers,
        intersect=inter,
        counts=counts,
        emit=spec.emit_stage,
        ce_pw=ce_pw,
        node_dist=node_dist,
        hop_depth=hop_depth,
        dirty_radius=dirty_radius,
        time_radius=time_radius,
    )


# ----------------------------------------------------------------------
# backend: per-graph strategy selection + lowering
# ----------------------------------------------------------------------
def _graph_rows(dg: DeviceGraph, direction: str):
    if direction == "out":
        return dg.out_indptr, dg.out_nbr, dg.out_t, dg.out_t_sorted
    return dg.in_indptr, dg.in_nbr, dg.in_t, dg.in_t_sorted


@dataclasses.dataclass
class _GroupSpec:
    """One (strategy, bucket-dims) group of a schedule after analysis but
    before staging: everything that determines the kernel launch shape
    plus the row selection.  The seed VALUES (src/dst/t, frontier
    expansions) are carried as source arrays and threaded into padded
    staging buffers by :meth:`CompiledPattern._stage_groups` — the
    staging half of a build, separable so shape-keyed schedule reuse can
    profile the launch shapes independently of the seed identities."""

    strat: int
    dims: Tuple[int, ...]
    sweeps: Tuple[int, ...]
    branch: bool
    per_row: int
    sel: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    st: np.ndarray
    fr: Optional[np.ndarray]
    frt: Optional[np.ndarray]
    seed_of: Optional[np.ndarray]


class CompiledPattern:
    """A pattern compiled against one graph (degree statistics feed the
    strategy/bucketing passes).

    Query-shape axis model: frontier level ``i`` owns axis ``i`` of the
    padded query shape; the intersect's frontier-side expansion owns axis
    ``k+1`` and its fixed-side expansion axis ``k+2`` (``k+1`` for bs2 /
    pairwise count_edges, which need only one extra axis).  A variable
    bound at level ``j`` broadcasts against deeper levels through size-1
    axes, so invalid slots propagate as ``-1`` sentinels and every
    primitive returns 0 for them.
    """

    def __init__(
        self,
        spec: PatternSpec,
        graph: TemporalGraph,
        ladder: Tuple[int, ...] = BUCKET_LADDER,
        force_strategy: Optional[str] = None,  # bs1 | bs2 | pw (tests)
        batch_elem_cap: int = BATCH_ELEM_CAP,
        device_graph: Optional[DeviceGraph] = None,
        vals_cache: Optional[Dict[str, np.ndarray]] = None,
        backend: str = "kernel",
        ir: Optional[StageGraphIR] = None,
        kernels_cache: Optional[Dict] = None,
        trace_keys: Optional[set] = None,
        vals_lock: Optional[threading.Lock] = None,
        schedule_cache: Optional["OrderedDict"] = None,
        schedule_cache_cap: Optional[int] = None,
        schedule_mode: str = "value",
        device=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown kernel backend {backend!r}; kernel|torch")
        if schedule_mode not in ("value", "shape"):
            raise ValueError(
                f"unknown schedule_mode {schedule_mode!r}; value|shape"
            )
        self.spec = spec
        self.g = graph
        self.backend = backend
        # a portfolio MiningSession passes one shared device mirror and one
        # shared host-side requirement cache (the entries are keyed
        # symbolically — deg_out, max_in(deg_out), ... — so they are
        # graph-level facts, valid across every pattern on the same graph).
        # Without a mirror, one is built on `device` (default: the CUDA
        # card; the CPU only when asked for).
        self.dg = (
            device_graph
            if device_graph is not None
            else graph.to_device(device=resolve_device(device))
        )
        self.device = self.dg.device
        self.ladder = tuple(ladder)
        self.batch_elem_cap = int(batch_elem_cap)
        self.n_iters = ops.n_iters_for(self.dg.max_deg)
        self.force_strategy = force_strategy
        # a streaming service re-compiles the same pattern against a fresh
        # per-tick view; it passes the (graph-independent) IR so the
        # front-end passes run once per pattern, not once per tick
        self.ir = ir if ir is not None else analyze_stage_graph(spec)
        self._frontier_by_name = {f.name: f for f in self.ir.frontiers}
        self._vals_cache: Dict[str, np.ndarray] = (
            vals_cache if vals_cache is not None else {}
        )
        # concurrency: sharded mines build schedules and dispatch launches
        # from one thread per device, so every shared mutable cache on this
        # plan is guarded.  `vals_lock` is shared across a session's plans
        # when the requirement cache is (one lock per shared dict);
        # `_sched_lock` guards the schedule LRU (builds run OUTSIDE it so
        # shards' host-side grouping overlaps); `_jit_lock` guards the
        # kernel-callable cache and the launch-shape gauge.
        self._vals_lock = vals_lock if vals_lock is not None else threading.Lock()
        self._sched_lock = threading.Lock()
        self._jit_lock = threading.Lock()
        # `kernels_cache` may outlive this instance (the streaming service
        # shares one dict per pattern across ticks): entries are keyed by
        # everything the kernel closure bakes in beyond the DeviceGraph
        # argument — n_iters (derived from the padded max degree) plus the
        # (strategy, dims, sweeps, branch) launch shape — so a tick whose
        # padded view shapes repeat reuses earlier ticks' callables.  The
        # plain per-instance cache is the `kernels_cache=None` special case
        # of the same dict.
        self._kernels: Dict[Tuple, Callable] = (
            kernels_cache if kernels_cache is not None else {}
        )
        # bucket schedules are pure in (plan, graph degree requirements,
        # seed ids): repeated mine() calls over the same seeds skip the
        # host-side numpy grouping entirely (the session keeps compiled
        # plans alive, so this cache lives next to its _vals_cache).
        # LRU-capped: schedules pin their staging buffers, so a long-lived
        # session mining ever-fresh seed sets must not accumulate them.
        # `schedule_mode` picks the cache key:
        #   "value" — (seed count, sha1 of seed values, bulk_only); hits
        #             replay the cached staging verbatim (sessions /
        #             sharded mines re-mining identical seed sets);
        #   "shape" — the pow2-padded launch profile (group strat/dims/
        #             sweeps/widths, seed count pow2-ceiled); seed VALUES
        #             are threaded as launch-time staging every call, so
        #             consecutive streaming ticks with different dirty
        #             seeds share keys (and hence launch-shape families).
        # A streaming service passes one persistent `schedule_cache` per
        # pattern so the cache survives its per-tick CompiledPattern.
        self._schedules: "OrderedDict[Tuple, object]" = (
            schedule_cache if schedule_cache is not None else OrderedDict()
        )
        self.schedule_cache_cap = (
            8 if schedule_cache_cap is None else int(schedule_cache_cap)
        )
        self.schedule_mode = schedule_mode
        # distinct (strategy, dims, sweeps, branch, batch) launch shapes —
        # the JAX package's trace keys; proves the chunk ladder keeps their
        # growth bounded (shared across ticks when the caller passes a
        # persistent set)
        self._trace_keys: set = trace_keys if trace_keys is not None else set()
        # observability: see repro_torch.core.executor.STAT_KEYS for the
        # glossary
        self.stats = executor.new_stats()

    # -- convenience re-exports from the IR ----------------------------
    @property
    def hop_depth(self) -> int:
        return self.ir.hop_depth

    @property
    def dirty_radius(self) -> int:
        return self.ir.dirty_radius

    @property
    def time_radius(self) -> Optional[int]:
        return self.ir.time_radius

    def plan_text(self) -> str:
        ir = self.ir
        lines = [f"pattern {self.spec.name}: compiled stage-graph plan"]
        for i, f in enumerate(ir.frontiers, start=1):
            lines.append(
                f"  L{i} for_all {f.name} <- {f.operand!r} "
                f"[axis {i}; buckets {self.ladder}]"
            )
        if ir.intersect is not None:
            a, b = ir.intersect.operands
            lines.append(
                f"  intersect {ir.intersect.name} <- {a!r} (X) {b!r} "
                f"[strategy per bucket: bs1|bs2|pw; est {ir.est}]"
            )
        for st in ir.counts:
            tag = " [bs|pw]" if st is ir.ce_pw else ""
            deps = ir.nodes[st.name].deps
            dep_s = f" reads({', '.join(deps)})" if deps else ""
            lines.append(f"  {st.op} {st.name}{tag}{dep_s}")
        lines.append(f"  emit {ir.emit.name}")
        lines.append(
            f"  locality: hop_depth={ir.hop_depth} "
            f"dirty_radius={ir.dirty_radius} time_radius={ir.time_radius}"
        )
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # host-side degree requirements (per-level bucketing inputs)
    # ------------------------------------------------------------------
    def _seed_node(self, ref: NodeRef, seed_eids: np.ndarray) -> np.ndarray:
        if ref.name == "seed.src":
            return self.g.src[seed_eids]
        if ref.name == "seed.dst":
            return self.g.dst[seed_eids]
        raise KeyError(ref.name)

    def _deg_vals(self, direction: str) -> Tuple[str, np.ndarray]:
        key = f"deg_{direction}"
        val = self._vals_cache.get(key)  # lock-free warm path (GIL-atomic)
        if val is None:
            with self._vals_lock:
                val = self._vals_cache.get(key)
                if val is None:
                    deg = self.g.out_deg if direction == "out" else self.g.in_deg
                    val = deg.astype(np.int64)
                    self._vals_cache[key] = val
        return key, val

    def _nbr_max(self, direction: str, key: str, vals: np.ndarray):
        """Per node: max over its direction-neighbors w of vals[w].

        The composition ``_nbr_max^(j)`` turns a leaf-level requirement
        into a per-seed requirement down a j-level frontier chain; results
        are cached by the symbolic key so chains share work."""
        ck = f"max_{direction}({key})"
        cached = self._vals_cache.get(ck)  # lock-free warm path
        if cached is not None:
            return ck, cached
        with self._vals_lock:
            cached = self._vals_cache.get(ck)
            if cached is not None:
                return ck, cached
            g = self.g
            indptr = g.out_indptr if direction == "out" else g.in_indptr
            nbr = g.out_nbr if direction == "out" else g.in_nbr
            mapped = vals[nbr].astype(np.int64)
            n = len(indptr) - 1
            if mapped.size == 0:
                res = np.zeros(n, dtype=np.int64)
            else:
                # One trailing identity element makes indptr values equal to
                # mapped.size valid reduceat starts (trailing empty rows)
                # without perturbing any real segment boundary; requirements
                # are non-negative, so a 0 sentinel never wins a max.
                padded = np.concatenate([mapped, np.zeros(1, dtype=np.int64)])
                res = np.maximum.reduceat(padded, indptr[:-1].astype(np.int64))
                res = np.where(np.diff(indptr) > 0, res, 0)
            self._vals_cache[ck] = res
            return ck, res

    def _req_seedwise(
        self, ref: NodeRef, key: str, vals: np.ndarray, seed_eids: np.ndarray
    ) -> np.ndarray:
        """Per-seed upper bound of vals[] at the node `ref` binds, maxing
        over every branch of the frontier chain that reaches it."""
        if ref.name in SEED_NAMES:
            return vals[self._seed_node(ref, seed_eids)]
        f = self._frontier_by_name[ref.name]
        res = None
        for side in _expand_sides(f.operand):
            k2, v2 = self._nbr_max(side.direction, key, vals)
            r = self._req_seedwise(side.node, k2, v2, seed_eids)
            res = r if res is None else np.maximum(res, r)
        return res

    def _req_itemwise(
        self,
        ref: NodeRef,
        key: str,
        vals: np.ndarray,
        fr: np.ndarray,
        src_b: np.ndarray,
        dst_b: np.ndarray,
    ) -> np.ndarray:
        """Per-branch-item requirement for the hub decomposition path: the
        level-1 frontier is a concrete host-expanded node, so deeper
        levels re-bucket from its ACTUAL degrees."""
        if self.ir.frontiers and ref.name == self.ir.frontiers[0].name:
            return vals[fr]
        if ref.name == "seed.src":
            return vals[src_b]
        if ref.name == "seed.dst":
            return vals[dst_b]
        f = self._frontier_by_name[ref.name]
        res = None
        for side in _expand_sides(f.operand):
            k2, v2 = self._nbr_max(side.direction, key, vals)
            r = self._req_itemwise(side.node, k2, v2, fr, src_b, dst_b)
            res = r if res is None else np.maximum(res, r)
        return res

    def _frontier_reqs(self, seed_eids: np.ndarray) -> List[np.ndarray]:
        """Per-seed width requirement of every frontier level."""
        out = []
        for f in self.ir.frontiers:
            req = None
            for side in _expand_sides(f.operand):
                k, v = self._deg_vals(side.direction)
                r = self._req_seedwise(side.node, k, v, seed_eids)
                req = r if req is None else np.maximum(req, r)
            out.append(req)
        return out

    def _intersect_reqs(self, seed_eids: np.ndarray):
        """(dA, dB): frontier-side / fixed-side expansion requirements."""
        ones = np.ones(len(seed_eids), dtype=np.int64)
        it = self.ir.intersect
        if it is not None:
            a, b = it.operands
            ka, va = self._deg_vals(a.direction)
            d_a = self._req_seedwise(a.node, ka, va, seed_eids)
            _, vb = self._deg_vals(b.direction)
            d_b = vb[self._seed_node(b.node, seed_eids)]
            return d_a, d_b
        ce = self.ir.ce_pw
        if ce is not None:
            _, vb = self._deg_vals("in")
            return ones, vb[self._seed_node(ce.edge_dst, seed_eids)]
        return ones, ones

    def _pad(self, req: np.ndarray) -> np.ndarray:
        ladder = np.asarray(self.ladder, dtype=np.int64)
        cls = np.minimum(_ladder_class(req, self.ladder), len(self.ladder) - 1)
        pad = ladder[cls]
        tail = req > ladder[-1]
        return np.where(
            tail, ((req + ladder[-1] - 1) // ladder[-1]) * ladder[-1], pad
        )

    # ------------------------------------------------------------------
    # strategy-selection pass (per-seed, per-bucket cost model)
    # ------------------------------------------------------------------
    def _pass_strategy(self, w_pads, d_a_p, d_b_p):
        """Per-seed (strategy code, cost): 0=bs1, 1=bs2, 2=pw, 3=plain."""
        cs = C_SEARCH_PER_ITER * self.n_iters
        w_prod = np.ones(d_a_p.shape, dtype=np.float64)
        for wp in w_pads:
            w_prod = w_prod * wp.astype(np.float64)
        if self.ir.intersect is not None:
            cost = np.stack(
                [
                    w_prod * d_a_p * cs,  # bs1
                    w_prod * d_b_p * cs,  # bs2
                    w_prod * d_a_p * d_b_p * C_COMPARE,  # pw
                ],
                axis=0,
            )
            self.ir.est = {
                k: float(cost[i].mean()) for i, k in enumerate(("bs1", "bs2", "pw"))
            }
            if self.force_strategy is not None:
                code = {"bs1": 0, "bs2": 1, "pw": 2}[self.force_strategy]
                out = np.full(w_prod.shape, code, dtype=np.int32)
                return out, cost[code]
            st = np.argmin(cost, axis=0).astype(np.int32)
            return st, cost.min(axis=0)
        if self.ir.ce_pw is not None:
            cost = np.stack(
                [w_prod * cs, w_prod * d_b_p * C_COMPARE], axis=0
            )
            if self.force_strategy in ("bs1", "bs2"):
                return np.zeros(w_prod.shape, dtype=np.int32), cost[0]
            if self.force_strategy == "pw":
                return np.full(w_prod.shape, 2, dtype=np.int32), cost[1]
            st = np.where(cost[1] < cost[0], 2, 0).astype(np.int32)
            return st, cost.min(axis=0)
        return np.full(w_prod.shape, 3, dtype=np.int32), w_prod

    def _branch_strategies(self, wb_pads, d_a_p, d_b_p):
        """Per-branch-item strategy for the hub decomposition path (the
        level-1 width is 1; deeper levels use re-bucketed actual widths)."""
        cs = C_SEARCH_PER_ITER * self.n_iters
        w_prod = np.ones(d_a_p.shape, dtype=np.float64)
        for wp in wb_pads:
            w_prod = w_prod * wp.astype(np.float64)
        if self.ir.intersect is not None:
            cost = np.stack(
                [
                    w_prod * d_a_p * cs,
                    w_prod * d_b_p * cs,
                    w_prod * d_a_p * d_b_p * C_COMPARE,
                ],
                axis=0,
            )
            if self.force_strategy is not None:
                code = {"bs1": 0, "bs2": 1, "pw": 2}[self.force_strategy]
                return np.full(d_a_p.shape, code, dtype=np.int32)
            return np.argmin(cost, axis=0).astype(np.int32)
        if self.ir.ce_pw is not None:
            if self.force_strategy == "pw":
                return np.full(d_a_p.shape, 2, dtype=np.int32)
            if self.force_strategy in ("bs1", "bs2"):
                return np.zeros(d_a_p.shape, dtype=np.int32)
            return np.where(
                w_prod * d_b_p * C_COMPARE < w_prod * cs, 2, 0
            ).astype(np.int32)
        return np.full(d_a_p.shape, 3, dtype=np.int32)

    # ------------------------------------------------------------------
    # lowering pass
    # ------------------------------------------------------------------
    def _rows(self, dg: DeviceGraph, direction: str):
        return _graph_rows(dg, direction)

    def _build_kernel(
        self,
        strat: int,
        dims: Tuple[int, ...],
        sweeps: Tuple[int, ...] = (),
        branch_mode: bool = False,
    ) -> Callable:
        """Lower the stage graph to one kernel callable for a fixed
        (strategy, per-level bucket widths, sweep grid) combination.

        ``dims`` is (W1..Wk, DA, DB): the padded width of every frontier
        level plus the two intersect expansions (1 when unused).
        ``sweeps`` gives the per-dim offset-sweep counts for hub tails;
        the full sweep grid runs inside the callable as a loop over
        offset combinations (counts are additive across the grid), so a
        swept bucket is ONE call instead of ``prod(sweeps)``."""
        # bind locals only: a kernels_cache may outlive this instance, and
        # a closure over `self` would pin its device graph and schedules
        ir, n_iters, backend = self.ir, self.n_iters, self.backend
        # the windowed searches: the window_search kernel's wrapper, or the
        # eager plain searches (looked up at each call, through the module)
        srch = ws_ops if backend == "kernel" else ops
        k = len(ir.frontiers)
        if not sweeps:
            sweeps = (1,) * len(dims)

        def lift(arr, lvl):
            while arr.dim() < lvl + 1:
                arr = arr[..., None]
            return arr

        def mid_lift(arr, axis_lvl):
            """Place a (B, d) expansion at query-shape axis `axis_lvl`."""
            return arr.reshape(arr.shape[0], *([1] * (axis_lvl - 1)), arr.shape[1])

        def body(dg: DeviceGraph, s, d, st_, fr, frt, offs, step_sweeps=1):
            node_env = {"seed.src": (s, 0), "seed.dst": (d, 0)}
            time_env: Dict[str, Tuple] = {}
            mask_env: Dict[str, Tuple] = {}
            count_env: Dict[str, Tuple] = {}

            def bound_at(tb: TimeBound, lvl: int):
                # a Python int for unanchored bounds (the JAX package's
                # jnp.int32 scalar); int32 tensors otherwise
                if tb.anchor is None:
                    return int(tb.offset)
                if isinstance(tb.anchor, _SeedT):
                    base = st_
                else:
                    base = time_env[tb.anchor.name][0]
                return lift(base + int(tb.offset), lvl)

            def node_at(ref: NodeRef, lvl: int):
                arr, _ = node_env[ref.name]
                return lift(arr, lvl)

            # ---- frontier chain: level i owns axis i ------------------
            start_level = 1
            if branch_mode:
                # hub decomposition: the level-1 frontier was expanded
                # host-side; each kernel row is ONE branch (width-1 axis)
                f1 = ir.frontiers[0]
                bmask = (fr >= 0)[:, None]
                node_env[f1.name] = (torch.where(bmask, fr[:, None], -1), 1)
                time_env[f1.name] = (frt[:, None], 1)
                mask_env[f1.name] = (bmask, 1)
                count_env[f1.name] = (bmask.to(torch.int32), 1)
                start_level = 2

            for lvl in range(start_level, k + 1):
                fa = ir.frontiers[lvl - 1]
                width = dims[lvl - 1]
                off = offs[lvl - 1]
                opn = fa.operand
                a1 = bound_at(fa.window.after, lvl)
                u1 = bound_at(fa.window.until, lvl)

                def expand_side(nb: Neigh, _w=width, _off=off, _lvl=lvl):
                    indptr, nbr, t, _ = _graph_rows(dg, nb.direction)
                    base, _ = node_env[nb.node.name]
                    return ops.expand(
                        indptr, (nbr, t), lift(base, _lvl - 1), _w, offset=_off
                    )

                def filt(mask, ids, ts, _fa=fa, _a1=a1, _u1=u1, _lvl=lvl):
                    m = mask & (ts > _a1) & (ts <= _u1)
                    for ref in _fa.skip_eq:
                        m = m & (ids != node_at(ref, _lvl))
                    return m

                if isinstance(opn, SetExpr) and opn.op == "union":
                    m1, i1, t1 = expand_side(opn.left)
                    m2, i2, t2 = expand_side(opn.right)
                    m1, m2 = filt(m1, i1, t1), filt(m2, i2, t2)
                    ids = torch.cat([i1, i2], dim=-1)
                    ts = torch.cat([t1, t2], dim=-1)
                    mask = torch.cat([m1, m2], dim=-1)
                    # dedup on node id (union is a node-set); filter first
                    # so each id's surviving representative is in-window
                    ids, ts, mask = ops.dedup_ids(ids, ts, mask, int(INVALID))
                elif isinstance(opn, SetExpr) and opn.op == "difference":
                    mask, ids, ts = expand_side(opn.left)
                    mask = filt(mask, ids, ts)
                    rb = opn.right
                    indptr_r, nbr_r, t_r, _ = _graph_rows(dg, rb.direction)
                    member = srch.count_id_in_window(
                        nbr_r,
                        t_r,
                        indptr_r,
                        node_at(rb.node, lvl),
                        torch.where(mask, ids, -1),
                        NEG_INF,
                        POS_INF,
                        n_iters,
                    )
                    mask = mask & (member == 0)
                else:
                    mask, ids, ts = expand_side(opn)
                    mask = filt(mask, ids, ts)
                ids = torch.where(mask, ids, -1)
                node_env[fa.name] = (ids, lvl)
                time_env[fa.name] = (ts, lvl)
                mask_env[fa.name] = (mask, lvl)
                count_env[fa.name] = (mask.to(torch.int32), lvl)

            # ---- intersect: expansions own axes k+1 / k+2 -------------
            if ir.intersect is not None:
                it = ir.intersect
                a, b = it.operands
                d_a, d_b = dims[k], dims[k + 1]
                off_a, off_b = offs[k], offs[k + 1]
                fr_ids = lift(node_env[a.node.name][0], k)
                indptr_a, nbr_a, t_a, _ = _graph_rows(dg, a.direction)
                indptr_b, nbr_b, t_b, _ = _graph_rows(dg, b.direction)
                fixed = node_env[b.node.name][0]  # (B,)
                lx = k + 1  # frontier-side expansion axis

                if backend == "kernel" and strat in (0, 1):
                    # the whole step, expansion to sum, is one window_search
                    # launch; the used intersect dim's sweep offsets run
                    # inside it where the grid is split (step_sweeps)
                    j = k + strat
                    branch = srch.intersect_step(
                        "bs1" if strat == 0 else "bs2",
                        (indptr_a, nbr_a, t_a),
                        (indptr_b, nbr_b, t_b),
                        fr_ids,
                        lift(fixed, k),
                        (bound_at(it.window.after, k), bound_at(it.window.until, k)),
                        (bound_at(it.window2.after, k), bound_at(it.window2.until, k)),
                        tuple(node_at(ref, k) for ref in it.skip_eq),
                        ordered=it.ordered,
                        d=dims[j],
                        n_sweep=step_sweeps,
                        offset=offs[j],
                        n_iters=n_iters,
                    )
                elif strat == 0:  # bs1: expand frontier rows, bsearch fixed
                    m2, x_ids, x_t = ops.expand(
                        indptr_a, (nbr_a, t_a), fr_ids, d_a, offset=off_a
                    )
                    a1 = bound_at(it.window.after, lx)
                    u1 = bound_at(it.window.until, lx)
                    a2 = bound_at(it.window2.after, lx)
                    u2 = bound_at(it.window2.until, lx)
                    m = m2 & (x_t > a1) & (x_t <= u1)
                    for ref in it.skip_eq:
                        m = m & (x_ids != node_at(ref, lx))
                    aa2 = _max(a2, x_t) if it.ordered else a2
                    cnt = srch.count_id_in_window(
                        nbr_b,
                        t_b,
                        indptr_b,
                        lift(fixed, lx),
                        torch.where(m, x_ids, -1),
                        aa2,
                        u2,
                        n_iters,
                    )
                    branch = torch.where(m, cnt, 0).sum(-1, dtype=torch.int32)
                elif strat == 1:  # bs2: expand fixed row, bsearch frontier
                    m3, y_ids, y_t = ops.expand(
                        indptr_b, (nbr_b, t_b), fixed, d_b, offset=off_b
                    )  # (B, DB) -> placed at axis k+1
                    y_ids2 = mid_lift(y_ids, lx)
                    y_t2 = mid_lift(y_t, lx)
                    a1 = bound_at(it.window.after, lx)
                    u1 = bound_at(it.window.until, lx)
                    a2 = bound_at(it.window2.after, lx)
                    u2 = bound_at(it.window2.until, lx)
                    m_y = mid_lift(m3, lx) & (y_t2 > a2) & (y_t2 <= u2)
                    for ref in it.skip_eq:
                        m_y = m_y & (y_ids2 != node_at(ref, lx))
                    uu1 = _min(u1, y_t2 - 1) if it.ordered else u1
                    cnt = srch.count_id_in_window(
                        nbr_a,
                        t_a,
                        indptr_a,
                        lift(fr_ids, lx),
                        torch.where(m_y, y_ids2, -1),
                        a1,
                        uu1,
                        n_iters,
                    )
                    branch = torch.where(m_y, cnt, 0).sum(-1, dtype=torch.int32)
                else:  # pw: expand both sides, broadcast-compare merge tile
                    m2, x_ids, x_t = ops.expand(
                        indptr_a, (nbr_a, t_a), fr_ids, d_a, offset=off_a
                    )
                    a1 = bound_at(it.window.after, lx)
                    u1 = bound_at(it.window.until, lx)
                    m_x = m2 & (x_t > a1) & (x_t <= u1)
                    for ref in it.skip_eq:
                        m_x = m_x & (x_ids != node_at(ref, lx))
                    m3, y_ids, y_t = ops.expand(
                        indptr_b, (nbr_b, t_b), fixed, d_b, offset=off_b
                    )  # (B, DB) -> axis k+2
                    if backend == "kernel":
                        # window 1 + skip_eq are folded into the x tile's
                        # -1 sentinels; window 2 rides in as the kernel's
                        # fixed-side window (constant along DB)
                        lead = (s.shape[0],) + tuple(dims[:k])
                        branch = _kernel_pair_count(
                            lead,
                            d_a,
                            d_b,
                            torch.where(m_x, x_ids, -1),
                            x_t,
                            torch.where(m3, y_ids, -1),
                            y_t,
                            _I32_MIN,
                            _I32_MAX,
                            bound_at(it.window2.after, lx),
                            bound_at(it.window2.until, lx),
                            it.ordered,
                        )
                    else:
                        yb = mid_lift(y_ids, lx + 1)
                        yt = mid_lift(y_t, lx + 1)
                        a2 = bound_at(it.window2.after, lx + 1)
                        u2 = bound_at(it.window2.until, lx + 1)
                        pair = (
                            m_x[..., None]
                            & mid_lift(m3, lx + 1)
                            & (x_ids[..., None] == yb)
                            & (yt > a2)
                            & (yt <= u2)
                        )
                        if it.ordered:
                            pair = pair & (yt > x_t[..., None])
                        branch = pair.sum(dim=(-1, -2), dtype=torch.int32)
                count_env[it.name] = (branch, k)

            # ---- count stages -----------------------------------------
            # a count evaluates at the max level among its node refs AND
            # its window anchors (a window anchored per deeper branch
            # makes the count vary per deeper assignment)
            def win_level(st: Stage) -> int:
                lvl = 0
                for b in (st.window.after, st.window.until):
                    if isinstance(b.anchor, StageT):
                        lvl = max(lvl, ir.nodes[b.anchor.name].level)
                return lvl

            for st in ir.counts:
                if st.op == "count_window":
                    nb = st.operand
                    base, lvl = node_env[nb.node.name]
                    lvl = max(lvl, win_level(st))
                    indptr, _, _, t_sorted = _graph_rows(dg, nb.direction)
                    cnt = srch.count_window(
                        t_sorted,
                        indptr,
                        lift(base, lvl),
                        bound_at(st.window.after, lvl),
                        bound_at(st.window.until, lvl),
                        n_iters,
                    )
                    count_env[st.name] = (cnt, lvl)
                elif st.op == "count_edges":
                    base, lvl_s = node_env[st.edge_src.name]
                    dst_arr, lvl_d = node_env[st.edge_dst.name]
                    lvl = max(lvl_s, lvl_d, win_level(st))
                    if st is ir.ce_pw and strat == 2:
                        # pairwise: compare frontier ids against the
                        # expanded in-row of the fixed destination
                        d_b, off_b = dims[k + 1], offs[k + 1]
                        lx = k + 1
                        indptr_i, nbr_i, t_i, _ = _graph_rows(dg, "in")
                        m3, y_ids, y_t = ops.expand(
                            indptr_i, (nbr_i, t_i), dst_arr, d_b, offset=off_b
                        )  # (B, DB) — in-neighbors of dst (= edge sources)
                        aw = bound_at(st.window.after, lx)
                        uw = bound_at(st.window.until, lx)
                        if backend == "kernel":
                            # degenerate Da=1 tile: the frontier id itself
                            # (its -1 sentinel already marks invalid slots),
                            # with no time: every slot is in the a window
                            lead = (s.shape[0],) + tuple(dims[:k])
                            cnt = _kernel_pair_count(
                                lead,
                                1,
                                d_b,
                                lift(base, lx),
                                None,
                                torch.where(m3, y_ids, -1),
                                y_t,
                                _I32_MIN,
                                _I32_MAX,
                                aw,
                                uw,
                                False,
                            )
                        else:
                            y2, yt2 = mid_lift(y_ids, lx), mid_lift(y_t, lx)
                            pair = (
                                mid_lift(m3, lx)
                                & (lift(base, lx) == y2)
                                & (yt2 > aw)
                                & (yt2 <= uw)
                            )
                            cnt = pair.sum(-1, dtype=torch.int32)
                    else:
                        indptr, nbr, t, _ = _graph_rows(dg, "out")
                        cnt = srch.count_id_in_window(
                            nbr,
                            t,
                            indptr,
                            lift(base, lvl),
                            lift(dst_arr, lvl),
                            bound_at(st.window.after, lvl),
                            bound_at(st.window.until, lvl),
                            n_iters,
                        )
                    count_env[st.name] = (cnt, lvl)
                elif st.op == "product":
                    f1_, f2_ = st.factors
                    c1, _ = count_env[f1_]
                    c2, _ = count_env[f2_]
                    if c1.dim() != 1 or c2.dim() != 1:
                        raise NotImplementedError("product of scalar counts only")
                    count_env[st.name] = (c1 * c2, 0)

            # ---- emit: multiplicative for_all semantics ---------------
            # total = emit value summed over every complete assignment of
            # all frontier variables.  Counts are already zero at invalid
            # slots of materialized axes (the -1 sentinel), so multiplying
            # by every frontier mask is idempotent there and contributes
            # the cross product over frontiers the emit never touched.
            # Sums are cast back to int32 at each step, so wraparound
            # matches the JAX package's int32 arithmetic.
            cnt, _ = count_env[ir.emit.name]
            masks = [mask_env[f.name][0] for f in ir.frontiers]
            rank = max([cnt.dim()] + [m.dim() for m in masks])
            total = lift(cnt, rank - 1)  # axes are leading-aligned: lift
            for m in masks:  # everything to a common rank before multiply
                total = total * lift(m, rank - 1).to(torch.int32)
            while total.dim() > 1:
                total = total.sum(-1, dtype=torch.int32)
            return total.to(torch.int32)

        # ---- sweep fusion: the offset grid lives INSIDE the callable --
        # counts are additive across the sweep grid, so a loop over the
        # flattened combo index turns n_sweep calls into one.  Under the
        # kernel backend a bs1 / bs2 step whose emit is linear in the
        # intersect's count takes its own dim's offsets inside one
        # intersect_step launch: the loop then runs the frontier dims'
        # combos only (each re-expands the frontier), and the grid's sum is
        # the same in int32 arithmetic
        inner = 1
        if backend == "kernel" and strat in (0, 1) and ir.intersect is not None:
            j = k + strat
            if sweeps[j] > 1 and sweeps[2 * k + 1 - j] == 1 and _linear_in(ir, ir.emit.name, ir.intersect.name):
                inner = sweeps[j]
        grid = tuple(1 if inner > 1 and j >= k else sc for j, sc in enumerate(sweeps))
        n_sweep = int(np.prod(grid))
        strides: List[int] = []
        acc = 1
        for sc in reversed(grid):
            strides.append(acc)
            acc *= sc
        strides = tuple(reversed(strides))

        def kernel(dg: DeviceGraph, s, d, st_, fr, frt):
            if n_sweep == 1:
                return body(dg, s, d, st_, fr, frt, (0,) * len(dims), inner)
            total = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
            for i in range(n_sweep):
                offs = tuple(
                    ((i // strides[j]) % grid[j]) * dims[j]
                    for j in range(len(dims))
                )
                total += body(dg, s, d, st_, fr, frt, offs, inner)
            return total

        return kernel

    def _kernel(
        self,
        strat: int,
        dims: Tuple[int, ...],
        sweeps: Tuple[int, ...],
        branch=False,
    ) -> Callable:
        key = (self.n_iters, strat, dims, sweeps, branch)
        fn = self._kernels.get(key)  # lock-free warm path
        if fn is None:
            with self._jit_lock:
                fn = self._kernels.get(key)
                if fn is None:
                    fn = self._build_kernel(strat, dims, sweeps, branch)
                    self._kernels[key] = fn
        return fn

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _union_dims(self) -> set:
        return {
            i
            for i, f in enumerate(self.ir.frontiers)
            if isinstance(f.operand, SetExpr) and f.operand.op == "union"
        }

    def _plan_buckets(
        self, n_out, sel_all, src, dst, st, fr, frt, strat, reqs, classes, branch, seed_of
    ) -> List[_GroupSpec]:
        """Group rows by (strategy, per-level bucket classes) into
        :class:`_GroupSpec`\\ s ready for staging.

        ``reqs``/``classes`` are per-dim requirement / class arrays over
        (W1..Wk, DA, DB); class -1 means the dim is unused by that row's
        strategy.  In branch mode, row results are scatter-added into
        ``out[seed_of[row]]`` by the executor.
        """
        n_levels = len(self.ir.frontiers)
        n_dims = n_levels + 2
        assert len(reqs) == n_dims and len(classes) == n_dims
        nL = len(self.ladder)
        bmax = self.ladder[-1]
        union_dims = self._union_dims()
        # Union frontiers cannot sweep (dedup is per-row), so their tail
        # rows get a one-off width.  Sub-bucket them on the geometric
        # grid bmax*2^e: the JIT cache holds one kernel per doubling
        # rather than one per distinct hub max, and a single huge union
        # row no longer sets the width for every row sharing the tail.
        classes = list(classes)
        for j in union_dims:
            c = np.asarray(classes[j])
            tail = c >= nL
            if tail.any():
                m = (reqs[j][sel_all[tail]] + bmax - 1) // bmax
                e = np.ceil(np.log2(np.maximum(m, 1))).astype(np.int32)
                c = c.copy()
                c[tail] = nL + np.maximum(e, 1)
                classes[j] = c
        keys = np.stack([strat] + list(classes), axis=1)
        uniq = np.unique(keys, axis=0)
        groups: List[_GroupSpec] = []
        for key in uniq:
            sk, kcs = int(key[0]), key[1:]
            sel = sel_all[np.all(keys == key, axis=1)]
            dims: List[int] = []
            sweeps: List[int] = []
            for j, (kc, req) in enumerate(zip(kcs, reqs)):
                if kc < 0:
                    dims.append(1)
                    sweeps.append(1)
                elif kc >= nL:
                    if j in union_dims:  # one-off geometric-grid bucket
                        dims.append(int(bmax) << (int(kc) - nL))
                        sweeps.append(1)
                    else:
                        mx = int(req[sel].max())
                        dims.append(bmax)
                        # pow2-clamp the sweep count: it is part of the
                        # kernel cache key (the grid is the callable's
                        # loop bound), so distinct hub maxima must map onto
                        # a log ladder of grids, not mint one callable each;
                        # extra offset steps past the row end are fully
                        # masked by expand() and contribute zero
                        sweeps.append(_pow2ceil(math.ceil(mx / bmax)))
                else:
                    dims.append(int(self.ladder[kc]))
                    sweeps.append(1)
            per_row = max(1, int(np.prod(dims, dtype=np.int64)))
            groups.append(
                _GroupSpec(
                    strat=sk,
                    dims=tuple(dims),
                    sweeps=tuple(sweeps),
                    branch=branch,
                    per_row=per_row,
                    sel=sel,
                    src=src,
                    dst=dst,
                    st=st,
                    fr=fr,
                    frt=frt,
                    seed_of=seed_of,
                )
            )
        return groups

    def _stage_groups(
        self,
        specs: List[_GroupSpec],
        n_out: int,
        pad_rows: bool = False,
    ) -> List[executor.BucketGroup]:
        """The staging half of a schedule build: chunk widths + padded
        host staging buffers for every analyzed group.  ``pad_rows=True``
        sizes each group's widths for its pow2-ceiled row count (the
        surplus rows scatter into the drop sentinel), making the widths
        canonical per shape profile — the launch-time half of shape-keyed
        schedule reuse."""
        groups: List[executor.BucketGroup] = []
        for gs in specs:
            widths = executor.chunk_widths(
                len(gs.sel),
                self.batch_elem_cap,
                gs.per_row,
                pad_rows_pow2=pad_rows,
            )
            staging = executor.build_staging(
                widths,
                n_out,
                gs.sel,
                gs.src,
                gs.dst,
                gs.st,
                seg_vals=(
                    gs.seed_of[gs.sel] if gs.branch else gs.sel
                ).astype(np.int32),
                fr=gs.fr if gs.branch else None,
                frt=gs.frt if gs.branch else None,
            )
            groups.append(
                executor.BucketGroup(
                    strat=gs.strat,
                    dims=gs.dims,
                    sweeps=gs.sweeps,
                    branch=gs.branch,
                    widths=widths,
                    staging=staging,
                    per_row=gs.per_row,
                    n_sweep=int(np.prod(gs.sweeps, dtype=np.int64)),
                )
            )
        return groups

    def _host_bound(self, tb: TimeBound, st: np.ndarray) -> np.ndarray:
        if tb.anchor is None:
            return np.full(st.shape, tb.offset, dtype=np.int64)
        assert isinstance(tb.anchor, _SeedT), "level-1 anchors are seed-level"
        return st.astype(np.int64) + tb.offset

    def _expand_branches(self, src, dst, st):
        """Host-side level-1 frontier expansion for hub seeds (numpy CSR
        slices)."""
        fa = self.ir.frontiers[0]
        opn = fa.operand
        g = self.g
        indptr = g.out_indptr if opn.direction == "out" else g.in_indptr
        nbr = g.out_nbr if opn.direction == "out" else g.in_nbr
        tt = g.out_t if opn.direction == "out" else g.in_t
        base = src if opn.node.name == "seed.src" else dst
        offs, lens = csr_row_offsets(indptr, base)
        item_seed = np.repeat(np.arange(len(src), dtype=np.int64), lens)
        fr = nbr[offs].astype(np.int32)
        frt = tt[offs].astype(np.int64)
        a1 = self._host_bound(fa.window.after, st)
        u1 = self._host_bound(fa.window.until, st)
        ok = (frt > a1[item_seed]) & (frt <= u1[item_seed])
        for ref in fa.skip_eq:
            vals = src if ref.name == "seed.src" else dst
            ok &= fr != vals[item_seed]
        return item_seed[ok], fr[ok], frt[ok].astype(np.int32)

    def _build_schedule(
        self,
        seed_eids: np.ndarray,
        bulk_only: bool = False,
        pad_rows: bool = False,
    ) -> executor.Schedule:
        """Host-side half of a mine: bucketing, strategy selection, hub
        decomposition, chunking, and staging — pure in (plan, graph
        degree requirements, seed ids), so the result is cached.

        ``pad_rows=True`` (shape-keyed streaming schedules) pow2-ceils
        every group's staged row count AND the output accumulator length
        (``Schedule.n_out``), so the whole launch profile — group widths
        included — is canonical per pow2 shape class; callers slice the
        fetched vector back to the real seed count.

        ``bulk_only`` (witness extraction) disables the per-branch hub
        decomposition — partial top-k payloads from decomposed branches
        cannot be scatter-merged the way partial counts can, so every
        seed must stay one row of one launch — and remaps the ``bs2``
        strategy to ``bs1``: bs2 enumerates the fixed side outermost,
        which is a different candidate order than bs1/pw (witness
        selection is order-defined; counting is order-free)."""
        g = self.g
        ir = self.ir
        n = len(seed_eids)
        groups: List[_GroupSpec] = []
        branch_items = 0

        k = len(ir.frontiers)
        w_reqs = self._frontier_reqs(seed_eids)
        d_a_req, d_b_req = self._intersect_reqs(seed_eids)
        w_pads = [self._pad(r) for r in w_reqs]
        strat, cost = self._pass_strategy(
            w_pads, self._pad(d_a_req), self._pad(d_b_req)
        )
        if bulk_only:
            strat = np.where(strat == 1, 0, strat).astype(np.int32)

        has_inter = ir.intersect is not None
        has_ce = ir.ce_pw is not None
        branch_ok = (
            k >= 1
            and isinstance(ir.frontiers[0].operand, Neigh)
            and not bulk_only
        )
        go_branch = (
            (cost > BRANCH_DECOMP_COST)
            if branch_ok
            else np.zeros(n, dtype=bool)
        )

        src = g.src[seed_eids].astype(np.int32)
        dst = g.dst[seed_eids].astype(np.int32)
        st = g.t[seed_eids].astype(np.int32)

        # ---- normal (bulk) path --------------------------------------
        norm = np.nonzero(~go_branch)[0]
        if len(norm):
            use_a = has_inter & np.isin(strat, (0, 2))
            use_b = (has_inter & np.isin(strat, (1, 2))) | (
                has_ce & (strat == 2)
            )
            cls = [_ladder_class(r, self.ladder)[norm] for r in w_reqs]
            c_a = np.where(use_a, _ladder_class(d_a_req, self.ladder), -1)
            c_b = np.where(use_b, _ladder_class(d_b_req, self.ladder), -1)
            groups += self._plan_buckets(
                n,
                norm,
                src,
                dst,
                st,
                None,
                None,
                strat[norm],
                w_reqs + [d_a_req, d_b_req],
                cls + [c_a[norm], c_b[norm]],
                branch=False,
                seed_of=None,
            )

        # ---- hub tail: per-branch decomposition, re-bucketed per level
        hub = np.nonzero(go_branch)[0]
        if len(hub):
            item_seed_l, fr, frt = self._expand_branches(
                src[hub], dst[hub], st[hub]
            )
            if len(fr):
                seed_of = hub[item_seed_l]
                src_b = src[seed_of]
                dst_b = dst[seed_of]
                branch_items = len(fr)
                ones = np.ones(len(fr), dtype=np.int64)
                # per-item requirements use ACTUAL branch degrees at every
                # level below the decomposed frontier
                wb_reqs: List[np.ndarray] = [ones]
                for f in ir.frontiers[1:]:
                    req = None
                    for side in _expand_sides(f.operand):
                        key, v = self._deg_vals(side.direction)
                        r = self._req_itemwise(
                            side.node, key, v, fr, src_b, dst_b
                        )
                        req = r if req is None else np.maximum(req, r)
                    wb_reqs.append(req)
                if has_inter:
                    a, b = ir.intersect.operands
                    ka, va = self._deg_vals(a.direction)
                    bd_a = self._req_itemwise(a.node, ka, va, fr, src_b, dst_b)
                    bd_b = d_b_req[seed_of]
                elif has_ce:
                    bd_a = ones
                    bd_b = d_b_req[seed_of]
                else:
                    bd_a = ones
                    bd_b = ones
                bstrat = self._branch_strategies(
                    [self._pad(r) for r in wb_reqs[1:]],
                    self._pad(bd_a),
                    self._pad(bd_b),
                )
                use_a = has_inter & np.isin(bstrat, (0, 2))
                use_b = (has_inter & np.isin(bstrat, (1, 2))) | (
                    has_ce & (bstrat == 2)
                )
                bcls = [np.full(len(fr), -1, dtype=np.int32)] + [
                    _ladder_class(r, self.ladder) for r in wb_reqs[1:]
                ]
                bc_a = np.where(use_a, _ladder_class(bd_a, self.ladder), -1)
                bc_b = np.where(use_b, _ladder_class(bd_b, self.ladder), -1)
                items = np.arange(len(fr))
                groups += self._plan_buckets(
                    n,
                    items,
                    src_b,
                    dst_b,
                    st[seed_of],
                    fr,
                    frt,
                    bstrat,
                    wb_reqs + [bd_a, bd_b],
                    bcls + [bc_a, bc_b],
                    branch=True,
                    seed_of=seed_of,
                )
        n_dev = _pow2ceil(max(1, n)) if pad_rows else n
        return executor.Schedule(
            groups=self._stage_groups(groups, n_dev, pad_rows=pad_rows),
            branch_items=branch_items,
            n_out=n_dev,
        )

    def _schedule_shape_keyed(
        self, seed_eids: np.ndarray, stats: Dict[str, int]
    ) -> executor.Schedule:
        """Shape-keyed schedule path (``schedule_mode="shape"``): the
        per-seed analysis and staging run EVERY call — seed values are
        launch-time data — and the cache records pow2-padded launch
        PROFILES (seed count pow2-ceiled + each group's strategy, ladder
        dims, sweep grid, and canonical chunk widths).  A hit means the
        tick's launches land entirely inside an already-traced shape
        family: ``schedule_hits`` under this mode gauges exactly the
        cross-tick reuse that keeps warm-tick ``trace_misses`` at zero.
        The LRU cap bounds the profile set a long-lived service pins."""
        with obs_trace.span(
            "schedule_build",
            pattern=self.spec.name,
            n_seeds=len(seed_eids),
            mode="shape",
        ):
            sched = self._build_schedule(seed_eids, pad_rows=True)
        key = (
            "shape",
            sched.n_out,
            tuple(
                sorted(
                    (g.strat, g.dims, g.sweeps, g.branch, tuple(g.widths))
                    for g in sched.groups
                )
            ),
        )
        with self._sched_lock:
            if key in self._schedules:
                self._schedules.move_to_end(key)
                stats["schedule_hits"] += 1
            else:
                self._schedules[key] = True
                while len(self._schedules) > self.schedule_cache_cap:
                    self._schedules.popitem(last=False)  # evict LRU
        return sched

    def schedule_for(
        self,
        seed_eids: np.ndarray,
        stats: Optional[Dict[str, int]] = None,
        bulk_only: bool = False,
    ) -> executor.Schedule:
        """The cached bucket schedule for a seed set (building it on a
        miss).  Schedules are pure in (plan, graph degree requirements,
        seed ids) and carry no device state, so one cached schedule is
        replayed by every device of a sharded mine — the host-side numpy
        grouping runs once per (plan, partition), never once per device.

        Under ``schedule_mode="shape"`` (streaming), counting schedules
        are re-keyed on the pow2-padded launch profile instead of the
        seed identity — see :meth:`_schedule_shape_keyed`.  Witness
        (``bulk_only``) schedules are value-keyed, as their packed top-k
        payloads depend on exact seed order; under ``"shape"`` they are
        built anew every call and never cached, because that cache
        outlives the tick's view and a local seed id names another edge
        in the next tick's view."""
        stats = self.stats if stats is None else stats
        if self.schedule_mode == "shape":
            if not bulk_only:
                return self._schedule_shape_keyed(seed_eids, stats)
            with obs_trace.span(
                "schedule_build",
                pattern=self.spec.name,
                n_seeds=len(seed_eids),
                bulk_only=True,
            ):
                return self._build_schedule(seed_eids, bulk_only=True)
        key = (
            len(seed_eids),
            hashlib.sha1(seed_eids.tobytes()).hexdigest(),
            bulk_only,
        )
        with self._sched_lock:
            sched = self._schedules.get(key)
            if sched is not None:
                self._schedules.move_to_end(key)
                stats["schedule_hits"] += 1
                return sched
        # build OUTSIDE the lock: sharded dispatch threads build different
        # partitions' schedules concurrently (that concurrency is the whole
        # point of overlapped dispatch); keys differ across partitions so a
        # duplicated build is rare and benign — first insert wins.
        with obs_trace.span(
            "schedule_build",
            pattern=self.spec.name,
            n_seeds=len(seed_eids),
            bulk_only=bulk_only,
        ):
            sched = self._build_schedule(seed_eids, bulk_only=bulk_only)
        with self._sched_lock:
            existing = self._schedules.get(key)
            if existing is not None:
                self._schedules.move_to_end(key)
                stats["schedule_hits"] += 1
                return existing
            self._schedules[key] = sched
            while len(self._schedules) > self.schedule_cache_cap:
                self._schedules.popitem(last=False)  # evict LRU
        return sched

    def mine_async(
        self,
        seed_eids: np.ndarray,
        *,
        dg: Optional[DeviceGraph] = None,
        device=None,
        stats: Optional[Dict[str, int]] = None,
        coalesce: int = 1,
    ) -> torch.Tensor:
        """Dispatch a whole mine WITHOUT the final host sync: returns the
        device-resident per-seed count vector (int32).

        ``dg`` overrides the plan's resident graph mirror (a streaming
        tick or a partition passes its own) while the schedule, the
        kernel callables and the requirement cache stay shared; launches
        and the result land on the mirror's device.  ``device``, when
        given, must name that device.  ``stats`` redirects counter deltas
        (default: the plan's lifetime ``self.stats``).  ``coalesce > 1``
        merges runs of equal-width chunks into up-to-``coalesce``x fatter
        launches (:func:`executor.coalesce_groups`)."""
        stats = self.stats if stats is None else stats
        dg = self.dg if dg is None else dg
        if device is not None and torch.device(device).type != dg.device.type:
            raise ValueError(
                f"device {device} differs from the graph mirror's {dg.device}"
            )
        seed_eids = np.asarray(seed_eids, dtype=np.int32)
        n = len(seed_eids)
        if n == 0:
            return torch.zeros(0, dtype=torch.int32, device=dg.device)
        sched = self.schedule_for(seed_eids, stats)
        stats["branch_items"] += sched.branch_items
        groups = (
            sched.groups
            if coalesce <= 1
            else executor.coalesce_groups(sched.groups, coalesce)
        )
        # local key set: the gauge delta must be computed per call, and a
        # concurrent caller would corrupt a before/after length snapshot of
        # the shared set.  Merge under the lock instead.
        local_keys: set = set()
        out_dev = executor.execute(
            groups,
            sched.n_out,
            self._kernel,
            dg,
            stats,
            local_keys,
            trace_tag=(self.n_iters,),
        )
        with self._jit_lock:
            new_keys = local_keys - self._trace_keys
            self._trace_keys |= new_keys
        # a delta, so redirected stats dicts shared by several plans stay
        # additive
        stats["jit_cache_entries"] += len(new_keys)
        return out_dev

    def mine(
        self, seed_eids: Optional[np.ndarray] = None, *, witnesses: int = 0
    ):
        """Mine per-seed pattern counts, device-resident end to end.

        The cached bucket schedule is replayed through
        :func:`repro_torch.core.executor.execute`: one host→device copy per
        bucket group, async launches scatter-added into a device output
        vector, and exactly ONE blocking device→host sync for the finished
        counts.

        ``witnesses=k`` switches to witness mode: the return value is a
        :class:`repro_torch.witness.Witnesses` carrying the same exact
        counts PLUS the per-seed top-k matching edge tuples, selected on
        the device over the same compare cubes
        (:mod:`repro_torch.witness.extract`) — still exactly one host
        sync, counts and packed ids fetched together.
        """
        if witnesses:
            from repro_torch.witness.extract import mine_witnesses

            return mine_witnesses(self, seed_eids, int(witnesses))
        if seed_eids is None:
            seed_eids = np.arange(self.g.n_edges, dtype=np.int32)
        seed_eids = np.asarray(seed_eids, dtype=np.int32)
        if len(seed_eids) == 0:
            return np.zeros(0, dtype=np.int64)
        out_dev = self.mine_async(seed_eids)
        # [:n] strips the pow2 accumulator pad (shape mode); no-op otherwise
        return (
            executor.fetch(out_dev, self.stats)[: len(seed_eids)].astype(np.int64)
        )

def compile_pattern(spec: PatternSpec, graph: TemporalGraph, **kw) -> CompiledPattern:
    return CompiledPattern(spec, graph, **kw)

