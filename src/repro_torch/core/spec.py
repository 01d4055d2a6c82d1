"""Multi-stage specification language for fuzzy AML patterns (paper §5).

A :class:`PatternSpec` decomposes a laundering scheme into logical
**stages**.  Every pattern is anchored at a *seed edge* ``e = (N0 -> N1, t)``
— mining computes, for every transaction edge, the number of pattern
instances that edge participates in (the GFP feature semantics).

Stage operations (paper §6 primitive list):

* ``for_all``       — enumerate a neighborhood into a stage variable
                      (structural fuzziness: *any* number of matches).
* ``intersect``     — weighted intersection count between a stage
                      variable's neighborhoods and a fixed node's
                      neighborhood (on-demand: never materialized).
* ``union`` / ``difference`` — set algebra over neighborhoods feeding a
                      ``for_all`` stage.
* ``count_edges``   — multiplicity of edges between two bound nodes
                      inside a time window (closing a cycle, etc.).
* ``count_window``  — windowed degree count of a bound node.
* ``product``       — combine two earlier count stages multiplicatively
                      (decoupled phases, e.g. the stack pattern).

Temporal fuzziness enters through :class:`TimeBound` anchors: every stage
may constrain its edges to ``(after, until]`` where each bound is an offset
from the seed time (``SEED_T``), from the *per-branch* time of an earlier
stage (``StageT``), or unbounded.  Per-branch anchors express partial
orders ("gather after its own scatter") without imposing a global edge
order — the O(n!) enumeration the paper eliminates.

Dataflow semantics: stages form a **DAG** (references may appear in any
listing order; the compiler topologically schedules them, and a cyclic
dataflow is a validation error).  ``for_all`` stages may *chain* — a
frontier can enumerate the neighborhood of an earlier frontier variable —
which is how deep typologies (5-cycles, layered peel chains) are written.
Counting is multiplicative over frontiers: the emitted value is the emit
stage's per-assignment count summed over every complete assignment of all
``for_all`` variables, so independent frontiers contribute a cross
product (the depth-k generalization of the ``product`` stage).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

__all__ = [
    "SEED_SRC",
    "SEED_DST",
    "SEED_T",
    "NodeRef",
    "StageT",
    "TimeBound",
    "Window",
    "Neigh",
    "SetExpr",
    "Stage",
    "PatternSpec",
    "NEG_INF",
    "POS_INF",
]

NEG_INF = -(1 << 30)
POS_INF = 1 << 30


@dataclasses.dataclass(frozen=True)
class NodeRef:
    """A bound node: seed endpoint or an earlier for_all stage variable."""

    name: str  # "seed.src" | "seed.dst" | stage name

    def __repr__(self):  # pragma: no cover
        return f"@{self.name}"


SEED_SRC = NodeRef("seed.src")
SEED_DST = NodeRef("seed.dst")


@dataclasses.dataclass(frozen=True)
class StageT:
    """Per-branch time anchor: the matched edge time of stage `name`."""

    name: str


class _SeedT:
    def __repr__(self):  # pragma: no cover
        return "SEED_T"


SEED_T = _SeedT()

Anchor = Union[_SeedT, StageT, None]


@dataclasses.dataclass(frozen=True)
class TimeBound:
    """`anchor + offset`; anchor None means +/- infinity."""

    anchor: Anchor
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class Window:
    """Half-open-below window: edge time in (after, until]."""

    after: TimeBound = TimeBound(None, NEG_INF)
    until: TimeBound = TimeBound(None, POS_INF)

    @staticmethod
    def around_seed(w: int) -> "Window":
        return Window(TimeBound(SEED_T, -w - 1), TimeBound(SEED_T, w))

    @staticmethod
    def after_seed(w: int) -> "Window":
        return Window(TimeBound(SEED_T, 0), TimeBound(SEED_T, w))

    @staticmethod
    def before_seed(w: int) -> "Window":
        return Window(TimeBound(SEED_T, -w - 1), TimeBound(SEED_T, -1))

    @staticmethod
    def after_stage(name: str, w_until: TimeBound) -> "Window":
        return Window(TimeBound(StageT(name), 0), w_until)


@dataclasses.dataclass(frozen=True)
class Neigh:
    """`node.out_neigh` / `node.in_neigh` operand."""

    node: NodeRef
    direction: str  # "out" | "in"

    def __post_init__(self):
        if self.direction not in ("out", "in"):
            raise ValueError(f"direction must be out/in, got {self.direction}")

    def __repr__(self):  # pragma: no cover
        return f"{self.node!r}.{self.direction}_neigh"

    # set-algebra sugar (the fluent DSL in repro_torch.api.dsl leans on these):
    # `a | b` is the union and `a - b` the difference of two neighborhoods
    def __or__(self, other: "Neigh") -> "SetExpr":
        return SetExpr("union", self, other)

    def __sub__(self, other: "Neigh") -> "SetExpr":
        return SetExpr("difference", self, other)


@dataclasses.dataclass(frozen=True)
class SetExpr:
    """Set algebra over neighborhoods: union / difference feeding for_all."""

    op: str  # "union" | "difference"
    left: Neigh
    right: Neigh


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    op: str  # for_all | intersect | count_edges | count_window | product
    # for_all: operand = Neigh or SetExpr; intersect: (Neigh-of-stage-var, Neigh-of-fixed)
    operand: Optional[Union[Neigh, SetExpr]] = None
    operands: Optional[Tuple[Neigh, Neigh]] = None
    # count_edges: src/dst refs
    edge_src: Optional[NodeRef] = None
    edge_dst: Optional[NodeRef] = None
    # node-inequality constraints ("differentiate"/skip_if): stage var != ref
    skip_eq: Tuple[NodeRef, ...] = ()
    window: Window = Window()
    # second window applied to the fixed side of an intersect
    window2: Window = Window()
    # intersect ordering: fixed-side edge must come after frontier-side edge
    ordered: bool = False
    # product: names of two count stages
    factors: Optional[Tuple[str, str]] = None
    emit: bool = False  # this stage's count is (part of) the pattern output


@dataclasses.dataclass(frozen=True)
class PatternSpec:
    name: str
    stages: Tuple[Stage, ...]

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))
        self.validate()

    # -- static validation (the compiler's *validate* pass, paper §6) -----
    #
    # Validation is order-independent: a stage may reference any other
    # stage in the DAG regardless of listing position.  What must hold:
    # the per-op operand shape, that node references resolve to a seed
    # endpoint or a for_all stage, that time anchors resolve to a for_all
    # stage (only frontiers carry per-branch times), and that the induced
    # dataflow graph is acyclic (the compiler schedules it topologically).
    def validate(self) -> None:
        seeds = {"seed.src", "seed.dst"}
        names: List[str] = []
        for st in self.stages:
            if st.name in names or st.name in seeds:
                raise ValueError(f"duplicate stage name {st.name!r}")
            names.append(st.name)
        name_set = set(names)
        forall_names = {st.name for st in self.stages if st.op == "for_all"}
        emits = 0
        for st in self.stages:
            refs: List[NodeRef] = []
            if st.op == "for_all":
                if st.operand is None:
                    raise ValueError(f"{st.name}: for_all needs operand")
                ns = (
                    [st.operand.left, st.operand.right]
                    if isinstance(st.operand, SetExpr)
                    else [st.operand]
                )
                refs += [n.node for n in ns]
                if any(n.node.name == st.name for n in ns):
                    raise ValueError(f"{st.name}: cyclic dataflow (self reference)")
            elif st.op == "intersect":
                if st.operands is None:
                    raise ValueError(f"{st.name}: intersect needs operands")
                a, b = st.operands
                refs += [a.node, b.node]
            elif st.op == "count_edges":
                if st.edge_src is None or st.edge_dst is None:
                    raise ValueError(f"{st.name}: count_edges needs edge_src/dst")
                refs += [st.edge_src, st.edge_dst]
            elif st.op == "count_window":
                if st.operand is None or not isinstance(st.operand, Neigh):
                    raise ValueError(f"{st.name}: count_window needs Neigh operand")
                refs += [st.operand.node]
            elif st.op == "product":
                if st.factors is None:
                    raise ValueError(f"{st.name}: product needs factors")
                for f in st.factors:
                    if f not in name_set:
                        raise ValueError(f"{st.name}: factor {f!r} not a stage")
            else:
                raise ValueError(f"{st.name}: unknown op {st.op!r}")
            for r in refs + list(st.skip_eq):
                if r.name not in seeds and r.name not in forall_names:
                    raise ValueError(
                        f"{st.name}: reference to unbound node {r.name!r}"
                    )
            for b in (st.window.after, st.window.until, st.window2.after, st.window2.until):
                if isinstance(b.anchor, StageT) and b.anchor.name not in forall_names:
                    raise ValueError(
                        f"{st.name}: time anchor on undefined stage {b.anchor.name!r}"
                    )
            emits += int(st.emit)
        if emits != 1:
            raise ValueError(f"pattern {self.name!r}: exactly one stage must emit")
        self.topo_order()  # raises on cyclic dataflow

    def dependencies(self, st: Stage) -> Tuple[str, ...]:
        """Stage names `st` reads (dataflow edges; seed refs excluded)."""
        deps: List[str] = []

        def add(name: str) -> None:
            if name not in ("seed.src", "seed.dst") and name not in deps:
                deps.append(name)

        refs: List[NodeRef] = list(st.skip_eq)
        if st.op == "for_all":
            ns = (
                [st.operand.left, st.operand.right]
                if isinstance(st.operand, SetExpr)
                else [st.operand]
            )
            refs += [n.node for n in ns]
        elif st.op == "intersect":
            refs += [st.operands[0].node, st.operands[1].node]
        elif st.op == "count_edges":
            refs += [st.edge_src, st.edge_dst]
        elif st.op == "count_window":
            refs += [st.operand.node]
        elif st.op == "product":
            for f in st.factors:
                add(f)
        for r in refs:
            add(r.name)
        for b in (st.window.after, st.window.until, st.window2.after, st.window2.until):
            if isinstance(b.anchor, StageT):
                add(b.anchor.name)
        return tuple(deps)

    def topo_order(self) -> Tuple[Stage, ...]:
        """Stages in dependency order (stable by listing order).

        Raises ValueError on cyclic dataflow — the *dependency analysis*
        pass of the compiler front-end.
        """
        by_name = {st.name: st for st in self.stages}
        deps = {
            st.name: tuple(d for d in self.dependencies(st) if d in by_name)
            for st in self.stages
        }
        placed: List[Stage] = []
        done: set = set()
        remaining = [st.name for st in self.stages]
        while remaining:
            ready = [n for n in remaining if all(d in done for d in deps[n])]
            if not ready:
                raise ValueError(
                    f"pattern {self.name!r}: cyclic dataflow among "
                    f"{sorted(remaining)}"
                )
            for n in ready:
                done.add(n)
                placed.append(by_name[n])
            remaining = [n for n in remaining if n not in done]
        return tuple(placed)

    @property
    def emit_stage(self) -> Stage:
        return next(s for s in self.stages if s.emit)
