"""Fluent pattern-authoring DSL (the `repro_torch.api` front-end, pillar 1).

Analysts describe a typology as a chain of stage clauses; the builder
lowers to a validated :class:`repro_torch.core.spec.PatternSpec`, so the
stage-graph IR, the compiled backend, the GFP oracle, and the streaming
radius derivation all work unchanged.  A round-trip laundering pattern:

    roundtrip3 = (
        pattern("roundtrip3")
        .for_all("w", seed.dst.out, after_seed=W, skip=[seed.src, seed.dst])
        .count_edges("close", "w", seed.src, after_stage="w")
        .emit("close")
        .build()
    )

Node helpers: ``seed.src`` / ``seed.dst`` are the anchor endpoints and
``var("w")`` an earlier ``for_all`` variable; ``.out`` / ``.in_`` turn a
node into a neighborhood operand, and ``a | b`` / ``a - b`` are the
union / difference set algebra.  Stage names given as plain strings are
accepted anywhere a node is expected.

Window sugar (every stage clause takes these keywords, lowering onto
:class:`repro_torch.core.spec.Window` anchors):

================== ====================================================
``around_seed=w``   edge time in ``[t_seed - w, t_seed + w]``
``after_seed=w``    in ``(t_seed, t_seed + w]``
``before_seed=w``   in ``[t_seed - w, t_seed)``
``after_stage=s``   after the per-branch time of frontier ``s``
``around_stage=(s, w)``  within ``w`` of frontier ``s``'s branch time
``until_seed=w``    upper bound ``t_seed + w`` (combine with after_stage)
``window=Window(...)``   escape hatch: any explicit Window
================== ====================================================

``intersect`` applies the same keywords to its frontier-side window and
the ``w2_``-prefixed variants (``w2_around_seed=...`` etc.) to the
fixed-side window.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.core.spec import (
    Neigh,
    NodeRef,
    PatternSpec,
    SEED_DST,
    SEED_SRC,
    SEED_T,
    SetExpr,
    Stage,
    StageT,
    TimeBound,
    Window,
)

__all__ = ["pattern", "PatternBuilder", "seed", "var", "NodeExpr"]


class NodeExpr:
    """A bound node in DSL position: ``.out`` / ``.in_`` make operands."""

    __slots__ = ("ref",)

    def __init__(self, ref: NodeRef):
        self.ref = ref

    @property
    def out(self) -> Neigh:
        return Neigh(self.ref, "out")

    @property
    def in_(self) -> Neigh:
        return Neigh(self.ref, "in")

    def __repr__(self):  # pragma: no cover
        return f"@{self.ref.name}"


class _Seed:
    """The seed-edge anchor: ``seed.src -> seed.dst`` at ``seed.t``."""

    src = NodeExpr(SEED_SRC)
    dst = NodeExpr(SEED_DST)

    def __repr__(self):  # pragma: no cover
        return "seed"


seed = _Seed()


def var(name: str) -> NodeExpr:
    """Reference an earlier ``for_all`` stage variable by name."""
    return NodeExpr(NodeRef(name))


NodeLike = Union[str, NodeRef, NodeExpr]
_WINDOW_KEYS = (
    "window",
    "around_seed",
    "after_seed",
    "before_seed",
    "after_stage",
    "around_stage",
    "until_seed",
)


def _as_ref(node: NodeLike) -> NodeRef:
    if isinstance(node, NodeExpr):
        return node.ref
    if isinstance(node, NodeRef):
        return node
    if isinstance(node, str):
        return NodeRef(node)
    raise TypeError(f"expected a node (str / NodeRef / seed.src / var(..)), got {node!r}")


def _as_operand(opn) -> Union[Neigh, SetExpr]:
    if isinstance(opn, (Neigh, SetExpr)):
        return opn
    if isinstance(opn, NodeExpr):
        raise TypeError(
            f"{opn!r} is a node, not a neighborhood — pick a direction "
            f"with .out or .in_"
        )
    raise TypeError(f"expected a neighborhood (node.out / node.in_ / union), got {opn!r}")


def _window_from(kw: dict, who: str) -> Window:
    """Lower window sugar keywords onto a Window (see module docstring)."""
    given = [k for k in _WINDOW_KEYS if kw.get(k) is not None]
    if "window" in given:
        if len(given) > 1:
            raise TypeError(f"{who}: window= excludes the sugar keywords")
        win = kw["window"]
        if not isinstance(win, Window):
            raise TypeError(f"{who}: window= expects a Window, got {win!r}")
        return win
    after: Optional[TimeBound] = None
    until: Optional[TimeBound] = None

    def set_bounds(a, u, key):
        nonlocal after, until
        if after is not None or until is not None:
            raise TypeError(f"{who}: {key}= conflicts with an earlier window keyword")
        after, until = a, u

    if kw.get("around_seed") is not None:
        w = int(kw["around_seed"])
        set_bounds(TimeBound(SEED_T, -w - 1), TimeBound(SEED_T, w), "around_seed")
    if kw.get("after_seed") is not None:
        w = int(kw["after_seed"])
        set_bounds(TimeBound(SEED_T, 0), TimeBound(SEED_T, w), "after_seed")
    if kw.get("before_seed") is not None:
        w = int(kw["before_seed"])
        set_bounds(TimeBound(SEED_T, -w - 1), TimeBound(SEED_T, -1), "before_seed")
    if kw.get("around_stage") is not None:
        name, w = kw["around_stage"]
        name = _as_ref(name).name
        set_bounds(
            TimeBound(StageT(name), -int(w) - 1),
            TimeBound(StageT(name), int(w)),
            "around_stage",
        )
    if kw.get("after_stage") is not None:
        if after is not None:
            raise TypeError(f"{who}: after_stage= conflicts with an earlier window keyword")
        after = TimeBound(StageT(_as_ref(kw["after_stage"]).name), 0)
    if kw.get("until_seed") is not None:
        if until is not None:
            raise TypeError(f"{who}: until_seed= conflicts with an earlier window keyword")
        until = TimeBound(SEED_T, int(kw["until_seed"]))
    return Window(
        after if after is not None else Window().after,
        until if until is not None else Window().until,
    )


def _split_windows(kw: dict, who: str) -> Tuple[Window, Window]:
    """(window, window2) from sugar kwargs; ``w2_``-prefixed keys hit the
    fixed-side window of an intersect."""
    w1 = {k: v for k, v in kw.items() if k in _WINDOW_KEYS}
    w2 = {k[3:]: v for k, v in kw.items() if k.startswith("w2_") and k[3:] in _WINDOW_KEYS}
    extra = set(kw) - set(w1) - {f"w2_{k}" for k in w2}
    if extra:
        raise TypeError(f"{who}: unknown keyword(s) {sorted(extra)}")
    return _window_from(w1, who), _window_from(w2, f"{who} (window2)")


def _skips(skip) -> Tuple[NodeRef, ...]:
    if skip is None:
        return ()
    if isinstance(skip, (str, NodeRef, NodeExpr)):
        skip = (skip,)
    return tuple(_as_ref(s) for s in skip)


class PatternBuilder:
    """Chainable builder; every clause appends one stage, ``build()``
    lowers to a validated :class:`PatternSpec`."""

    def __init__(self, name: str):
        self._name = name
        self._stages: List[Stage] = []

    # -- internals ------------------------------------------------------
    def _add(self, st: Stage) -> "PatternBuilder":
        self._stages.append(st)
        return self

    # -- stage clauses --------------------------------------------------
    def for_all(
        self,
        name: str,
        source,
        *,
        skip=None,
        emit: bool = False,
        **window_kw,
    ) -> "PatternBuilder":
        """Enumerate a neighborhood (or union/difference of two) into the
        stage variable ``name`` — structural fuzziness."""
        win, w2 = _split_windows(window_kw, f"for_all {name!r}")
        if w2 != Window():
            raise TypeError(f"for_all {name!r}: w2_* keywords are intersect-only")
        return self._add(
            Stage(
                name,
                "for_all",
                operand=_as_operand(source),
                skip_eq=_skips(skip),
                window=win,
                emit=emit,
            )
        )

    def intersect(
        self,
        name: str,
        frontier_side,
        fixed_side,
        *,
        skip=None,
        ordered: bool = False,
        emit: bool = False,
        **window_kw,
    ) -> "PatternBuilder":
        """Weighted intersection count between a stage variable's
        neighborhood and a fixed node's neighborhood (never materialized).
        ``w2_*`` window keywords constrain the fixed side; ``ordered=True``
        requires the fixed-side edge to follow the frontier-side edge."""
        win, w2 = _split_windows(window_kw, f"intersect {name!r}")
        return self._add(
            Stage(
                name,
                "intersect",
                operands=(_as_operand(frontier_side), _as_operand(fixed_side)),
                skip_eq=_skips(skip),
                window=win,
                window2=w2,
                ordered=ordered,
                emit=emit,
            )
        )

    def count_edges(
        self,
        name: str,
        src: NodeLike,
        dst: NodeLike,
        *,
        emit: bool = False,
        **window_kw,
    ) -> "PatternBuilder":
        """Multiplicity of ``src -> dst`` edges inside the window."""
        win, w2 = _split_windows(window_kw, f"count_edges {name!r}")
        if w2 != Window():
            raise TypeError(f"count_edges {name!r}: w2_* keywords are intersect-only")
        return self._add(
            Stage(
                name,
                "count_edges",
                edge_src=_as_ref(src),
                edge_dst=_as_ref(dst),
                window=win,
                emit=emit,
            )
        )

    def count_window(
        self,
        name: str,
        source,
        *,
        emit: bool = False,
        **window_kw,
    ) -> "PatternBuilder":
        """Windowed degree of a bound node."""
        win, w2 = _split_windows(window_kw, f"count_window {name!r}")
        if w2 != Window():
            raise TypeError(f"count_window {name!r}: w2_* keywords are intersect-only")
        opn = _as_operand(source)
        if not isinstance(opn, Neigh):
            raise TypeError(f"count_window {name!r}: needs a plain neighborhood")
        return self._add(
            Stage(name, "count_window", operand=opn, window=win, emit=emit)
        )

    def product(
        self, name: str, left: str, right: str, *, emit: bool = False
    ) -> "PatternBuilder":
        """Multiply two earlier count stages (decoupled phases)."""
        return self._add(
            Stage(name, "product", factors=(str(left), str(right)), emit=emit)
        )

    def emit(self, name: str) -> "PatternBuilder":
        """Mark stage ``name`` as the pattern output (alternative to the
        per-clause ``emit=True`` flag)."""
        for i, st in enumerate(self._stages):
            if st.name == name:
                self._stages[i] = dataclasses.replace(st, emit=True)
                return self
        raise KeyError(f"emit({name!r}): no such stage in pattern {self._name!r}")

    # -- lowering -------------------------------------------------------
    def build(self) -> PatternSpec:
        """Lower to a validated PatternSpec (raises on invalid dataflow)."""
        return PatternSpec(self._name, stages=tuple(self._stages))

    def __repr__(self):  # pragma: no cover
        ops = ", ".join(f"{s.op}:{s.name}" for s in self._stages)
        return f"pattern({self._name!r})[{ops}]"


def pattern(name: str) -> PatternBuilder:
    """Start a fluent pattern definition."""
    return PatternBuilder(name)
