"""Pattern library (paper Fig. 2/4/5): AML typologies in the fluent DSL.

Every pattern is anchored at a seed edge ``e = (u -> v, t)`` and counts the
pattern instances that edge participates in, within time window ``W``.
Temporal-fuzzy variants coexist with strict-order ones — same stages,
different window anchors — which is precisely the paper's point: no
re-implementation, only re-specification.

The builders below are written in the :mod:`repro_torch.api.dsl` fluent
authoring layer and lower to exactly the same validated
:class:`~repro_torch.core.spec.PatternSpec` dataclasses the compiler, oracle,
and streaming layers consume (`tests/test_api_dsl.py` asserts dataclass
equality against hand-assembled specs) — the library doubles as the DSL's
documentation.
"""
from __future__ import annotations

from repro_torch.api.dsl import pattern, seed, var
from repro_torch.core.spec import PatternSpec

__all__ = ["build_pattern", "PATTERN_NAMES", "feature_pattern_set"]


def fan_in(w: int) -> PatternSpec:
    """In-edges of the receiver inside the window (smurfing placement)."""
    return (
        pattern("fan_in")
        .count_window("cnt", seed.dst.in_, around_seed=w, emit=True)
        .build()
    )


def fan_out(w: int) -> PatternSpec:
    return (
        pattern("fan_out")
        .count_window("cnt", seed.src.out, around_seed=w, emit=True)
        .build()
    )


def deg_in(w: int) -> PatternSpec:
    """Windowed in-degree of the *sender* (funds previously received)."""
    return (
        pattern("deg_in")
        .count_window("cnt", seed.src.in_, around_seed=w, emit=True)
        .build()
    )


def deg_out(w: int) -> PatternSpec:
    """Windowed out-degree of the *receiver* (funds moving on)."""
    return (
        pattern("deg_out")
        .count_window("cnt", seed.dst.out, around_seed=w, emit=True)
        .build()
    )


def cycle2(w: int) -> PatternSpec:
    """Round-trip: v sends back to u after the seed, within W."""
    return (
        pattern("cycle2")
        .count_edges("close", seed.dst, seed.src, after_seed=w, emit=True)
        .build()
    )


def cycle3(w: int) -> PatternSpec:
    """u->v->w->u with strictly increasing times inside (t, t+W]."""
    return (
        pattern("cycle3")
        .for_all("w", seed.dst.out, skip=[seed.src, seed.dst], after_seed=w)
        .count_edges("close", "w", seed.src, after_stage="w", until_seed=w)
        .emit("close")
        .build()
    )


def cycle3_fuzzy(w: int) -> PatternSpec:
    """Temporal fuzziness: edges may appear in ANY order inside [t-W, t+W]
    (camouflage/anticipatory edges) — same stages, looser anchors."""
    return (
        pattern("cycle3_fuzzy")
        .for_all("w", seed.dst.out, skip=[seed.src, seed.dst], around_seed=w)
        .count_edges("close", "w", seed.src, around_seed=w, emit=True)
        .build()
    )


def cycle4(w: int) -> PatternSpec:
    """u->v->w->x->u, ordered, all inside (t, t+W]."""
    return (
        pattern("cycle4")
        .for_all("w", seed.dst.out, skip=[seed.src, seed.dst], after_seed=w)
        .intersect(
            "close",
            var("w").out,
            seed.src.in_,
            skip=[seed.src, seed.dst, "w"],
            after_stage="w",
            until_seed=w,
            w2_after_seed=w,
            ordered=True,
            emit=True,
        )
        .build()
    )


def cycle5(w: int) -> PatternSpec:
    """u->v->w->x->y->u, ordered, all inside (t, t+W] — a chained
    two-frontier program (w, x) closed by an intersect; the depth the
    fixed-shape compiler could not express."""
    return (
        pattern("cycle5")
        .for_all("w", seed.dst.out, skip=[seed.src, seed.dst], after_seed=w)
        .for_all(
            "x",
            var("w").out,
            skip=[seed.src, seed.dst, "w"],
            after_stage="w",
            until_seed=w,
        )
        .intersect(
            "close",
            var("x").out,
            seed.src.in_,
            skip=[seed.src, seed.dst, "w", "x"],
            after_stage="x",
            until_seed=w,
            w2_after_seed=w,
            ordered=True,
            emit=True,
        )
        .build()
    )


def peel_chain(w: int) -> PatternSpec:
    """Layered peeling: funds forwarded hop by hop, u->v->m1->m2->(moves
    on), each leg after its own predecessor and all inside (t, t+W].  Two
    chained frontiers plus a leaf-level windowed-degree count — a depth-3
    pattern (the onward edge is three hops past the seed receiver)."""
    return (
        pattern("peel_chain")
        .for_all("m1", seed.dst.out, skip=[seed.src, seed.dst], after_seed=w)
        .for_all(
            "m2",
            var("m1").out,
            skip=[seed.src, seed.dst, "m1"],
            after_stage="m1",
            until_seed=w,
        )
        .count_window(
            "fwd", var("m2").out, after_stage="m2", until_seed=w, emit=True
        )
        .build()
    )


def fan_in_chain(w: int) -> PatternSpec:
    """Placement sandwich: many sources scatter into u before the seed
    (s), u forwards to v (the seed edge), and v scatters onward after it
    (d).  Two *independent* frontiers — the emitted count is their cross
    product, the multiplicative for_all semantics."""
    return (
        pattern("fan_in_chain")
        .for_all("s", seed.src.in_, skip=[seed.dst], before_seed=w)
        .for_all("d", seed.dst.out, skip=[seed.src], after_seed=w, emit=True)
        .build()
    )


def scatter_gather(w: int) -> PatternSpec:
    """Seed edge = one gather leg (mid u -> sink v).  Stage s finds scatter
    sources; the intersect counts sibling mid chains s->x->v whose gather
    follows its own scatter (per-branch partial order, decoupled phases)."""
    return (
        pattern("scatter_gather")
        .for_all("s", seed.src.in_, skip=[seed.dst], before_seed=w)
        .intersect(
            "sg",
            var("s").out,
            seed.dst.in_,
            skip=[seed.src, seed.dst, "s"],
            around_stage=("s", w),
            w2_around_seed=w,
            ordered=True,
            emit=True,
        )
        .build()
    )


def stack(w: int) -> PatternSpec:
    """Stacked bipartite layering: #(a->u before t) x #(v->d after t)."""
    return (
        pattern("stack")
        .count_window("up", seed.src.in_, before_seed=w)
        .count_window("down", seed.dst.out, after_seed=w)
        .product("stk", "up", "down", emit=True)
        .build()
    )


def reciprocal(w: int) -> PatternSpec:
    """Accounts trading in both directions with u (union/difference demo of
    set algebra is in `counterparty`); uses a pseudo-frontier intersect."""
    return (
        pattern("reciprocal")
        .intersect(
            "rc",
            seed.src.out,
            seed.src.in_,
            skip=[seed.src, seed.dst],
            around_seed=w,
            w2_around_seed=w,
            emit=True,
        )
        .build()
    )


def counterparty(w: int) -> PatternSpec:
    """#distinct counterparties of u in the window (union set algebra)."""
    return (
        pattern("counterparty")
        .for_all(
            "cp",
            seed.src.out | seed.src.in_,
            skip=[seed.src],
            around_seed=w,
            emit=True,
        )
        .build()
    )


def new_counterparty(w: int) -> PatternSpec:
    """Receivers u pays that never paid u back (difference set algebra)."""
    return (
        pattern("new_counterparty")
        .for_all(
            "nc",
            seed.src.out - seed.src.in_,
            skip=[seed.src],
            around_seed=w,
            emit=True,
        )
        .build()
    )


_BUILDERS = {
    "fan_in": fan_in,
    "fan_out": fan_out,
    "deg_in": deg_in,
    "deg_out": deg_out,
    "cycle2": cycle2,
    "cycle3": cycle3,
    "cycle3_fuzzy": cycle3_fuzzy,
    "cycle4": cycle4,
    "cycle5": cycle5,
    "peel_chain": peel_chain,
    "fan_in_chain": fan_in_chain,
    "scatter_gather": scatter_gather,
    "stack": stack,
    "reciprocal": reciprocal,
    "counterparty": counterparty,
    "new_counterparty": new_counterparty,
}

PATTERN_NAMES = tuple(_BUILDERS)


def build_pattern(name: str, window: int) -> PatternSpec:
    if name not in _BUILDERS:
        raise KeyError(f"unknown pattern {name!r}; options: {PATTERN_NAMES}")
    return _BUILDERS[name](window)


def feature_pattern_set(kind: str = "full") -> tuple:
    """Feature groups matching the paper's Table 2 columns, plus the
    depth-3+ typologies the stage-graph IR unlocked ("deep")."""
    groups = {
        "fan": ("fan_in", "fan_out"),
        "degree": ("deg_in", "deg_out"),
        "cycle": ("cycle2", "cycle3", "cycle4"),
        "sg": ("scatter_gather", "stack"),
        "deep": ("cycle5", "peel_chain", "fan_in_chain"),
    }
    if kind == "full":
        return groups["fan"] + groups["degree"] + groups["cycle"] + groups["sg"]
    if kind == "full_deep":
        return feature_pattern_set("full") + groups["deep"]
    return groups[kind]
