"""GFP-reference: a pure-Python interpreter of PatternSpec.

Two roles (both from the paper's evaluation):

1. **Correctness oracle** — enumerates pattern instances literally, edge by
   edge, with the exact semantics the compiler must reproduce
   (`tests/test_compiler_oracle.py` asserts equality on every pattern).
2. **Speed baseline** — stands in for the "legacy python-based library"
   (GFP) the paper benchmarks against in Figs. 6-10.

It interprets the *same* spec the compiler lowers, so pattern semantics are
defined once.  The interpreter handles arbitrary stage DAGs: ``for_all``
frontiers are enumerated as a nested cross product in topological order
(chained frontiers narrow per branch; independent frontiers multiply), and
the emitted total is the emit stage's per-assignment value summed over
every complete assignment of all frontier variables — the same
multiplicative semantics the compiled kernels realize with masked
broadcasting.

3. **Witness oracle** — :meth:`GFPReference.mine_witnesses` enumerates,
   per seed, every pattern instance as a tuple of *edge ids* (one hop per
   non-union frontier level plus the emit stage's matched edges) in the
   canonical order the compiled witness kernels select their top-k from:
   frontier levels outermost (each in CSR row order — ``(nbr, t,
   arrival)`` id-sorted, ``(t, arrival)`` time-sorted; union frontiers in
   ascending node-id order with a ``-1`` placeholder hop, since a union
   is a node *set* with no canonical edge), emit expansion innermost.
   The compiled top-k must equal the first k of this enumeration exactly
   (`tests/test_witness.py`).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.spec import (
    Neigh,
    PatternSpec,
    SetExpr,
    Stage,
    StageT,
    TimeBound,
    Window,
    _SeedT,
)
from repro_torch.graph.csr import TemporalGraph

__all__ = ["GFPReference"]

# assignment environment: name -> (node id, per-branch edge time or None)
_Env = Dict[str, Tuple[int, Optional[int]]]


class GFPReference:
    def __init__(self, spec: PatternSpec, graph: TemporalGraph):
        self.spec = spec
        self.g = graph
        schedule = spec.topo_order()
        self.frontiers: List[Stage] = [
            st for st in schedule if st.op == "for_all"
        ]
        self._by_name = {st.name: st for st in spec.stages}

    # -- adjacency helpers (numpy row views; row sorted by (id, t)) -------
    def _row(self, node: int, direction: str) -> Tuple[np.ndarray, np.ndarray]:
        g = self.g
        if direction == "out":
            s, e = g.out_indptr[node], g.out_indptr[node + 1]
            return g.out_nbr[s:e], g.out_t[s:e]
        s, e = g.in_indptr[node], g.in_indptr[node + 1]
        return g.in_nbr[s:e], g.in_t[s:e]

    def _row_e(
        self, node: int, direction: str
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(nbr, t, eid) of the id-sorted adjacency row."""
        g = self.g
        if direction == "out":
            s, e = g.out_indptr[node], g.out_indptr[node + 1]
            return g.out_nbr[s:e], g.out_t[s:e], g.out_eid[s:e]
        s, e = g.in_indptr[node], g.in_indptr[node + 1]
        return g.in_nbr[s:e], g.in_t[s:e], g.in_eid[s:e]

    def _row_t(self, node: int, direction: str) -> Tuple[np.ndarray, np.ndarray]:
        """(t, eid) of the time-sorted adjacency row copy."""
        g = self.g
        if direction == "out":
            s, e = g.out_indptr[node], g.out_indptr[node + 1]
            return g.out_t_sorted[s:e], g.out_eid_t[s:e]
        s, e = g.in_indptr[node], g.in_indptr[node + 1]
        return g.in_t_sorted[s:e], g.in_eid_t[s:e]

    def mine(self, seed_eids: Optional[np.ndarray] = None) -> np.ndarray:
        g = self.g
        if seed_eids is None:
            seed_eids = np.arange(g.n_edges, dtype=np.int32)
        out = np.zeros(len(seed_eids), dtype=np.int64)
        for i, eid in enumerate(seed_eids):
            out[i] = self._mine_seed(
                int(g.src[eid]), int(g.dst[eid]), int(g.t[eid])
            )
        return out

    # -- window evaluation under an assignment ---------------------------
    def _bound(self, tb: TimeBound, env: _Env, t: int) -> int:
        if tb.anchor is None:
            return tb.offset
        if isinstance(tb.anchor, _SeedT):
            return t + tb.offset
        assert isinstance(tb.anchor, StageT)
        tw = env[tb.anchor.name][1]
        assert tw is not None, "StageT anchor on a union frontier"
        return tw + tb.offset

    def _in_win(self, win: Window, te: int, env: _Env, t: int) -> bool:
        return self._bound(win.after, env, t) < te <= self._bound(win.until, env, t)

    # -- frontier enumeration (nested cross product in topo order) -------
    def _items(
        self, st: Stage, env: _Env, t: int
    ) -> List[Tuple[int, Optional[int]]]:
        opn = st.operand
        skips = {env[r.name][0] for r in st.skip_eq}
        items: List[Tuple[int, Optional[int]]] = []
        if isinstance(opn, SetExpr) and opn.op == "union":
            seen = set()
            for nb in (opn.left, opn.right):
                ns, ts = self._row(env[nb.node.name][0], nb.direction)
                for x, te in zip(ns, ts):
                    x, te = int(x), int(te)
                    if not self._in_win(st.window, te, env, t):
                        continue
                    if x in skips or x in seen:
                        continue
                    seen.add(x)
                    items.append((x, None))
        elif isinstance(opn, SetExpr) and opn.op == "difference":
            rset = set(
                int(x)
                for x in self._row(
                    env[opn.right.node.name][0], opn.right.direction
                )[0]
            )
            ns, ts = self._row(env[opn.left.node.name][0], opn.left.direction)
            for x, te in zip(ns, ts):
                x, te = int(x), int(te)
                if not self._in_win(st.window, te, env, t):
                    continue
                if x in skips or x in rset:
                    continue
                items.append((x, te))
        else:
            ns, ts = self._row(env[opn.node.name][0], opn.direction)
            for x, te in zip(ns, ts):
                x, te = int(x), int(te)
                if not self._in_win(st.window, te, env, t):
                    continue
                if x in skips:
                    continue
                items.append((x, te))
        return items

    def _assignments(self, i: int, env: _Env, t: int) -> Iterator[_Env]:
        if i == len(self.frontiers):
            yield env
            return
        st = self.frontiers[i]
        for x, te in self._items(st, env, t):
            env2 = dict(env)
            env2[st.name] = (x, te)
            yield from self._assignments(i + 1, env2, t)

    # -- per-assignment stage evaluation ----------------------------------
    def _stage_value(self, st: Stage, env: _Env, t: int) -> int:
        if st.op == "for_all":
            return 1  # a complete assignment instantiates each frontier once
        if st.op == "intersect":
            a, b = st.operands
            w = env[a.node.name][0]
            fixed = env[b.node.name][0]
            skips = {env[r.name][0] for r in st.skip_eq}
            an, at = self._row(w, a.direction)
            bn, bt = self._row(fixed, b.direction)
            total = 0
            for x, t1 in zip(an, at):
                x, t1 = int(x), int(t1)
                if not self._in_win(st.window, t1, env, t):
                    continue
                if x in skips:
                    continue
                for y, t2 in zip(bn, bt):
                    y, t2 = int(y), int(t2)
                    if y != x:
                        continue
                    if not self._in_win(st.window2, t2, env, t):
                        continue
                    if st.ordered and not (t2 > t1):
                        continue
                    total += 1
            return total
        if st.op == "count_window":
            nb = st.operand
            _, ts = self._row(env[nb.node.name][0], nb.direction)
            return sum(1 for te in ts if self._in_win(st.window, int(te), env, t))
        if st.op == "count_edges":
            sval = env[st.edge_src.name][0]
            dval = env[st.edge_dst.name][0]
            ns, ts = self._row(sval, "out")
            return sum(
                1
                for x, te in zip(ns, ts)
                if int(x) == dval and self._in_win(st.window, int(te), env, t)
            )
        if st.op == "product":
            f1, f2 = st.factors
            return self._stage_value(
                self._by_name[f1], env, t
            ) * self._stage_value(self._by_name[f2], env, t)
        raise ValueError(st.op)  # pragma: no cover

    def _mine_seed(self, u: int, v: int, t: int) -> int:
        emit = self.spec.emit_stage
        base: _Env = {"seed.src": (u, None), "seed.dst": (v, None)}
        total = 0
        for env in self._assignments(0, base, t):
            total += self._stage_value(emit, env, t)
        return int(total)

    # ------------------------------------------------------------------
    # witness enumeration (canonical order — see module docstring §3)
    # ------------------------------------------------------------------
    def _items_w(
        self, st: Stage, env: _Env, t: int
    ) -> List[Tuple[int, Optional[int], int]]:
        """Frontier items as (node, edge time, hop edge id), in the order
        the compiled witness kernel enumerates the level: CSR row order
        for plain/difference operands, ascending node id (the dedup-sort
        order) with a -1 hop for unions."""
        opn = st.operand
        skips = {env[r.name][0] for r in st.skip_eq}
        items: List[Tuple[int, Optional[int], int]] = []
        if isinstance(opn, SetExpr) and opn.op == "union":
            seen = set()
            for nb in (opn.left, opn.right):
                ns, ts, _ = self._row_e(env[nb.node.name][0], nb.direction)
                for x, te in zip(ns, ts):
                    x, te = int(x), int(te)
                    if not self._in_win(st.window, te, env, t):
                        continue
                    if x in skips or x in seen:
                        continue
                    seen.add(x)
            items = [(x, None, -1) for x in sorted(seen)]
        elif isinstance(opn, SetExpr) and opn.op == "difference":
            rset = set(
                int(x)
                for x in self._row(
                    env[opn.right.node.name][0], opn.right.direction
                )[0]
            )
            ns, ts, es = self._row_e(env[opn.left.node.name][0], opn.left.direction)
            for x, te, ee in zip(ns, ts, es):
                x, te = int(x), int(te)
                if not self._in_win(st.window, te, env, t):
                    continue
                if x in skips or x in rset:
                    continue
                items.append((x, te, int(ee)))
        else:
            ns, ts, es = self._row_e(env[opn.node.name][0], opn.direction)
            for x, te, ee in zip(ns, ts, es):
                x, te = int(x), int(te)
                if not self._in_win(st.window, te, env, t):
                    continue
                if x in skips:
                    continue
                items.append((x, te, int(ee)))
        return items

    def _assignments_w(
        self, i: int, env: _Env, t: int, hops: Tuple[int, ...]
    ) -> Iterator[Tuple[_Env, Tuple[int, ...]]]:
        if i == len(self.frontiers):
            yield env, hops
            return
        st = self.frontiers[i]
        for x, te, ee in self._items_w(st, env, t):
            env2 = dict(env)
            env2[st.name] = (x, te)
            yield from self._assignments_w(i + 1, env2, t, hops + (ee,))

    def _emit_witnesses(
        self, st: Stage, env: _Env, t: int
    ) -> Iterator[Tuple[int, ...]]:
        """The emit stage's matched-edge tuples under one assignment, in
        the compiled enumeration order (frontier-side outer / run rank
        inner)."""
        if st.op == "for_all":
            yield ()  # the assignment itself is the instance
            return
        if st.op == "intersect":
            if not st.emit:  # pragma: no cover - guarded in extraction
                raise NotImplementedError("intersect witnesses only at emit")
            a, b = st.operands
            skips = {env[r.name][0] for r in st.skip_eq}
            an, at_, ae = self._row_e(env[a.node.name][0], a.direction)
            bn, bt, be = self._row_e(env[b.node.name][0], b.direction)
            for x, t1, e1 in zip(an, at_, ae):
                x, t1 = int(x), int(t1)
                if not self._in_win(st.window, t1, env, t):
                    continue
                if x in skips:
                    continue
                for y, t2, e2 in zip(bn, bt, be):
                    y, t2 = int(y), int(t2)
                    if y != x:
                        continue
                    if not self._in_win(st.window2, t2, env, t):
                        continue
                    if st.ordered and not (t2 > t1):
                        continue
                    yield (int(e1), int(e2))
            return
        if st.op == "count_window":
            nb = st.operand
            ts, es = self._row_t(env[nb.node.name][0], nb.direction)
            for te, ee in zip(ts, es):
                if self._in_win(st.window, int(te), env, t):
                    yield (int(ee),)
            return
        if st.op == "count_edges":
            sval = env[st.edge_src.name][0]
            dval = env[st.edge_dst.name][0]
            ns, ts, es = self._row_e(sval, "out")
            for x, te, ee in zip(ns, ts, es):
                if int(x) == dval and self._in_win(st.window, int(te), env, t):
                    yield (int(ee),)
            return
        if st.op == "product":
            f1, f2 = (self._by_name[f] for f in st.factors)
            for op_f in (f1, f2):
                if op_f.op not in ("count_window", "count_edges"):
                    raise NotImplementedError(
                        "witness product factors must be count stages"
                    )
            for w1 in self._emit_witnesses(f1, env, t):
                for w2 in self._emit_witnesses(f2, env, t):
                    yield w1 + w2
            return
        raise ValueError(st.op)  # pragma: no cover

    def mine_witnesses(
        self,
        seed_eids: Optional[np.ndarray] = None,
        k: Optional[int] = None,
    ) -> Tuple[np.ndarray, List[List[Tuple[int, ...]]]]:
        """Per-seed instance counts plus the witness edge-id tuples.

        Returns ``(counts, witnesses)``: ``counts[i]`` is the full
        instance count of seed i (identical to :meth:`mine`), and
        ``witnesses[i]`` the first ``k`` (all, when ``k`` is None) hop
        tuples in canonical enumeration order.  Every tuple has one hop
        per frontier level (``-1`` for unions) followed by the emit
        stage's matched edge ids.
        """
        g = self.g
        if seed_eids is None:
            seed_eids = np.arange(g.n_edges, dtype=np.int32)
        emit = self.spec.emit_stage
        if any(
            st.op == "intersect" and not st.emit for st in self.spec.stages
        ):
            raise NotImplementedError("witnesses: intersect must be the emit")
        counts = np.zeros(len(seed_eids), dtype=np.int64)
        wits: List[List[Tuple[int, ...]]] = []
        for i, eid in enumerate(seed_eids):
            u, v, t = int(g.src[eid]), int(g.dst[eid]), int(g.t[eid])
            base: _Env = {"seed.src": (u, None), "seed.dst": (v, None)}
            total = 0
            rows: List[Tuple[int, ...]] = []
            for env, fhops in self._assignments_w(0, base, t, ()):
                total += self._stage_value(emit, env, t)
                if k is None or len(rows) < k:
                    for ehops in self._emit_witnesses(emit, env, t):
                        rows.append(fhops + ehops)
                        if k is not None and len(rows) >= k:
                            break
            counts[i] = total
            wits.append(rows)
        return counts, wits
