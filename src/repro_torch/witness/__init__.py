"""`repro_torch.witness` — evidence extraction for mined pattern counts
(a copy of the JAX package's numpy-only ``repro.witness``).

BlazingAML's counting output ("cycle5 count = 3") is not something an
analyst can file a SAR on: the system exists to hand investigators the
laundering *transactions* themselves.  This subsystem extracts, per seed
edge, the top-k matching edge tuples ("witnesses") of a pattern —
device-side, reusing the compiler's bucket schedules and the
device-resident executor, with the same single-host-sync contract as a
counting mine (counts AND packed witness edge ids come back in ONE
blocking transfer).

A witness is a tuple of **hops** — one edge id per non-union frontier
level of the stage graph, followed by the emit stage's matched edges
(two for an intersect: the frontier-side and fixed-side edges; one per
count factor for ``count_window`` / ``count_edges`` / ``product``).
Union frontiers contribute a ``-1`` placeholder: a union is a node *set*
and has no canonical representative edge.

**Selection rule** (deterministic, oracle-checked): candidates enumerate
in row-major order of the padded compare cube the counting kernels
already build — frontier levels outermost, emit expansions innermost,
each level in CSR row order (``(nbr, t, arrival)`` for id-sorted rows,
``(t, arrival)`` for time-sorted rows; union levels in ascending node-id
order, the dedup-sort order).  The top-k witnesses are the FIRST k in
that order; arrival order breaks timestamp ties for free because the CSR
build sorts stably by arrival.  Hub-tail sweep offsets are merged by
per-axis global-coordinate sort keys, so the rule is independent of
bucketing, chunking, and sweep decomposition.  :mod:`repro_torch.core.oracle`
enumerates the same order in pure Python (`GFPReference.mine_witnesses`);
`tests/test_witness.py` asserts ``compiled top-k == oracle[:k]`` per seed
over the whole pattern library.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np

from repro_torch.core.compiler import StageGraphIR
from repro_torch.core.spec import SetExpr, Stage

__all__ = ["HopSpec", "Witnesses", "witness_layout"]


@dataclasses.dataclass(frozen=True)
class HopSpec:
    """One position of a witness tuple: which stage the hop's edge comes
    from, and which row order (id-/time-sorted) addressed it."""

    name: str  # stage name (".x"/".y" suffix for the intersect sides)
    kind: str  # "frontier" | "union" | "edge"
    direction: str  # "out" | "in" ("" for union placeholders)
    sorted_by: str  # "id" | "time" ("" for union placeholders)


def _emit_hops(ir: StageGraphIR, st: Stage) -> List[HopSpec]:
    if st.op == "for_all":
        return []  # a complete assignment IS the instance; no extra edge
    if st.op == "intersect":
        a, b = st.operands
        return [
            HopSpec(st.name + ".x", "edge", a.direction, "id"),
            HopSpec(st.name + ".y", "edge", b.direction, "id"),
        ]
    if st.op == "count_window":
        return [HopSpec(st.name, "edge", st.operand.direction, "time")]
    if st.op == "count_edges":
        return [HopSpec(st.name, "edge", "out", "id")]
    if st.op == "product":
        out: List[HopSpec] = []
        for fname in st.factors:
            f = ir.nodes[fname].stage
            if f.op not in ("count_window", "count_edges"):
                raise NotImplementedError(
                    "witnesses: product factors must be count stages"
                )
            out += _emit_hops(ir, f)
        return out
    raise NotImplementedError(f"witnesses: emit op {st.op!r}")


def witness_layout(ir: StageGraphIR) -> Tuple[HopSpec, ...]:
    """The hop tuple layout of a pattern's witnesses (raises
    NotImplementedError for the stage shapes witness mode excludes: an
    intersect that is not the emit, product factors that are not count
    stages — no library pattern hits either)."""
    if ir.intersect is not None and ir.intersect is not ir.emit:
        raise NotImplementedError(
            "witnesses: intersect must be the emit stage"
        )
    hops: List[HopSpec] = []
    for f in ir.frontiers:
        opn = f.operand
        if isinstance(opn, SetExpr) and opn.op == "union":
            hops.append(HopSpec(f.name, "union", "", ""))
        elif isinstance(opn, SetExpr):  # difference: left side produces
            hops.append(HopSpec(f.name, "frontier", opn.left.direction, "id"))
        else:
            hops.append(HopSpec(f.name, "frontier", opn.direction, "id"))
    return tuple(hops + _emit_hops(ir, ir.emit))


@dataclasses.dataclass
class Witnesses:
    """Per-seed witness extraction result.

    ``eids[i, j]`` is the j-th witness hop tuple of seed i (global edge
    ids under the mined graph's numbering; ``-1`` marks a union
    placeholder hop or a row past ``n_found[i]``).  ``counts`` carries
    the FULL per-seed instance count (identical to a counting mine) —
    ``n_found = min(count, k)`` rows of ``eids`` are populated.
    """

    pattern: str
    hops: Tuple[HopSpec, ...]
    k: int
    counts: np.ndarray  # (n,) int64
    n_found: np.ndarray  # (n,) int32
    eids: np.ndarray  # (n, k, n_hops) int64

    @property
    def n_hops(self) -> int:
        return len(self.hops)

    def tuples(self, i: int) -> List[Tuple[int, ...]]:
        """Witness hop tuples of seed i (only the populated rows)."""
        return [
            tuple(int(e) for e in self.eids[i, j])
            for j in range(int(self.n_found[i]))
        ]

    def translate(self, edge_ids: np.ndarray) -> "Witnesses":
        """Map local edge ids through ``edge_ids`` (local -> global, as in
        :class:`repro_torch.stream.store.GraphView`); ``-1`` hops pass through."""
        edge_ids = np.asarray(edge_ids, dtype=np.int64)
        out = np.full(self.eids.shape, -1, dtype=np.int64)
        m = self.eids >= 0
        out[m] = edge_ids[self.eids[m]]
        return dataclasses.replace(self, eids=out)

    def resolve(self, fields: Callable) -> List[List[List[dict]]]:
        """Resolve hop edge ids into transaction rows.

        ``fields`` maps a 1-D int64 eid array to ``(src, dst, t, amount)``
        arrays — pass ``TemporalGraphStore.edge_fields`` for streaming
        global ids, or a lambda over ``TemporalGraph`` columns for batch
        graphs.  Returns, per seed, a list of witnesses, each a list of
        hop dicts ``{stage, eid, src, dst, t, amount}`` (union placeholder
        hops resolve to ``eid=-1`` with no endpoint fields).
        """
        flat = self.eids.reshape(-1)
        m = flat >= 0
        src = np.full(flat.shape, -1, dtype=np.int64)
        dst = np.full(flat.shape, -1, dtype=np.int64)
        tt = np.zeros(flat.shape, dtype=np.int64)
        amt = np.zeros(flat.shape, dtype=np.float64)
        if m.any():
            s, d, t_, a = fields(flat[m])
            src[m], dst[m], tt[m], amt[m] = s, d, t_, a
        n, k, h = self.eids.shape
        src, dst, tt, amt = (
            x.reshape(n, k, h) for x in (src, dst, tt, amt)
        )
        out: List[List[List[dict]]] = []
        for i in range(n):
            rows: List[List[dict]] = []
            for j in range(int(self.n_found[i])):
                hops: List[dict] = []
                for p, spec in enumerate(self.hops):
                    e = int(self.eids[i, j, p])
                    if e < 0:
                        hops.append({"stage": spec.name, "eid": -1})
                        continue
                    hops.append(
                        {
                            "stage": spec.name,
                            "eid": e,
                            "src": int(src[i, j, p]),
                            "dst": int(dst[i, j, p]),
                            "t": int(tt[i, j, p]),
                            "amount": float(amt[i, j, p]),
                        }
                    )
                rows.append(hops)
            out.append(rows)
        return out
