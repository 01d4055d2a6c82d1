"""Device-side witness extraction over the compiled bucket schedules, in
torch (the port of the JAX package's ``repro.witness.extract``).

This is the lowering half of :mod:`repro_torch.witness`: a second kernel
family next to the counting kernels, built over the SAME padded compare
cubes.  Where a counting kernel reduces the cube to a per-seed scalar,
the witness kernel keeps the cube's *flat candidate order* and selects
the first ``k`` matching candidates per seed:

1. broadcast the emit count cube against every frontier mask to the full
   query shape ``(B, A1..Ak, DA, DB)`` and flatten to ``(B, C)``;
2. an int32 ``cumsum`` along the candidate axis — candidate ranks are
   now a prefix-sum coordinate system;
3. for ranks ``0..k-1``, a batched right-sided ``torch.searchsorted``
   finds the cube slot holding that rank, and ``within = rank - prefix``
   indexes *inside* the slot's count (counting primitives never
   materialize their runs: the j-th matched edge of a run that starts at
   flat row position ``p`` sits at ``p + j`` — see the ``*_pos``
   variants in :mod:`repro_torch.core.ops`; on the card they run as the
   ``window_search`` kernel, :mod:`repro_torch.kernels.window_search`);
4. flat row positions become edge ids through the row-order eid arrays
   (``out_eid``/``in_eid`` for id-sorted rows, ``out_eid_t``/``in_eid_t``
   for time-sorted rows) carried by
   :class:`repro_torch.graph.csr.DeviceGraph`.

Each hop plane is read at the selected slots through the per-axis cube
coordinates of the slot (the same coordinates the sort keys carry),
indexed into the plane's own shape, so no plane is broadcast to the full
``(B, C)`` cube.

Hub-tail sweep grids stay fused in the callable: each offset
combination's top-k candidates carry per-axis GLOBAL coordinates (slot
index plus sweep offset) as sort keys, and a loop over the combinations
merges them with a lexicographic sort (stable ``torch.sort`` passes from
the last key to the first) — so the selection order is independent of
the sweep decomposition, and a swept bucket is still ONE kernel call.

Witness schedules are **bulk-only** (``schedule_for(..., bulk_only=True)``):
the per-branch hub decomposition scatter-adds partial counts from many
rows into one seed, which cannot merge packed top-k payloads; bulk-only
schedules keep every seed in exactly one row of one launch, so the
scatter-set of the packed ids is race-free.  For the same reason the
``bs2`` strategy is remapped to ``bs1`` (bs2 enumerates the fixed side
outermost — a different candidate order), and the pairwise compare cube
always takes the broadcast path on both kernel backends, as in the JAX
package (the ``intersect_count`` kernel returns reduced counts, not
positions).

Execution mirrors :func:`repro_torch.core.executor.execute` with TWO
device accumulators — per-seed counts (masked ``index_add_``) and packed
``(n, kp, H)`` witness ids (scatter-set, pad rows sent to a spare row) —
held in one int32 buffer, so the mine's single host sync fetches both in
one :func:`repro_torch.device.to_host` copy.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import executor, ops
from repro_torch.core.compiler import _I32_MAX, INVALID, _graph_rows, _max
from repro_torch.core.spec import NEG_INF, POS_INF, Neigh, NodeRef, SetExpr, Stage, StageT, TimeBound, _SeedT
from repro_torch.device import h2d, to_host
from repro_torch.graph.csr import DeviceGraph
from repro_torch.kernels.window_search import ops as ws_ops
from repro_torch.witness import Witnesses, witness_layout

__all__ = ["mine_witnesses"]


def _build_witness_kernel(
    ir, n_iters: int, strat: int, dims: Tuple[int, ...], sweeps: Tuple[int, ...], kp: int
) -> Callable:
    """Lower the stage graph to one top-k witness callable for a fixed
    (strategy, bucket widths, sweep grid, k-capacity) combination.

    Returns ``kernel(dg, s, d, st_, fr, frt) -> (counts (B,), eids
    (B, kp, H))`` — counts are the exact per-row instance counts (same
    reduction as the counting kernel), eids the first ``kp`` candidate
    hop tuples in canonical cube order (``-1`` past the count and at
    union placeholder hops), both int32.  Binds only plain values (never
    a plan): the kernels cache outlives the compiled plan.
    """
    layout = witness_layout(ir)  # raises NotImplementedError for excluded shapes
    H = len(layout)
    k = len(ir.frontiers)
    if not sweeps:
        sweeps = (1,) * len(dims)
    if strat == 1:
        raise AssertionError("witness schedules remap bs2 to bs1")
    n_axes = len(dims)  # k + 2: frontier levels + both intersect expansions
    # actual cube axis sizes: a union frontier concatenates both sides
    # before dedup, so its axis is twice the scheduled bucket width
    union_lvls = {
        i + 1
        for i, f in enumerate(ir.frontiers)
        if isinstance(f.operand, SetExpr) and f.operand.op == "union"
    }
    adims = tuple(
        (2 * w if (j + 1) in union_lvls else w) for j, w in enumerate(dims)
    )
    C = int(np.prod(adims, dtype=np.int64))
    # row-major strides of the flat cube, one per axis
    cstrides = tuple(
        int(np.prod(adims[j + 1 :], dtype=np.int64)) for j in range(n_axes)
    )

    def lift(arr, lvl):
        while arr.dim() < lvl + 1:
            arr = arr[..., None]
        return arr

    def mid_lift(arr, axis_lvl):
        return arr.reshape(arr.shape[0], *([1] * (axis_lvl - 1)), arr.shape[1])

    def _eid_rows(dg: DeviceGraph, direction: str, sorted_by: str):
        if direction == "out":
            return dg.out_eid if sorted_by == "id" else dg.out_eid_t
        return dg.in_eid if sorted_by == "id" else dg.in_eid_t

    def body(dg: DeviceGraph, s, d, st_, offs):
        B = s.shape[0]
        dev = s.device
        node_env = {"seed.src": (s, 0), "seed.dst": (d, 0)}
        time_env: Dict[str, Tuple] = {}
        mask_env: Dict[str, Tuple] = {}

        def bound_at(tb: TimeBound, lvl: int):
            # a Python int for unanchored bounds; int32 tensors otherwise
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

        # ---- frontier chain (counting-kernel order, positions kept) ---
        # frontier_hops[lvl-1] = (pos cube, eid rows) or None for unions
        frontier_hops: List[Optional[Tuple]] = []
        for lvl in range(1, k + 1):
            fa = ir.frontiers[lvl - 1]
            width = dims[lvl - 1]
            off = offs[lvl - 1]
            opn = fa.operand
            a1 = bound_at(fa.window.after, lvl)
            u1 = bound_at(fa.window.until, lvl)

            def expand_side(nb: Neigh, _w=width, _off=off, _lvl=lvl):
                indptr, nbr, t, _ = _graph_rows(dg, nb.direction)
                base, _ = node_env[nb.node.name]
                return ops.expand_pos(
                    indptr, (nbr, t), lift(base, _lvl - 1), _w, offset=_off
                )

            def filt(mask, ids, ts, _fa=fa, _a1=a1, _u1=u1, _lvl=lvl):
                m = mask & (ts > _a1) & (ts <= _u1)
                for ref in _fa.skip_eq:
                    m = m & (ids != node_at(ref, _lvl))
                return m

            if isinstance(opn, SetExpr) and opn.op == "union":
                m1, _, i1, t1 = expand_side(opn.left)
                m2, _, i2, t2 = expand_side(opn.right)
                m1, m2 = filt(m1, i1, t1), filt(m2, i2, t2)
                ids = torch.cat([i1, i2], dim=-1)
                ts = torch.cat([t1, t2], dim=-1)
                mask = torch.cat([m1, m2], dim=-1)
                ids, ts, mask = ops.dedup_ids(ids, ts, mask, int(INVALID))
                frontier_hops.append(None)  # node set: no canonical edge
            elif isinstance(opn, SetExpr) and opn.op == "difference":
                mask, pos, ids, ts = expand_side(opn.left)
                mask = filt(mask, ids, ts)
                rb = opn.right
                indptr_r, nbr_r, t_r, _ = _graph_rows(dg, rb.direction)
                member = ws_ops.count_id_in_window(
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
                frontier_hops.append(
                    (pos, _eid_rows(dg, opn.left.direction, "id"))
                )
            else:
                mask, pos, ids, ts = expand_side(opn)
                mask = filt(mask, ids, ts)
                frontier_hops.append((pos, _eid_rows(dg, opn.direction, "id")))
            ids = torch.where(mask, ids, -1)
            node_env[fa.name] = (ids, lvl)
            time_env[fa.name] = (ts, lvl)
            mask_env[fa.name] = (mask, lvl)

        # ---- emit lowering with run positions -------------------------
        def win_level(st: Stage) -> int:
            lvl = 0
            for b in (st.window.after, st.window.until):
                if isinstance(b.anchor, StageT):
                    lvl = max(lvl, ir.nodes[b.anchor.name].level)
            return lvl

        def eval_count(st: Stage):
            """(count cube, emit hop descriptors) for a count stage."""
            if st.op == "count_window":
                nb = st.operand
                base, lvl = node_env[nb.node.name]
                lvl = max(lvl, win_level(st))
                indptr, _, _, t_sorted = _graph_rows(dg, nb.direction)
                cnt, start = ws_ops.count_window_pos(
                    t_sorted,
                    indptr,
                    lift(base, lvl),
                    bound_at(st.window.after, lvl),
                    bound_at(st.window.until, lvl),
                    n_iters,
                )
                return cnt, [("run", start, _eid_rows(dg, nb.direction, "time"))]
            if st.op == "count_edges":
                base, lvl_s = node_env[st.edge_src.name]
                dst_arr, lvl_d = node_env[st.edge_dst.name]
                lvl = max(lvl_s, lvl_d, win_level(st))
                if st is ir.ce_pw and strat == 2:
                    # pairwise witness lowering: the fixed-side expansion
                    # owns axis k+2 (dims slot k+1) so the cube layout
                    # matches (W1..Wk, DA=1, DB) — the counting kernel's
                    # axis-(k+1) placement reduces to the same counts but
                    # would scramble the slot -> coordinate decomposition
                    d_b, off_b = dims[k + 1], offs[k + 1]
                    la = k + 2
                    indptr_i, nbr_i, t_i, _ = _graph_rows(dg, "in")
                    m3, pos_y, y_ids, y_t = ops.expand_pos(
                        indptr_i, (nbr_i, t_i), dst_arr, d_b, offset=off_b
                    )
                    y2, yt2 = mid_lift(y_ids, la), mid_lift(y_t, la)
                    aw = bound_at(st.window.after, la)
                    uw = bound_at(st.window.until, la)
                    pair = (
                        mid_lift(m3, la)
                        & (lift(base, la) == y2)
                        & (yt2 > aw)
                        & (yt2 <= uw)
                    )
                    return pair.to(torch.int32), [
                        ("pos", mid_lift(pos_y, la), dg.in_eid)
                    ]
                indptr, nbr, t, _ = _graph_rows(dg, "out")
                cnt, start = ws_ops.count_id_in_window_pos(
                    nbr,
                    t,
                    indptr,
                    lift(base, lvl),
                    lift(dst_arr, lvl),
                    bound_at(st.window.after, lvl),
                    bound_at(st.window.until, lvl),
                    n_iters,
                )
                return cnt, [("run", start, dg.out_eid)]
            if st.op == "product":
                f1_, f2_ = st.factors
                c1, h1 = eval_count(ir.nodes[f1_].stage)
                c2, h2 = eval_count(ir.nodes[f2_].stage)
                if c1.dim() != 1 or c2.dim() != 1:
                    raise NotImplementedError("witness product of scalar counts only")
                # within in [0, c1*c2): factor 1 outer, factor 2 inner
                return c1 * c2, [("prod", h1[0], h2[0], c2)]
            raise NotImplementedError(f"witness emit op {st.op!r}")

        emit = ir.emit
        ehops: List[Tuple] = []
        if emit.op == "for_all":
            cnt = torch.ones((B,), dtype=torch.int32, device=dev)  # masks supply everything
        elif emit.op == "intersect":
            it = emit
            a, b = it.operands
            d_a, d_b = dims[k], dims[k + 1]
            off_a, off_b = offs[k], offs[k + 1]
            fr_ids = lift(node_env[a.node.name][0], k)
            indptr_a, nbr_a, t_a, _ = _graph_rows(dg, a.direction)
            indptr_b, nbr_b, t_b, _ = _graph_rows(dg, b.direction)
            fixed = node_env[b.node.name][0]
            lx = k + 1
            ea = _eid_rows(dg, a.direction, "id")
            eb = _eid_rows(dg, b.direction, "id")
            m2, pos_x, x_ids, x_t = ops.expand_pos(
                indptr_a, (nbr_a, t_a), fr_ids, d_a, offset=off_a
            )
            a1 = bound_at(it.window.after, lx)
            u1 = bound_at(it.window.until, lx)
            m_x = m2 & (x_t > a1) & (x_t <= u1)
            for ref in it.skip_eq:
                m_x = m_x & (x_ids != node_at(ref, lx))
            if strat == 0:  # bs1: y run addressed inside the fixed row
                a2 = bound_at(it.window2.after, lx)
                u2 = bound_at(it.window2.until, lx)
                aa2 = _max(a2, x_t) if it.ordered else a2
                cnt, ystart = ws_ops.count_id_in_window_pos(
                    nbr_b,
                    t_b,
                    indptr_b,
                    lift(fixed, lx),
                    torch.where(m_x, x_ids, -1),
                    aa2,
                    u2,
                    n_iters,
                )
                cnt = torch.where(m_x, cnt, 0)
                ehops = [("pos", pos_x, ea), ("run", ystart, eb)]
            else:  # pw compare cube — broadcast path (positions kept)
                m3, pos_y, y_ids, y_t = ops.expand_pos(
                    indptr_b, (nbr_b, t_b), fixed, d_b, offset=off_b
                )
                ly = lx + 1
                yb, yt = mid_lift(y_ids, ly), mid_lift(y_t, ly)
                a2 = bound_at(it.window2.after, ly)
                u2 = bound_at(it.window2.until, ly)
                pair = (
                    m_x[..., None]
                    & mid_lift(m3, ly)
                    & (x_ids[..., None] == yb)
                    & (yt > a2)
                    & (yt <= u2)
                )
                if it.ordered:
                    pair = pair & (yt > x_t[..., None])
                cnt = pair.to(torch.int32)
                ehops = [("pos", pos_x, ea), ("pos", mid_lift(pos_y, ly), eb)]
        else:
            cnt, ehops = eval_count(emit)

        # ---- top-k selection over the full candidate cube -------------
        cube = lift(cnt.to(torch.int32), n_axes)
        for f in ir.frontiers:
            cube = cube * lift(mask_env[f.name][0], n_axes).to(torch.int32)
        flat = cube.expand((B,) + adims).reshape(B, C)
        ccum = torch.cumsum(flat, dim=1, dtype=torch.int32)
        total = ccum[:, -1]
        ranks = torch.arange(kp, dtype=torch.int32, device=dev)
        slot = torch.searchsorted(
            ccum, ranks.expand(B, kp).contiguous(), right=True, out_int32=True
        ).clamp_max(C - 1)
        slot_l = slot.long()
        prefix = ccum.gather(1, slot_l) - flat.gather(1, slot_l)
        del ccum, flat
        within = ranks[None, :] - prefix
        valid = ranks[None, :] < total[:, None]
        # per-axis cube coordinates of every selected slot (the sort keys'
        # local part); a plane is read through them in its own shape
        coords = [(slot // cstrides[j]) % adims[j] for j in range(n_axes)]

        def at_slot(x):
            idx = None
            stride = 1
            for j in range(x.dim() - 2, -1, -1):  # plane axis j+1 = cube axis j
                size = x.shape[j + 1]
                if size > 1:
                    assert size == adims[j], (x.shape, adims)
                    term = coords[j] * stride
                    idx = term if idx is None else idx + term
                stride *= size
            x2 = x.reshape(B, -1)
            if idx is None:
                return x2[:, :1].expand(B, kp)
            return x2.gather(1, idx.long())

        def eid_at(pos_plane, earr):
            cap = earr.shape[0] - 1
            return torch.where(valid, earr[pos_plane.clamp(0, cap)], -1)

        # sort keys: per-axis GLOBAL cube coordinates (slot decomposition
        # plus the sweep offset) and the within-slot rank — row-major
        # lexicographic order over these keys IS the canonical candidate
        # order, and coordinate tuples are unique across sweep combos
        keys = [
            torch.where(valid, coords[j] + int(offs[j]), _I32_MAX)
            for j in range(n_axes)
        ]
        keys.append(torch.where(valid, within, _I32_MAX))

        planes = []
        for fh in frontier_hops:
            if fh is None:
                planes.append(torch.full((B, kp), -1, dtype=torch.int32, device=dev))
            else:
                pos_cube, earr = fh
                planes.append(eid_at(at_slot(pos_cube), earr))
        for eh in ehops:
            if eh[0] == "pos":
                planes.append(eid_at(at_slot(eh[1]), eh[2]))
            elif eh[0] == "run":
                planes.append(eid_at(at_slot(eh[1]) + within, eh[2]))
            else:  # prod: decompose within over (factor1, factor2) runs
                (_, s1, e1), (_, s2, e2), c2 = eh[1], eh[2], eh[3]
                c2s = at_slot(c2).clamp_min(1)
                off1 = within // c2s
                off2 = within - off1 * c2s
                planes.append(eid_at(at_slot(s1) + off1, e1))
                planes.append(eid_at(at_slot(s2) + off2, e2))
        assert len(planes) == H, (len(planes), H)
        return total, keys, planes

    # ---- sweep fusion: merge combos' top-k by global coordinates ------
    n_sweep = int(np.prod(sweeps))
    strides: List[int] = []
    acc = 1
    for sc in reversed(sweeps):
        strides.append(acc)
        acc *= sc
    strides = tuple(reversed(strides))
    nk = n_axes + 1

    def kernel(dg: DeviceGraph, s, d, st_, fr, frt):
        del fr, frt  # witness schedules are bulk-only
        if n_sweep == 1:
            total, _, planes = body(dg, s, d, st_, (0,) * len(dims))
            return total, torch.stack(planes, dim=-1)
        B = s.shape[0]
        tot = torch.zeros(B, dtype=torch.int32, device=s.device)
        kacc = torch.full((B, kp, nk), _I32_MAX, dtype=torch.int32, device=s.device)
        pacc = torch.full((B, kp, H), -1, dtype=torch.int32, device=s.device)
        for i in range(n_sweep):
            offs = tuple(
                ((i // strides[j]) % sweeps[j]) * dims[j] for j in range(len(dims))
            )
            t2, keys, planes = body(dg, s, d, st_, offs)
            kc = torch.cat([kacc, torch.stack(keys, dim=-1)], dim=1)
            pc = torch.cat([pacc, torch.stack(planes, dim=-1)], dim=1)
            # lexicographic order over the nk keys: stable sorts from the
            # last key to the first (the JAX package's multi-key lax.sort)
            perm = None
            for j in range(nk - 1, -1, -1):
                col = kc[:, :, j] if perm is None else kc[:, :, j].gather(1, perm)
                order = torch.sort(col, dim=1, stable=True).indices
                perm = order if perm is None else perm.gather(1, order)
            perm = perm[:, :kp]
            kacc = kc.gather(1, perm[..., None].expand(B, kp, nk))
            pacc = pc.gather(1, perm[..., None].expand(B, kp, H))
            tot = tot + t2
        return tot, pacc

    return kernel


def _witness_kernel(cp, strat: int, dims, sweeps, kp: int) -> Callable:
    """The plan's cached witness callable for one launch shape (the "wit"
    tag keeps the key disjoint from the counting-kernel keys in the
    shared, possibly cross-tick, kernels cache)."""
    key = (cp.n_iters, "wit", strat, dims, sweeps, kp)
    fn = cp._kernels.get(key)  # lock-free warm path
    if fn is None:
        with cp._jit_lock:
            fn = cp._kernels.get(key)
            if fn is None:
                fn = _build_witness_kernel(cp.ir, cp.n_iters, strat, dims, sweeps, kp)
                cp._kernels[key] = fn
    return fn


def mine_witnesses(
    cp,
    seed_eids: Optional[np.ndarray] = None,
    k: int = 1,
    *,
    dg: Optional[DeviceGraph] = None,
    device=None,
) -> Witnesses:
    """Mine per-seed counts AND top-k witness hop tuples for a compiled
    plan, device-resident end to end.

    Mirrors ``CompiledPattern.mine`` — bulk-only bucket schedule, one
    host→device copy per group, async launches accumulated on the device
    of the graph mirror (``dg``, default the plan's own) — with two
    accumulators in one int32 buffer (counts added, packed eids set; rows
    are unique per seed in bulk mode, so the set is race-free) and
    exactly ONE blocking device→host sync fetching both together.  ``k``
    is pow2-ceiled for the launch-shape key and trimmed on the host.
    ``device``, when given, must name the mirror's device.
    """
    if k < 1:
        raise ValueError("witnesses=k must be >= 1")
    layout = witness_layout(cp.ir)
    H = len(layout)
    if seed_eids is None:
        seed_eids = np.arange(cp.g.n_edges, dtype=np.int32)
    seed_eids = np.asarray(seed_eids, dtype=np.int32)
    n = len(seed_eids)
    kp = executor.pow2ceil(max(1, int(k)))
    if n == 0:
        return Witnesses(
            pattern=cp.spec.name,
            hops=layout,
            k=int(k),
            counts=np.zeros(0, dtype=np.int64),
            n_found=np.zeros(0, dtype=np.int32),
            eids=np.full((0, int(k), H), -1, dtype=np.int64),
        )
    dgraph = cp.dg if dg is None else dg
    dev = dgraph.device
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} differs from the graph mirror's {dev}")
    stats = cp.stats
    sched = cp.schedule_for(seed_eids, stats, bulk_only=True)
    # one buffer, two accumulators: n counts, then n + 1 rows of packed ids
    # (row n is the spare that pad rows are sent to, dropped on the host)
    width = kp * H
    buf = torch.empty(n + (n + 1) * width, dtype=torch.int32, device=dev)
    out_cnt = buf[:n].zero_()
    out_eids = buf[n:].view(n + 1, kp, H).fill_(-1)
    local_keys: set = set()
    for grp in sched.groups:
        staged = h2d(np.stack(grp.staging), dev)
        stats["bytes_h2d"] += sum(int(a.nbytes) for a in grp.staging)
        fn = _witness_kernel(cp, grp.strat, grp.dims, grp.sweeps, kp)
        s0 = 0
        for w in grp.widths:
            ss, dd, tt, ff, fft, seg = staged[:, s0 : s0 + w].unbind(0)
            cnt, eids = fn(dgraph, ss, dd, tt, ff, fft)
            keep = seg < n
            out_cnt.index_add_(0, torch.where(keep, seg, 0), torch.where(keep, cnt, 0))
            out_eids[torch.where(keep, seg, n).long()] = eids
            local_keys.add(
                (cp.n_iters, "wit", grp.strat, grp.dims, grp.sweeps, kp, w)
            )
            stats["kernel_calls"] += 1
            stats["padded_elements"] += w * grp.per_row * grp.n_sweep
            s0 += w
    with cp._jit_lock:
        new_keys = local_keys - cp._trace_keys
        cp._trace_keys |= new_keys
    stats["jit_cache_entries"] += len(new_keys)
    # THE host sync: counts and packed witness ids in one transfer (the
    # spare row stays on the card)
    host = to_host(buf[: n + n * width])
    stats["host_syncs"] += 1
    stats["bytes_d2h"] += int(host.nbytes)
    counts = host[:n].astype(np.int64)
    eids_h = host[n:].reshape(n, kp, H)
    return Witnesses(
        pattern=cp.spec.name,
        hops=layout,
        k=int(k),
        counts=counts,
        n_found=np.minimum(counts, int(k)).astype(np.int32),
        eids=eids_h[:, : int(k), :].astype(np.int64),
    )
