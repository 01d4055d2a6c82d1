"""Vectorized mining primitives the compiler lowers stages onto, in torch
tensor ops (the port of the JAX package's ``repro.core.ops``).

* ``lower_bound`` — branch-free fixed-iteration binary search, vectorized
  over arbitrary query shapes (the "early exit on temporal violation"
  becomes a closed-form rank difference).  The iteration count is static
  (``n_iters_for(max_deg)``), so the search is a Python loop of
  ``n_iters`` elementwise steps, exactly as many as the JAX
  ``fori_loop`` runs.
* ``count_id_in_window`` — two-level search: locate the id run inside an
  id-sorted CSR row, then rank the time window inside that run (rows are
  sorted by (id, t), so the run is time-sorted).  Pure int32 ops.
* ``count_window`` — windowed degree on the time-sorted row copy.
* ``expand`` — padded neighborhood materialization for ``for_all`` stages
  (the only primitive that materializes; intersections never do).

All primitives broadcast elementwise, so higher stage arity is just query
shape: seeds ``(B,)``, one expansion ``(B, D1)``, two ``(B, D1, D2)``.

Semantics the JAX versions get implicitly and this port spells out:

* every gather index is clipped into range (JAX clamps silently; torch
  raises on the CPU and asserts on the card);
* arithmetic stays int32: a Python ``int`` operand keeps an int32 tensor
  int32, and bound values enter as int32 before any ``+ 1`` so the wrap
  matches JAX's;
* ``dedup_ids`` sorts with ``stable=True`` (``jnp.argsort`` is stable and
  the stable order picks which frontier time survives).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = [
    "lower_bound",
    "count_t_in",
    "count_t_in_pos",
    "count_id_in_window",
    "count_id_in_window_pos",
    "count_window",
    "count_window_pos",
    "expand",
    "expand_pos",
    "dedup_ids",
    "n_iters_for",
]

IntLike = Union[int, torch.Tensor]


def n_iters_for(max_len: int) -> int:
    return max(1, int(max_len).bit_length())


def _i32(x: IntLike, device: torch.device) -> torch.Tensor:
    """An int32 tensor for ``x`` on ``device`` (a Python int becomes a 0-d
    fill, never a host→device copy)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.int32 else x.to(torch.int32)
    return torch.full((), int(x), dtype=torch.int32, device=device)


def lower_bound(flat, lo, hi, q, n_iters: int):
    """# of elements in flat[lo:hi) strictly less than q (elementwise)."""
    dev = flat.device
    q, lo, hi = _i32(q, dev), _i32(lo, dev), _i32(hi, dev)
    shape = torch.broadcast_shapes(q.shape, lo.shape, hi.shape)
    q = q.expand(shape)
    clo = lo.expand(shape)
    chi = hi.expand(shape)
    cap = flat.shape[0] - 1
    for _ in range(n_iters):
        mid = (clo + chi) >> 1
        v = flat[mid.clamp(0, cap)]
        active = clo < chi
        less = v < q
        clo, chi = (
            torch.where(active & less, mid + 1, clo),
            torch.where(active & ~less, mid, chi),
        )
    return clo


def count_t_in(t_flat, start, end, after, until, n_iters: int):
    """# of times in t_flat[start:end) with  after < t <= until.

    Clamped at 0: callers clamp per-branch windows (e.g. the `ordered`
    intersect lowers to until=min(u, t2-1)), which can invert the window
    (until < after); the rank difference would then go negative by the
    number of edges inside the inverted range.
    """
    dev = t_flat.device
    a = lower_bound(t_flat, start, end, _i32(after, dev) + 1, n_iters)
    b = lower_bound(t_flat, start, end, _i32(until, dev) + 1, n_iters)
    return (b - a).clamp_min(0)


def count_t_in_pos(t_flat, start, end, after, until, n_iters: int):
    """Like :func:`count_t_in`, but also returns the absolute flat rank of
    the first in-window element.  The j-th in-window element of the run
    (j < count) sits at flat position ``start_pos + j``."""
    dev = t_flat.device
    a = lower_bound(t_flat, start, end, _i32(after, dev) + 1, n_iters)
    b = lower_bound(t_flat, start, end, _i32(until, dev) + 1, n_iters)
    return (b - a).clamp_min(0), a


def _row_bounds(indptr, node):
    node = _i32(node, indptr.device)
    safe = node.clamp_min(0)
    return node, indptr[safe], indptr[safe + 1]


def count_id_in_window(
    nbr_flat,
    t_flat,
    indptr,
    node,
    x,
    after,
    until,
    n_iters: int,
):
    """Multiplicity of edges node->x (id-sorted row) with t in (after, until].

    Row layout is sorted by (id, t): the id run [lb, ub) found in level 1 is
    itself time-sorted, so level 2 ranks the window inside the run.
    Invalid nodes (node < 0) contribute 0.
    """
    node, start, end = _row_bounds(indptr, node)
    x = _i32(x, nbr_flat.device)
    lb = lower_bound(nbr_flat, start, end, x, n_iters)
    ub = lower_bound(nbr_flat, start, end, x + 1, n_iters)
    cnt = count_t_in(t_flat, lb, ub, after, until, n_iters)
    return torch.where((node >= 0) & (x >= 0), cnt, 0)


def count_id_in_window_pos(
    nbr_flat,
    t_flat,
    indptr,
    node,
    x,
    after,
    until,
    n_iters: int,
):
    """(count, run start) variant of :func:`count_id_in_window`: the id
    run [lb, ub) is time-sorted, so the j-th matched edge of the window
    sits at flat position ``start + j`` of the id-sorted row arrays."""
    node, start, end = _row_bounds(indptr, node)
    x = _i32(x, nbr_flat.device)
    lb = lower_bound(nbr_flat, start, end, x, n_iters)
    ub = lower_bound(nbr_flat, start, end, x + 1, n_iters)
    cnt, pos = count_t_in_pos(t_flat, lb, ub, after, until, n_iters)
    return torch.where((node >= 0) & (x >= 0), cnt, 0), pos


def count_window(t_sorted_flat, indptr, node, after, until, n_iters: int):
    """Windowed degree of `node` on the time-sorted row copy."""
    node, start, end = _row_bounds(indptr, node)
    cnt = count_t_in(t_sorted_flat, start, end, after, until, n_iters)
    return torch.where(node >= 0, cnt, 0)


def count_window_pos(t_sorted_flat, indptr, node, after, until, n_iters: int):
    """(count, run start) variant of :func:`count_window`: the j-th
    in-window edge sits at flat position ``start + j`` of the time-sorted
    row arrays."""
    node, start, end = _row_bounds(indptr, node)
    cnt, pos = count_t_in_pos(t_sorted_flat, start, end, after, until, n_iters)
    return torch.where(node >= 0, cnt, 0), pos


def dedup_ids(ids, ts, mask, invalid: int):
    """Keep one representative per id along the last axis (node-set dedup).

    Sorts masked-out slots to the end (as `invalid`), compares neighbors,
    and returns (ids, ts, mask) with duplicates masked off.  Filter the
    mask *before* calling so each id's surviving representative satisfies
    the window — union ``for_all`` frontiers lower onto this.  The sort is
    stable, so among equal ids the first slot's time survives (JAX's
    ``argsort`` order).
    """
    key = torch.where(mask, ids, int(invalid))
    ids, order = torch.sort(key, dim=-1, stable=True)
    ts = torch.take_along_dim(ts, order, dim=-1)
    prev = torch.cat([torch.full_like(ids[..., :1], -1), ids[..., :-1]], dim=-1)
    mask = (ids != int(invalid)) & (ids != prev)
    return ids, ts, mask


def _expand_idx(indptr, node, d: int, offset):
    node, start, end = _row_bounds(indptr, node)
    start = start + offset
    idx = start[..., None] + torch.arange(d, dtype=torch.int32, device=indptr.device)
    mask = (idx < end[..., None]) & (node >= 0)[..., None]
    return mask, idx


def expand(
    indptr,
    flats: Tuple,
    node,
    d: int,
    offset: IntLike = 0,
):
    """Materialize up to `d` row elements per node (padded).

    Returns (mask, gathered...) each of shape node.shape + (d,).  `offset`
    (broadcastable to node.shape) slides the window along the row — the
    hub-tail chunking path uses it to sweep rows longer than `d`.
    """
    mask, idx = _expand_idx(indptr, node, d, offset)
    cidx = idx.clamp(0, flats[0].shape[0] - 1)
    return (mask,) + tuple(f[cidx] for f in flats)


def expand_pos(
    indptr,
    flats: Tuple,
    node,
    d: int,
    offset: IntLike = 0,
):
    """:func:`expand` that also returns the (clipped) flat row positions
    of the gathered elements.  Positions at masked slots are clipped
    garbage; callers only read them where the mask holds."""
    mask, idx = _expand_idx(indptr, node, d, offset)
    cidx = idx.clamp(0, flats[0].shape[0] - 1)
    return (mask, cidx) + tuple(f[cidx] for f in flats)
