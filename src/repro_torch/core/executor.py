"""Device-resident async bucket executor, in torch (the port of the JAX
package's ``repro.core.executor``).

The host half (``STAT_KEYS``, ``chunk_widths``, ``coalesce_*``,
``BucketGroup``, ``Schedule``, ``build_staging``) is a copy of the
reference; the device half is rewritten for torch:

* **Staging once per bucket group** — a group's padded ``src``/``dst``/
  ``ts``/frontier/``seg`` staging rows are packed into ONE host buffer and
  moved with a single pinned, non-blocking host→device copy
  (:func:`repro_torch.device.h2d`); per-chunk inputs are device-side
  slices, so the inner loop never allocates host memory or transfers.
* **Async dispatch + device accumulation** — every kernel call returns a
  device tensor that is scatter-added into a device-resident int32
  per-seed output vector.  JAX drops the pad rows (``seg == n_out``) with
  ``at[].add(mode="drop")``; torch's ``index_add_`` asserts on an
  out-of-range index instead, so pad rows are masked first (their index
  is redirected to row 0 and their value zeroed).  The accumulator is
  updated in place.  Nothing blocks: the ONLY host sync of a mine call is
  the final :func:`fetch` of the finished counts.
* **Bounded launch shapes** — chunk widths come from a power-of-two
  ladder (:func:`chunk_widths`), so a bucket group launches at only
  ``log2(bchunk / MIN_CHUNK) + 1`` distinct batch widths; the
  ``jit_cache_entries`` gauge counts the same (strategy, dims, sweeps,
  branch, width) launch-shape keys as the JAX executor's trace keys.

Observability counters (reported through ``CompiledPattern.stats`` /
``MiningResult.stats``):

``kernel_calls``      kernel-callable invocations (sweep grids count as
                      ONE — the sweep loop runs inside the callable)
``padded_elements``   padded query-shape elements materialized, sweep
                      iterations included
``branch_items``      host-decomposed hub branch items
``host_syncs``        blocking device→host transfers (1 per mine call)
``bytes_h2d``         staging bytes shipped host→device
``bytes_d2h``         result bytes shipped device→host
``jit_cache_entries`` distinct (strategy, dims, sweeps, branch, batch)
                      launch shapes seen so far (the JAX package's trace
                      gauge, counted on the same keys)
``schedule_hits``     bucket schedules served from the schedule cache

Accumulation width: device tensors are int32 across the system, as in
the JAX package, so per-seed counts are exact up to 2^31-1 and wrap past
it identically on both sides.

Tracing (`repro_torch.obs.trace`, off by default): each bucket group
contributes a ``stage`` span (the staging copy, with its ``bytes_h2d``
delta) and a ``launch`` span (the chunk dispatch loop), and
:func:`fetch` contributes a ``gather`` span.  Spans time *dispatch*, not
device completion; only the blocking ``gather`` span covers real device
execution.  The tracer never adds a host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import h2d, to_host
from repro_torch.obs import trace as obs_trace

__all__ = [
    "STAT_KEYS",
    "MIN_CHUNK",
    "new_stats",
    "pow2ceil",
    "chunk_widths",
    "coalesce_widths",
    "coalesce_groups",
    "BucketGroup",
    "Schedule",
    "build_staging",
    "execute",
    "fetch",
]

STAT_KEYS = (
    "kernel_calls",
    "padded_elements",
    "branch_items",
    "host_syncs",
    "bytes_h2d",
    "bytes_d2h",
    "jit_cache_entries",
    "schedule_hits",
)

MIN_CHUNK = 32  # smallest padded batch width (floor of the chunk ladder)


def new_stats() -> Dict[str, int]:
    return {k: 0 for k in STAT_KEYS}


def pow2ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def chunk_widths(
    n_rows: int,
    batch_elem_cap: int,
    per_row: int,
    pad_rows_pow2: bool = False,
) -> List[int]:
    """Padded batch widths of a bucket group's chunks.

    Full chunks share one power-of-two width ``bchunk`` sized so a launch
    stays under ``batch_elem_cap`` padded elements; the tail is rounded up
    to the next power of two with a ``MIN_CHUNK`` floor.  Every width is a
    power of two in ``[MIN_CHUNK, bchunk]`` (or the single ``pow2ceil``
    width of a tiny group), so the set of batch shapes a (strategy, dims)
    kernel can be traced at is logarithmic, not linear, in group size.

    ``pad_rows_pow2=True`` sizes the widths for ``pow2ceil(n_rows)`` rows
    instead, with a ``MIN_CHUNK`` floor on the row class: the widths LIST
    itself (not just each width) is then canonical per pow2 row-count
    class, so shape-keyed schedule reuse can treat it as part of a stable
    launch profile — and tiny groups (streaming hub branches routinely
    have 1-16 rows) collapse onto ONE width class instead of minting a
    kernel trace per pow2 size below the floor.  The surplus rows are
    staged as padding (:func:`build_staging` points their scatter targets
    at the drop sentinel), so results are unchanged.
    """
    if pad_rows_pow2:
        n_rows = max(MIN_CHUNK, pow2ceil(max(1, n_rows)))
    bchunk = max(MIN_CHUNK, batch_elem_cap // max(1, per_row))
    bchunk = 1 << (bchunk.bit_length() - 1)  # round DOWN: ladder anchor
    bchunk = min(bchunk, pow2ceil(n_rows))
    widths = [bchunk] * (n_rows // bchunk)
    tail = n_rows - bchunk * len(widths)
    if tail:
        widths.append(min(bchunk, max(MIN_CHUNK, pow2ceil(tail))))
    return widths


def coalesce_widths(widths: Sequence[int], factor: int) -> List[int]:
    """Merge runs of equal-width chunks into fewer, fatter launches.

    Chunks of a bucket group are consecutive slices of ONE staging buffer,
    so ``k`` adjacent equal-width chunks can be launched as a single
    ``k*w``-wide kernel call just by slicing fatter — no restaging.  Merges
    happen in power-of-two counts up to ``factor`` (pow2-floored), so every
    produced width stays on the power-of-two trace ladder and the set of
    distinct batch widths grows by at most ``log2(factor)`` entries.

    Dispatch-bound callers use this (the sharded executor batches each
    device's launches before dispatching); the total padded element count
    is unchanged — only the launch count drops.
    """
    if factor <= 1 or len(widths) <= 1:
        return list(widths)
    fmax = 1 << (int(factor).bit_length() - 1)  # pow2 floor of factor
    out: List[int] = []
    i = 0
    n = len(widths)
    while i < n:
        w = widths[i]
        run = 1
        while i + run < n and widths[i + run] == w:
            run += 1
        i += run
        while run > 0:
            take = min(fmax, 1 << (run.bit_length() - 1))
            out.append(w * take)
            run -= take
    return out


def coalesce_groups(
    groups: Sequence["BucketGroup"], factor: int
) -> List["BucketGroup"]:
    """A schedule's groups with per-group chunk widths coalesced (the
    staging buffers are shared with the input groups — widths are just a
    different slicing of the same padded host buffer)."""
    if factor <= 1:
        return list(groups)
    return [
        dataclasses.replace(g, widths=coalesce_widths(g.widths, factor))
        for g in groups
    ]


@dataclasses.dataclass
class BucketGroup:
    """One (strategy, bucket-dims) group of the schedule, staged and ready
    to launch: padded host staging buffers plus the chunk widths that
    slice them."""

    strat: int
    dims: Tuple[int, ...]
    sweeps: Tuple[int, ...]
    branch: bool
    widths: List[int]
    # padded host staging: (src, dst, ts, frontier, frontier_t, seg)
    staging: Tuple[np.ndarray, ...]
    per_row: int
    n_sweep: int


@dataclasses.dataclass
class Schedule:
    """A fully grouped, staged bucket schedule for one (plan, seed set).

    Pure in (plan, graph degree requirements, seed ids) — cacheable, so a
    repeated ``mine()`` over the same seeds replays the launches without
    re-running any host-side numpy grouping."""

    groups: List[BucketGroup]
    branch_items: int
    n_out: int


def build_staging(
    widths: Sequence[int],
    n_out: int,
    sel: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    ts: np.ndarray,
    seg_vals: np.ndarray,
    fr: Optional[np.ndarray] = None,
    frt: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, ...]:
    """One padded staging buffer per kernel input for a whole group.

    Chunks are consecutive slices and only the final tail chunk carries
    padding, so a single ``np.full`` + prefix fill per field replaces the
    old per-chunk ``neg``/``zero``/``concatenate`` allocations.  ``seg``
    holds the scatter target of every row; pad rows point at ``n_out``,
    which the drop-mode scatter discards.
    """
    total = int(sum(widths))
    n = len(sel)
    ss = np.full(total, -1, np.int32)
    dd = np.full(total, -1, np.int32)
    tt = np.zeros(total, np.int32)
    ff = np.full(total, -1, np.int32)
    fft = np.zeros(total, np.int32)
    seg = np.full(total, n_out, np.int32)
    ss[:n] = src[sel]
    dd[:n] = dst[sel]
    tt[:n] = ts[sel]
    if fr is not None:
        ff[:n] = fr[sel]
        fft[:n] = frt[sel]
    seg[:n] = seg_vals
    return ss, dd, tt, ff, fft, seg


def _scatter_add(out: torch.Tensor, seg: torch.Tensor, val: torch.Tensor) -> None:
    """``out[seg] += val`` in place, dropping pad rows (``seg == n_out``).

    Valid rows are disjoint across groups on the bulk path (add into zeros
    == assignment) and repeat on the branch path (segment sum).  Masking
    instead of a boolean index keeps the scatter free of host syncs."""
    keep = seg < out.shape[0]
    out.index_add_(0, torch.where(keep, seg, 0), torch.where(keep, val, 0))


def execute(
    groups: Sequence[BucketGroup],
    n_out: int,
    kernel_for: Callable[[int, Tuple[int, ...], Tuple[int, ...], bool], Callable],
    dg,
    stats: Dict[str, int],
    trace_keys: set,
    trace_tag: Tuple = (),
):
    """Launch every group chunk asynchronously, accumulating on the
    device of ``dg`` (the graph mirror the kernels read).

    Returns the device-resident per-seed count vector; nothing here
    blocks on the device — call :func:`fetch` for the one host sync.
    """
    device = dg.device
    out = torch.zeros(n_out, dtype=torch.int32, device=device)
    for grp in groups:
        with obs_trace.span(
            "stage", stats=stats, strat=grp.strat, dims=str(grp.dims)
        ):
            # (6, total): src, dst, ts, frontier, frontier_t, seg
            dev = h2d(np.stack(grp.staging), device)
            stats["bytes_h2d"] += sum(int(a.nbytes) for a in grp.staging)
        fn = kernel_for(grp.strat, grp.dims, grp.sweeps, grp.branch)
        with obs_trace.span(
            "launch", stats=stats, strat=grp.strat, dims=str(grp.dims)
        ):
            s0 = 0
            for w in grp.widths:
                ss, dd, tt, ff, fft, seg = dev[:, s0 : s0 + w].unbind(0)
                res = fn(dg, ss, dd, tt, ff, fft)
                _scatter_add(out, seg, res)
                # trace_tag carries caller-side key components (the
                # compiled plan's n_iters) so cross-plan gauges don't collide
                trace_keys.add(trace_tag + (grp.strat, grp.dims, grp.sweeps, grp.branch, w))
                stats["kernel_calls"] += 1
                stats["padded_elements"] += w * grp.per_row * grp.n_sweep
                s0 += w
    return out


def fetch(out_dev: torch.Tensor, stats: Dict[str, int]) -> np.ndarray:
    """THE host sync: one blocking transfer of the finished counts."""
    with obs_trace.span("gather", stats=stats, mode="fetch"):
        host = to_host(out_dev)
        stats["host_syncs"] += 1
        stats["bytes_d2h"] += int(host.nbytes)
    return host
