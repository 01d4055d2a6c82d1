"""Temporal CSR/CSC graph substrate.

The mining compiler (repro_torch.core.compiler) consumes a :class:`TemporalGraph`,
which stores every adjacency row in TWO orders:

* id-sorted (``nbr`` ascending, ties by timestamp) — enables O(log d)
  binary-search set membership / weighted intersection, including temporal
  windows, via a composite ``key = nbr * (t_max+2) + (t+1)`` that is
  lexicographic in (nbr, t); the device mirror searches the same
  order with two int32 binary searches.
* time-sorted (``t`` ascending) — turns the paper's "break on time-window
  overflow" early-exit into a closed-form ``searchsorted`` slice
  (fan/degree-in-window counting without data-dependent control flow).

Multi-edges (parallel transactions between the same account pair) are
first-class: duplicate neighbor ids are kept, so a binary-search range
``[lower_bound, upper_bound)`` *is* the edge multiplicity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "TemporalGraph",
    "DeviceGraph",
    "build_temporal_graph",
    "csr_row_offsets",
]


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def csr_row_offsets(indptr: np.ndarray, nodes: np.ndarray):
    """Flat CSR positions of the adjacency rows of `nodes`, concatenated
    in node order, plus per-node row lengths (so callers can map entries
    back to their source node with ``np.repeat(..., lens)``)."""
    starts = indptr[nodes].astype(np.int64)
    lens = (indptr[nodes + 1] - indptr[nodes]).astype(np.int64)
    tot = int(lens.sum())
    first = np.repeat(np.cumsum(lens) - lens, lens)
    offs = np.repeat(starts, lens) + (np.arange(tot, dtype=np.int64) - first)
    return offs, lens


@dataclasses.dataclass(frozen=True)
class TemporalGraph:
    """Host-side (numpy) temporal multigraph in dual-order CSR/CSC form
    (a copy of the JAX package's ``repro.graph.csr.TemporalGraph``; the
    host half is framework-free)."""

    n_nodes: int
    n_edges: int
    # edge list in input (edge-id) order
    src: np.ndarray  # (E,) int32
    dst: np.ndarray  # (E,) int32
    t: np.ndarray  # (E,) int64
    amount: np.ndarray  # (E,) float32
    # out-CSR, id-sorted within row
    out_indptr: np.ndarray  # (N+1,) int64
    out_nbr: np.ndarray  # (E,) int32 — dst, sorted by (src, dst, t)
    out_key: np.ndarray  # (E,) int64 — composite (nbr, t) key
    out_t: np.ndarray  # (E,) int64
    out_eid: np.ndarray  # (E,) int32 — original edge id
    # out-CSR, time-sorted within row
    out_t_sorted: np.ndarray  # (E,) int64 — t sorted by (src, t)
    out_eid_t: np.ndarray  # (E,) int32
    # in-CSC, id-sorted within row
    in_indptr: np.ndarray
    in_nbr: np.ndarray  # src, sorted by (dst, src, t)
    in_key: np.ndarray
    in_t: np.ndarray
    in_eid: np.ndarray
    # in-CSC, time-sorted within row
    in_t_sorted: np.ndarray
    in_eid_t: np.ndarray
    # composite-key scale: key = nbr * key_scale + (t + 1); 0 reserved
    key_scale: int
    t_max: int

    # ---- degree helpers -------------------------------------------------
    @property
    def out_deg(self) -> np.ndarray:
        return np.diff(self.out_indptr).astype(np.int32)

    @property
    def in_deg(self) -> np.ndarray:
        return np.diff(self.in_indptr).astype(np.int32)

    def max_out_deg(self) -> int:
        return int(self.out_deg.max(initial=0))

    def max_in_deg(self) -> int:
        return int(self.in_deg.max(initial=0))

    def degree_stats(self) -> dict:
        od, idg = self.out_deg, self.in_deg
        return {
            "n_nodes": self.n_nodes,
            "n_edges": self.n_edges,
            "out_deg_mean": float(od.mean()) if od.size else 0.0,
            "out_deg_max": int(od.max(initial=0)),
            "out_deg_p99": float(np.percentile(od, 99)) if od.size else 0.0,
            "in_deg_mean": float(idg.mean()) if idg.size else 0.0,
            "in_deg_max": int(idg.max(initial=0)),
            "in_deg_p99": float(np.percentile(idg, 99)) if idg.size else 0.0,
        }

    def to_device(
        self,
        pad: bool = False,
        *,
        floor_nodes: int = 1,
        floor_edges: int = 1,
        floor_deg: int = 1,
        device=None,
    ) -> "DeviceGraph":
        """torch mirror on ``device`` (default: the CUDA card, see
        :func:`repro_torch.device.resolve_device`).  Device arrays are int32:
        instead of the int64 composite key, compiled plans do a two-level
        int32 binary search (id range, then time range within it).

        ``pad=True`` rounds every dimension that lands in a kernel cache
        key up to a power of two: edge-length arrays are padded (the tail
        is unreachable — binary searches and expansions only address CSR
        ranges below the real ``indptr`` values), ``indptr`` gains empty
        rows up to a pow2 node count, and the static ``max_deg`` is
        pow2-ceiled so the derived binary-search iteration count lands on
        a ladder.

        ``floor_nodes``/``floor_edges``/``floor_deg`` (pad mode only) set
        lower bounds on the padded dimensions, so a caller can keep
        monotone high-water floors across graph views.  Oversizing is
        exact: padded CSR tails sit above every real ``indptr`` value and
        extra bisection iterations converge harmlessly.  Padding, fill
        values and floors are those of the JAX package's
        ``TemporalGraph.to_device``."""
        from repro_torch.device import h2d, resolve_device

        dev = resolve_device(device)

        def pad_edges(a: np.ndarray, fill: int, e_pad: int) -> np.ndarray:
            if len(a) == e_pad:
                return a
            out = np.full(e_pad, fill, dtype=a.dtype)
            out[: len(a)] = a
            return out

        if pad:
            e_pad = _pow2ceil(max(1, int(floor_edges), self.n_edges))
            n_pad = _pow2ceil(max(1, int(floor_nodes), self.n_nodes))
            ep = lambda a, fill=-1: pad_edges(np.asarray(a), fill, e_pad)
            ip = lambda a: pad_edges(np.asarray(a), int(a[-1]), n_pad + 1)
            n_nodes, n_edges = n_pad, e_pad
            max_deg = _pow2ceil(
                max(1, int(floor_deg), self.max_out_deg(), self.max_in_deg())
            )
        else:
            ep = lambda a, fill=-1: a
            ip = lambda a: a
            n_nodes, n_edges = self.n_nodes, self.n_edges
            max_deg = max(1, self.max_out_deg(), self.max_in_deg())

        i32 = lambda a: h2d(np.asarray(a).astype(np.int32, copy=False), dev)
        return DeviceGraph(
            n_nodes=n_nodes,
            n_edges=n_edges,
            max_deg=max_deg,
            src=i32(ep(self.src)),
            dst=i32(ep(self.dst)),
            t=i32(ep(self.t, 0)),
            amount=h2d(np.asarray(ep(self.amount, 0), dtype=np.float32), dev),
            out_indptr=i32(ip(self.out_indptr)),
            out_nbr=i32(ep(self.out_nbr)),
            out_t=i32(ep(self.out_t, 0)),
            out_eid=i32(ep(self.out_eid, -1)),
            out_t_sorted=i32(ep(self.out_t_sorted, 0)),
            out_eid_t=i32(ep(self.out_eid_t, -1)),
            in_indptr=i32(ip(self.in_indptr)),
            in_nbr=i32(ep(self.in_nbr)),
            in_t=i32(ep(self.in_t, 0)),
            in_eid=i32(ep(self.in_eid, -1)),
            in_t_sorted=i32(ep(self.in_t_sorted, 0)),
            in_eid_t=i32(ep(self.in_eid_t, -1)),
        )


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """torch mirror of TemporalGraph (fields used by compiled mining
    plans): int32 tensors on one device (``amount`` is float32) plus the
    static ``n_nodes``/``n_edges``/``max_deg``."""

    n_nodes: int
    n_edges: int
    max_deg: int
    src: torch.Tensor
    dst: torch.Tensor
    t: torch.Tensor
    amount: torch.Tensor
    out_indptr: torch.Tensor
    out_nbr: torch.Tensor
    out_t: torch.Tensor
    out_eid: torch.Tensor
    out_t_sorted: torch.Tensor
    out_eid_t: torch.Tensor
    in_indptr: torch.Tensor
    in_nbr: torch.Tensor
    in_t: torch.Tensor
    in_eid: torch.Tensor
    in_t_sorted: torch.Tensor
    in_eid_t: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.src.device


def _csr_from_edges(
    key_major: np.ndarray,
    minor: np.ndarray,
    t: np.ndarray,
    n_nodes: int,
    key_scale: int,
):
    """Build one CSR: rows keyed by key_major, id-sorted + time-sorted copies."""
    e = key_major.shape[0]
    eid = np.arange(e, dtype=np.int32)
    # id-sorted: (major, minor, t)
    order = np.lexsort((t, minor, key_major))
    nbr = minor[order].astype(np.int32)
    tt = t[order].astype(np.int64)
    keys = nbr.astype(np.int64) * key_scale + (tt + 1)
    # time-sorted: (major, t)
    torder = np.lexsort((t, key_major))
    t_sorted = t[torder].astype(np.int64)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(indptr, key_major.astype(np.int64) + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, nbr, keys, tt, eid[order], t_sorted, eid[torder]


def build_temporal_graph(
    src: np.ndarray,
    dst: np.ndarray,
    t: np.ndarray,
    amount: Optional[np.ndarray] = None,
    n_nodes: Optional[int] = None,
) -> TemporalGraph:
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    t = np.asarray(t, dtype=np.int64)
    if t.size and t.min() < 0:
        raise ValueError("timestamps must be non-negative")
    if amount is None:
        amount = np.ones_like(src, dtype=np.float32)
    amount = np.asarray(amount, dtype=np.float32)
    e = src.shape[0]
    if n_nodes is None:
        n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    t_max = int(t.max(initial=0))
    key_scale = t_max + 2  # key = nbr*key_scale + (t+1); t+1 in [1, t_max+1]
    if n_nodes * key_scale >= 2**62:
        raise ValueError("composite key overflow; rescale timestamps")

    (o_indptr, o_nbr, o_key, o_t, o_eid, o_ts, o_eid_t) = _csr_from_edges(
        src, dst, t, n_nodes, key_scale
    )
    (i_indptr, i_nbr, i_key, i_t, i_eid, i_ts, i_eid_t) = _csr_from_edges(
        dst, src, t, n_nodes, key_scale
    )
    return TemporalGraph(
        n_nodes=n_nodes,
        n_edges=e,
        src=src,
        dst=dst,
        t=t,
        amount=amount,
        out_indptr=o_indptr,
        out_nbr=o_nbr,
        out_key=o_key,
        out_t=o_t,
        out_eid=o_eid,
        out_t_sorted=o_ts,
        out_eid_t=o_eid_t,
        in_indptr=i_indptr,
        in_nbr=i_nbr,
        in_key=i_key,
        in_t=i_t,
        in_eid=i_eid,
        in_t_sorted=i_ts,
        in_eid_t=i_eid_t,
        key_scale=key_scale,
        t_max=t_max,
    )
