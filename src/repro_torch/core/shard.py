"""Multi-device sharded mining executor, in torch (the port of the JAX
package's ``repro.core.shard``).

Pattern counts are per-seed-edge, so mining is embarrassingly
data-parallel once the partitioner (:mod:`repro_torch.graph.partition`)
has balanced expected cost: each partition of the dense ``(P, L)`` edge-id
matrix is an independent mine.  This module runs those mines on a list of
devices with **explicit placement** (per-partition bucket schedules are
ragged, so each shard dispatches its own launches onto its own device):

* **One graph replica per device** (:class:`ShardContext`): the session's
  :class:`~repro_torch.graph.csr.DeviceGraph` serves its own device; any
  other device gets a copy, built once on first use (double-checked
  locking) and kept for the context's lifetime.  Partitions are assigned
  round-robin, so ``n_parts`` may exceed the device count (extra
  partitions time-share a device), and with one device the executor
  degrades to exactly the resident asynchronous behaviour.
* **Overlapped dispatch, one thread per device**: :func:`run_sharded`
  fans partitions out to a per-device dispatch pool, each worker inside
  ``torch.cuda.device(device)``; shard ``k``'s host-side schedule build and
  staging overlap with device execution of the shards already dispatched.
  The schedule LRU, the requirement cache, the kernel-callable caches and
  the kernels' launch counts are lock-protected for exactly this.
* **One host sync per mine, in either gather mode.**  Every partition's
  launches scatter-add into an accumulator on its own device.  When the
  partitions map 1:1 onto devices, each shard's ragged outputs are
  scattered into full-length rows on its device (:func:`_place_rows`
  through the plan's ``positions``), flattened into one row per shard,
  and :func:`collective_gather` sums the rows on the first device
  (non-blocking device-to-device copies, one sum) before ONE
  :func:`repro_torch.device.to_host`.  Time-shared runs
  (``n_parts > n_devices``) and empty mines use the host :func:`gather`:
  every shard's outputs in one device→host copy.

On a machine with one card, every sharded mine runs the inline dispatch
on that card; the dispatch pool and replicas on other devices run on the
CPU lanes of :func:`repro_torch.launch.mesh.ensure_host_devices`, which
share the one CPU device and replica under distinct names.

Per-shard observability: :func:`run_sharded` returns a :class:`ShardRun`
carrying one executor stat dict, dispatch wall and device name per shard,
plus ``dispatch_wall_s``, the true overlapped dispatch window.  Per-shard
walls are measured on concurrent threads, so they do NOT sum to the mine
wall; their sum divided by ``dispatch_wall_s`` is the dispatch overlap
ratio.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import executor
from repro_torch.device import DeviceLike, h2d, resolve_device, to_host
from repro_torch.distributed.fault_tolerance import Heartbeat, StragglerMonitor
from repro_torch.graph.partition import PartitionPlan
from repro_torch.launch import mesh
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = [
    "ShardContext",
    "ShardRun",
    "mining_devices",
    "run_sharded",
    "gather",
    "collective_gather",
]


def mining_devices(n: Optional[int] = None, device: DeviceLike = None) -> List[torch.device]:
    """The devices a sharded mine runs over, of ``device``'s kind (the CUDA
    card by default): every visible card, or on the CPU the lanes of
    :func:`repro_torch.launch.mesh.ensure_host_devices`; the first ``n`` of
    them when ``n`` is given (all when it exceeds the count)."""
    kind = resolve_device(device).type
    if kind == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu", i) for i in range(mesh.host_lanes())]
    if n is None or n >= len(devs):
        return devs
    return devs[: max(1, n)]


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether tensors on ``b`` already live on ``a`` (every CPU lane is
    the one CPU device; a CUDA card is its index)."""
    if a.type != b.type:
        return False
    return a.type == "cpu" or (a.index or 0) == (b.index or 0)


def _on_device(device: torch.device):
    """The context a worker dispatches in: the card's, or none on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class ShardContext:
    """Per-device graph replicas + dispatch pool for one resident
    :class:`~repro_torch.graph.csr.DeviceGraph`.

    Replication is lazy and cached: a device's replica is built on its
    first partition and reused for every later mine, so steady-state
    sharded mines move only staging buffers.  On the device that already
    holds the source mirror (and on every CPU lane) the replica IS the
    mirror.  The dispatch pool (one worker per device) is lazy too and
    lives for the context's lifetime; concurrent ``replica`` misses from
    its workers are double-check locked.
    """

    def __init__(
        self,
        dg,
        devices: Optional[Sequence] = None,
        heartbeat_dir: Optional[str] = None,
    ):
        self.dg = dg
        self.devices = (
            [torch.device(d) for d in devices]
            if devices is not None
            else mining_devices(device=dg.device)
        )
        if not self.devices:
            raise ValueError("no devices available for sharded mining")
        self._replicas: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        # per-device worker liveness: every dispatch beats in memory
        # (last_beat) and, when heartbeat_dir is set, through the
        # file-backed distributed.fault_tolerance.Heartbeat tracker
        self.heartbeat_dir = heartbeat_dir
        self.last_beat: Dict[str, float] = {}
        self.beat_steps: Dict[str, int] = {}
        self._heartbeats: Dict[str, Heartbeat] = {}
        self.stragglers = StragglerMonitor()

    def beat(self, device, shard: int) -> None:
        """Record liveness of ``device``'s dispatch worker at ``shard``.
        Every beat also lands as a pair of ``repro_torch.obs`` gauge
        samples (last-beat instant + cumulative beats, labeled by device),
        so a scrape of the metrics registry sees worker liveness without
        touching ``MiningResult.worker_liveness``."""
        key = str(device)
        self.last_beat[key] = time.time()
        self.beat_steps[key] = self.beat_steps.get(key, 0) + 1
        reg = obs_metrics.get_registry()
        reg.gauge(
            "repro_shard_worker_last_beat_seconds",
            help="unix time of the device dispatch worker's last beat",
            labels={"device": key},
        ).set(self.last_beat[key])
        reg.gauge(
            "repro_shard_worker_beats",
            help="cumulative dispatch-worker liveness beats",
            labels={"device": key},
        ).set(self.beat_steps[key])
        if self.heartbeat_dir is not None:
            hb = self._heartbeats.get(key)
            if hb is None:
                with self._lock:
                    hb = self._heartbeats.get(key)
                    if hb is None:
                        hb = Heartbeat(self.heartbeat_dir, key)
                        self._heartbeats[key] = hb
            hb.beat(shard)

    def alive_devices(self) -> Optional[List[str]]:
        """File-backed liveness view (None without a heartbeat_dir)."""
        if self.heartbeat_dir is None or not self._heartbeats:
            return None
        return next(iter(self._heartbeats.values())).alive_hosts()

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def device_for(self, p: int) -> torch.device:
        """Round-robin partition -> device assignment."""
        return self.devices[p % len(self.devices)]

    def replica(self, device):
        """The graph replica resident on ``device`` (built on first use;
        safe to race from concurrent dispatch workers)."""
        device = torch.device(device)
        if _same_device(device, self.dg.device):
            return self.dg
        key = str(device)
        r = self._replicas.get(key)
        if r is None:
            with self._lock:
                r = self._replicas.get(key)
                if r is None:
                    with _on_device(device):
                        r = dataclasses.replace(
                            self.dg,
                            **{
                                f.name: getattr(self.dg, f.name).to(device, non_blocking=True)
                                for f in dataclasses.fields(self.dg)
                                if isinstance(getattr(self.dg, f.name), torch.Tensor)
                            },
                        )
                    self._replicas[key] = r
        return r

    def pool(self) -> ThreadPoolExecutor:
        """The dispatch pool (lazy): one worker per device, capped at the
        host CPU count (schedule build + staging is CPU-bound Python, so
        workers beyond the cores only add GIL contention)."""
        if self._pool is None:
            with self._lock:
                if self._pool is None:
                    try:
                        n_cpus = len(os.sched_getaffinity(0))
                    except AttributeError:  # non-Linux
                        n_cpus = os.cpu_count() or 1
                    self._pool = ThreadPoolExecutor(
                        max_workers=max(1, min(len(self.devices), n_cpus)),
                        thread_name_prefix="shard-dispatch",
                    )
        return self._pool


@dataclasses.dataclass
class ShardRun:
    """One sharded dispatch+gather, with per-shard observability.

    ``host_outs`` depends on the gather mode: the per-shard list of host
    output dicts under ``gather_mode == "host"``, or the single
    already-reduced output dict (full-length rows, every shard summed in)
    under ``gather_mode == "collective"``.  ``shard_walls`` are per-shard
    dispatch walls measured on concurrent worker threads; they overlap
    and do NOT sum to ``dispatch_wall_s``, the true wall-clock window of
    the whole overlapped dispatch phase.
    """

    host_outs: object
    shard_stats: List[Dict[str, int]]
    shard_walls: List[float]
    shard_devices: List[str]
    dispatch_wall_s: float
    gather_mode: str  # "collective" | "host"
    # per-device worker liveness for this run: last heartbeat instant,
    # cumulative beats, per-device wall medians, and the devices the
    # StragglerMonitor flags slower than threshold x median
    worker_liveness: Optional[dict] = None


def _place_rows(vec: torch.Tensor, rows: torch.Tensor, n_total: int) -> torch.Tensor:
    """One shard's ragged per-seed outputs scattered into full-length rows
    on the shard's device: slot i of the shard holds input position
    ``rows[i]``.  Positions are a bijection over input indices (duplicate
    seed *ids* occupy distinct positions), so rows never collide within or
    across shards and the cross-shard sum of placed rows is exact
    reassembly.  ``vec`` may carry ladder padding past ``len(rows)`` (the
    fused unit matrix); the leading slice drops it.  The reference's
    ``mode="drop"`` is spelled out: an out-of-range row is masked to a
    zero add at row 0 (``torch.where``, no boolean index, no sync)."""
    out = torch.zeros((n_total,) + tuple(vec.shape[1:]), dtype=vec.dtype, device=vec.device)
    val = vec[: rows.shape[0]]
    keep = (rows >= 0) & (rows < n_total)
    keep_v = keep.reshape((-1,) + (1,) * (val.dim() - 1))
    out.index_add_(0, torch.where(keep, rows, 0), torch.where(keep_v, val, 0))
    return out


def _flatten_outs(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """One shard's output leaves raveled into one flat row on its device,
    so the whole cross-shard reduction is ONE sum over ONE stack, not one
    per output key."""
    return torch.cat([x.reshape(-1) for x in leaves])


Outs = Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]


def gather(outs: Outs, stats: Dict[str, int], mode: str = "host"):
    """One blocking device→host copy of finished device tensors (one
    dtype) — the single host sync of whatever dispatched them.

    ``outs`` is a dict of tensors, or a list of such dicts (one per shard
    of a sharded mine, possibly on different devices); the same structure
    comes back with numpy views of the one host buffer.  Every leaf is
    flattened, moved to the first leaf's device with non-blocking
    device-to-device copies, concatenated, and fetched with one
    :func:`repro_torch.device.to_host`.

    The host fallback of a sharded mine (time-shared ``n_parts >
    n_devices``) passes the per-shard list; the streaming service's
    portfolio tick passes one dict with EVERY pattern's count vector
    (``mode="portfolio"`` tags the span so trace tooling can tell them
    apart)."""
    tree = outs if isinstance(outs, list) else [outs]
    leaves = [x for d in tree for x in d.values()]
    dtypes = {x.dtype for x in leaves}
    if len(dtypes) > 1:
        raise TypeError(f"gather needs one dtype across outputs; got {dtypes}")
    with obs_trace.span("gather", stats=stats, mode=mode):
        flat = None
        if leaves:
            dev0 = leaves[0].device
            flat = to_host(torch.cat([x.reshape(-1).to(dev0, non_blocking=True) for x in leaves]))
        stats["host_syncs"] += 1
        stats["bytes_d2h"] += int(sum(x.numel() * x.element_size() for x in leaves))
    host = []
    off = 0
    for d in tree:
        h = {}
        for name, x in d.items():
            h[name] = flat[off : off + x.numel()].reshape(tuple(x.shape))
            off += x.numel()
        host.append(h)
    return host if isinstance(outs, list) else host[0]


def collective_gather(placed: List[Dict[str, torch.Tensor]], devices, stats: Dict[str, int]):
    """Device-side gather: reduce per-shard placed rows on the device, then
    fetch the finished result with ONE blocking transfer.

    ``placed[p]`` is shard ``p``'s output dict with every leaf already
    scattered into full-length rows on ``devices[p]`` (disjoint rows per
    shard).  Each shard's leaves are raveled on its device into one flat
    row (:func:`_flatten_outs`); the rows come to the first device of the
    shard mesh (:func:`repro_torch.launch.mesh.make_shard_mesh`) by
    non-blocking device-to-device copies, and ONE int32 sum over their
    stack reduces every output of every pattern at once.  The one
    :func:`~repro_torch.device.to_host` of the reduced flat vector is the
    mine's host sync, and ``bytes_d2h`` counts only that vector; the split
    back into the output dict is numpy views."""
    with obs_trace.span("gather", stats=stats, mode="collective", n_shards=len(placed)):
        keys = list(placed[0])
        shapes = [tuple(placed[0][k].shape) for k in keys]
        dev0 = mesh.make_shard_mesh(devices)[0]
        rows = [_flatten_outs([p_out[k] for k in keys]).to(dev0, non_blocking=True) for p_out in placed]
        total = rows[0] if len(rows) == 1 else torch.stack(rows).sum(dim=0, dtype=rows[0].dtype)
        host_flat = to_host(total)  # THE host sync
        stats["host_syncs"] += 1
        stats["bytes_d2h"] += int(host_flat.nbytes)
    host = {}
    off = 0
    for k, shape in zip(keys, shapes):
        n = int(np.prod(shape))
        host[k] = host_flat[off : off + n].reshape(shape)
        off += n
    return host


def run_sharded(
    plan: PartitionPlan,
    launch: Callable,
    ctx: ShardContext,
    stats: Dict[str, int],
    collective: Optional[bool] = None,
) -> ShardRun:
    """Dispatch every partition of ``plan`` concurrently and gather once.

    ``launch(p, ids, dg, device, shard_stats)`` must dispatch partition
    ``p``'s work (seed edge ids ``ids``) onto ``device`` using the graph
    replica ``dg`` and return a dict of **device-resident** tensors; it
    must not block on the device (no ``.item()``, no ``.cpu()``; use
    ``CompiledPattern.mine_async`` and ``_FusedSeedPlan.launch_units``).
    It runs on a dispatch-pool worker thread, inside
    ``torch.cuda.device(device)`` on a card.

    Dispatch is one worker per *device*: partition ``p`` goes to device
    ``p % n_devices``, and each device's partitions run in submission
    order on its worker, while different devices' schedule builds and
    launches overlap.  A single in-use device skips the pool (inline
    dispatch, exactly the resident asynchronous behaviour).

    Gather: collective when every partition has its own device
    (``n_parts <= n_devices``) and the mine is not empty, else the host
    :func:`gather`; ``collective`` forces the choice (tests).  Both charge
    exactly ONE ``host_syncs``.  Every shard's counters are summed into
    ``stats`` (``host_syncs`` and ``bytes_d2h`` belong to the gather)."""
    n_parts = plan.n_parts
    n_total = int(plan.valid.sum())
    if collective is None:
        collective = n_parts <= ctx.n_devices and n_total > 0
    shard_stats = [executor.new_stats() for _ in range(n_parts)]
    shard_walls = [0.0] * n_parts
    shard_devices = [""] * n_parts
    outs: List = [None] * n_parts

    def dispatch_one(p: int) -> None:
        ids = plan.edge_ids[p][plan.valid[p]]
        device = ctx.device_for(p)
        st = shard_stats[p]
        ctx.beat(device, p)  # liveness: worker picked up shard p
        t0 = time.perf_counter()
        # the span runs ON the worker thread: it times DISPATCH (schedule
        # build + staging + asynchronous launches), not device completion
        with _on_device(device):
            with obs_trace.span(
                f"dispatch:shard{p}", stats=st, device=str(device), n_seeds=len(ids)
            ):
                out = launch(p, ids, ctx.replica(device), device, st)
            if collective:
                # this shard's ragged outputs into full-length rows on its
                # own device, still without blocking
                rows = np.ascontiguousarray(plan.positions[p][plan.valid[p]])
                if rows.size:
                    rows_dev = h2d(rows, ctx.replica(device).device)
                    st["bytes_h2d"] += int(rows.nbytes)
                    out = {k: _place_rows(v, rows_dev, n_total) for k, v in out.items()}
                else:  # an empty shard's zero rows, made on its own device
                    out = {
                        k: torch.zeros((n_total,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
                        for k, v in out.items()
                    }
        outs[p] = out
        shard_walls[p] = time.perf_counter() - t0
        shard_devices[p] = str(device)
        ctx.beat(device, p)  # liveness: shard p dispatched
        ctx.stragglers.record(str(device), shard_walls[p])

    n_used = min(n_parts, ctx.n_devices)
    t0 = time.perf_counter()
    if n_used <= 1:
        for p in range(n_parts):
            dispatch_one(p)
    else:

        def worker(d: int) -> None:
            for p in range(d, n_parts, ctx.n_devices):
                dispatch_one(p)

        pool = ctx.pool()
        futures = [pool.submit(worker, d) for d in range(n_used)]
        for f in futures:
            f.result()  # propagate worker exceptions
    dispatch_wall = time.perf_counter() - t0

    if collective:
        host_outs = collective_gather(outs, [ctx.device_for(p) for p in range(n_parts)], stats)
        mode = "collective"
    else:
        host_outs = gather(outs, stats)
        mode = "host"
    for st in shard_stats:
        for k in executor.STAT_KEYS:
            if k in ("host_syncs", "bytes_d2h"):
                continue  # per-shard launches never sync; the gather paid
            stats[k] += st[k]
    used = sorted({d for d in shard_devices if d})
    liveness = {
        "last_beat": {d: ctx.last_beat.get(d) for d in used},
        "beats": {d: ctx.beat_steps.get(d, 0) for d in used},
        "wall_medians": {d: m for d, m in ctx.stragglers.medians().items() if d in used},
        "stragglers": [d for d in ctx.stragglers.stragglers() if d in used],
        "alive": ctx.alive_devices(),
    }
    return ShardRun(
        host_outs=host_outs,
        shard_stats=shard_stats,
        shard_walls=shard_walls,
        shard_devices=shard_devices,
        dispatch_wall_s=dispatch_wall,
        gather_mode=mode,
        worker_liveness=liveness,
    )
