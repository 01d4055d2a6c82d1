"""Distributed mining launcher: degree-balanced edge partitions
dispatched across the mining devices (the port of the JAX package's
``repro.launch.mine``).

Per-partition counts are independent (pattern counts are per-seed-edge),
so the only cross-device communication is the final gather of finished
per-shard counts.  The default ``--backend sharded`` runs the multi-device
executor (:mod:`repro_torch.core.shard`): every partition's launches land
on its own device with a per-device resident accumulator and exactly one
blocking host sync per mine.  ``--devices`` asks for that many cards
(fewer when fewer are visible: the launcher degrades to them) or, under
``--device cpu``, for that many CPU lanes
(:func:`repro_torch.launch.mesh.ensure_host_devices`).
``--backend partitioned`` keeps the sequential single-device loop for
comparison.

Mining goes through a portfolio :class:`repro_torch.api.MiningSession`,
so every partition reuses one compiled plan set (shared kernel callables,
graph replicas and requirement cache).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.mine --dataset HI-Small \\
      --pattern scatter_gather --window 4096 --parts 4 --devices 4
  PYTHONPATH=src python -m repro_torch.launch.mine --device cpu --scale 0.05
"""
from __future__ import annotations

import argparse
import time

import numpy as np

__all__ = ["mine_partitioned", "main"]


def mine_partitioned(
    graph, spec_name: str, window: int, n_parts: int, backend: str = "sharded", device=None
):
    """Partition edges by cost, mine each partition, reassemble.

    ``backend="sharded"`` dispatches each partition to its own device
    (round-robin when ``n_parts`` exceeds the device count) and reports
    per-shard dispatch walls, devices, and the predicted-vs-achieved load
    balance; ``backend="partitioned"`` runs the partitions sequentially on
    one device and reports per-partition wall times.  ``device`` places
    the session (the CUDA card by default).

    Returns ``(counts, plan, timing)`` where ``timing`` holds the
    per-partition/per-shard measurements plus the one-off warm-up time.
    The warm-up mine runs BEFORE the timed one, so that the first
    partition's wall does not absorb the first launches' set-up."""
    from repro_torch.api import MiningSession

    session = MiningSession(graph, window=window, device=device).register(spec_name)
    t0 = time.perf_counter()
    session.mine([spec_name])  # warm-up
    warmup_s = time.perf_counter() - t0
    res = session.mine([spec_name], backend=backend, n_parts=n_parts)
    counts = np.asarray(res.column(spec_name), dtype=np.int64)
    if backend == "sharded":
        timing = {
            # per-shard walls run on CONCURRENT dispatch threads: they
            # overlap and do not sum to the mine wall; dispatch_wall_s is
            # the true window, overlap_ratio = sum(per_part) / window
            "per_part": res.per_shard_seconds,
            "dispatch_wall_s": res.dispatch_wall_s,
            "overlap_ratio": res.dispatch_overlap_ratio(),
            "gather_mode": res.gather_mode,
            "warmup_s": warmup_s,
            "devices": list(res.shard_devices),
            "balance": res.shard_balance(),
            "host_syncs": res.stats["host_syncs"],
        }
    else:
        timing = {"per_part": res.per_part_seconds, "warmup_s": warmup_s}
    return counts, res.partition_plan, timing


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="HI-Small")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--pattern", default="scatter_gather")
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--backend", default="sharded", choices=("sharded", "partitioned"))
    ap.add_argument(
        "--devices",
        type=int,
        default=0,
        help="mining devices to ask for (0 = --parts for sharded): cards, "
        "or CPU lanes under --device cpu",
    )
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.backend == "sharded":
        from repro_torch.launch.mesh import ensure_host_devices

        want = args.devices or args.parts
        got = ensure_host_devices(want, device=args.device)
        if got < want:
            print(f"# requested {want} devices, got {got} (degrading)")

    from repro_torch.core.patterns import PATTERN_NAMES
    from repro_torch.data.synth_aml import load_dataset

    if args.pattern not in PATTERN_NAMES:
        ap.error(f"unknown pattern {args.pattern!r}; options: {PATTERN_NAMES}")

    ds = load_dataset(args.dataset, scale=args.scale)
    counts, plan, timing = mine_partitioned(
        ds.graph, args.pattern, args.window, args.parts, backend=args.backend, device=args.device
    )
    line = (
        f"{args.pattern} on {ds.name} [{args.backend}]: {counts.sum()} "
        f"instances over {ds.graph.n_edges} edges; partition cost skew "
        f"{plan.skew:.3f}; warm-up {timing['warmup_s']:.2f}s"
    )
    if args.backend == "sharded":
        # per-shard walls overlap on concurrent dispatch threads: report
        # the true window and the overlap, never a per-part "sum"
        bal = timing["balance"]
        line += (
            f"; dispatch window {timing['dispatch_wall_s']:.2f}s "
            f"(overlap {timing['overlap_ratio']:.2f}x across "
            f"{len(timing['per_part'])} shards; per-shard walls "
            f"{[f'{t:.2f}s' for t in timing['per_part']]} are concurrent, "
            f"not additive); gather {timing['gather_mode']}; "
            f"devices {timing['devices']}; host_syncs {timing['host_syncs']}; "
            f"achieved kernel-call skew {bal['kernel_call_skew']:.3f} "
            f"(predicted {bal['predicted_cost_skew']:.3f})"
        )
    else:
        line += f"; steady wall per part: {[f'{t:.2f}s' for t in timing['per_part']]}"
    print(line)
    return counts, plan, timing


if __name__ == "__main__":
    main()
