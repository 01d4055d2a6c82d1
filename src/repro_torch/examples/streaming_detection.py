"""Real-time AML detection end to end: a synthetic transaction feed is
microbatched into a ``repro_torch.stream.DetectionService``, which
incrementally re-mines only each batch's dirty frontier (per-pattern
hop/time radii from the stage-graph IR), scores the re-mined seeds through
the ``repro_torch.ml`` feature layout, applies per-pattern thresholds, and
emits scored alerts plus the executor/store counter glossary per tick
(the port of the JAX package's ``examples/streaming_detection.py``).

  PYTHONPATH=src python -m repro_torch.examples.streaming_detection
  PYTHONPATH=src python -m repro_torch.examples.streaming_detection --scale 1.0 --batches 12
  PYTHONPATH=src python -m repro_torch.examples.streaming_detection --scale 0.1 --batches 4 --device cpu

Flags: ``--scale`` (0.3), ``--batches`` (8) and ``--window`` (4096) as the
script's; ``--device`` (``cpu``; the CUDA card when left out).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

__all__ = ["THRESHOLDS", "run", "main"]

THRESHOLDS = {"cycle3": 1, "scatter_gather": 1, "fan_in": 6}


def run(g, batches: int = 8, window: int = 4096, device=None) -> dict:
    """Feed the graph ``g``'s transactions in time order, in ``batches``
    microbatches, through the service, printed as the script prints them.
    Returns the printed numbers: ``ticks`` (each tick's report fields and
    counters, its alert count, every alert as ``(eid, src, dst, t,
    patterns)`` and the alerts' scores), ``total_alerts``,
    ``n_transactions``, ``totals`` and ``cycle3_equal``; and for checks
    ``counts`` (each pattern's counts of the live edges)."""
    from repro_torch.api import MiningSession

    order = np.argsort(g.t, kind="stable")  # the feed arrives in time order

    # the same portfolio session API as batch mining; thresholds make the
    # service alert (patterns without one contribute features only; a
    # fitted repro_torch.ml GBDTClassifier.predict_proba plugs in as
    # scorer= to rank alerts with a trained model over svc.feature_columns)
    session = MiningSession(window=window, device=device)
    session.register("fan_in", "cycle3", "scatter_gather")
    svc = session.service(thresholds=dict(THRESHOLDS))
    radii = {n: (svc.scheduler.radius[n], svc.scheduler.time_radius[n]) for n in svc.pattern_names}
    print("portfolio:", ", ".join(svc.pattern_names))
    print("feature columns:", ", ".join(svc.feature_columns))
    print("per-pattern dirty radii:", radii)

    total_alerts = 0
    ticks = []
    for ch in np.array_split(order, batches):
        batch = svc.submit(g.src[ch], g.dst[ch], g.t[ch], g.amount[ch])
        rep = batch.report
        total_alerts += len(batch)
        print(
            f"tick {rep.tick}: +{rep.n_new} tx, {rep.n_live} live | "
            f"dirty {rep.n_dirty} ({rep.dirty_fraction:.1%}, path={rep.path}) | "
            f"view {rep.view_nodes}n/{rep.view_edges}e | "
            f"{len(batch)} alerts | "
            f"launches={rep.stats['kernel_calls']} "
            f"syncs={rep.stats['host_syncs']} "
            f"merges={rep.store['run_merges']} "
            f"moved={rep.store['maint_moved']} | "
            f"{rep.seconds*1e3:.0f}ms"
        )
        rows = batch.to_rows()
        for row in batch.top(3).to_rows():
            print(
                f"    ALERT score={row['score']:.2f} "
                f"tx {row['src']}->{row['dst']} @t={row['t']} "
                f"amount={row['amount']:.0f} patterns={','.join(row['patterns'])}"
            )
        ticks.append({
            "tick": rep.tick, "n_new": rep.n_new, "n_live": rep.n_live, "n_dirty": rep.n_dirty,
            "dirty_fraction": rep.dirty_fraction, "path": rep.path, "view_nodes": rep.view_nodes,
            "view_edges": rep.view_edges, "n_alerts": len(batch), "kernel_calls": rep.stats["kernel_calls"],
            "host_syncs": rep.stats["host_syncs"], "run_merges": rep.store["run_merges"],
            "maint_moved": rep.store["maint_moved"], "seconds": rep.seconds,
            "alerts": [(r["eid"], r["src"], r["dst"], r["t"], tuple(r["patterns"])) for r in rows],
            "scores": [r["score"] for r in rows],
        })

    totals = {n: int(svc.pattern_counts(n).sum()) for n in svc.pattern_names}
    print(f"\n{total_alerts} alerts over {svc.store.n_edges_total} transactions")
    print("final per-pattern instance totals:", totals)

    # the incremental counts equal a batch recompute on the full graph
    # (tests/test_torch_stream_service.py holds every pattern to it bit
    # for bit; here one pattern is spot-checked)
    live = svc.store.live_eids()
    want = svc.recompute_counts("cycle3")
    got = svc.pattern_counts("cycle3")[live]
    assert np.array_equal(got, want), "incremental != batch recompute"
    print("cycle3 incremental == batch recompute: OK")
    return {
        "pattern_names": list(svc.pattern_names),
        "feature_columns": list(svc.feature_columns),
        "radii": radii,
        "ticks": ticks,
        "total_alerts": total_alerts,
        "n_transactions": int(svc.store.n_edges_total),
        "totals": totals,
        "cycle3_equal": True,
        "counts": {n: svc.pattern_counts(n)[live] for n in svc.pattern_names},
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from repro_torch.data import generate_aml_dataset
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.3)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--device", default=None, help="cpu; the CUDA card when left out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ds = generate_aml_dataset("HI-Small", seed=3, scale=args.scale)
    return run(ds.graph, batches=args.batches, window=args.window, device=device)


if __name__ == "__main__":
    main()
