"""Trace capture: record a ``repro_torch.obs`` Chrome trace of one sharded
8-part mine and a short streaming run, ready to open in Perfetto (the
port of the JAX package's ``examples/trace_capture.py``).

  PYTHONPATH=src python -m repro_torch.examples.trace_capture
  PYTHONPATH=src python -m repro_torch.examples.trace_capture --scale 0.1 --out-dir /tmp/traces --device cpu

Flags: ``--scale`` (0.2) and ``--out-dir`` (``traces``) as the script's;
``--device`` (``cpu``; the CUDA card when left out).

The script forces 8 virtual JAX devices.  Here
:func:`repro_torch.launch.mesh.ensure_host_devices` asks for 8: on the
CPU that is 8 CPU lanes (the lane count is set back when the run ends),
on the card the visible cards, which the 8 parts then share.

Open the resulting ``*.trace.json`` at https://ui.perfetto.dev (or
``chrome://tracing``): pid/tid lanes show the dispatch pool's overlap,
``dispatch:shard{k}`` spans carry per-shard counter deltas in their
args, and the streaming file nests ``tick:ingest/plan/mine/score``
under each ``tick``.
"""
from __future__ import annotations

import argparse
import collections
import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["W", "N_PARTS", "TICKS", "run", "main"]

W = 4096
N_PARTS = 8
TICKS = 6


def run(ds, out_dir: str = "traces", device=None) -> dict:
    """The sharded mine and the streaming ticks over the dataset ``ds``,
    traced and printed as the script prints them; the two traces land in
    ``out_dir``.  Returns the printed numbers (each part's counters and
    span counts, the tick reports, the summary and the exposition), the
    trace paths, and each trace's span-name counts (``span_names``)."""
    from repro_torch.api import MiningSession
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import ensure_host_devices, host_lanes
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.stream import DetectionService

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    lanes = host_lanes()
    ensure_host_devices(N_PARTS, device)
    tracer = obs_trace.get_tracer()
    out = {"span_names": {}, "paths": {}}

    def names():
        return dict(collections.Counter(ev["name"] for ev in tracer.spans()))

    try:
        # 1. one sharded mine in 8 parts: spans schedule_build -> stage /
        # launch per shard under dispatch:shard{k}, then the single
        # blocking gather
        session = MiningSession(ds.graph, window=W, device=device)
        session.register("scatter_gather", "fan_in", "fan_out", "cycle3")
        session.mine()  # warm untraced so the traced mine shows steady state
        obs_trace.enable()
        res = session.mine(backend="sharded", n_parts=N_PARTS)
        obs_trace.disable()
        path = os.path.join(out_dir, "sharded_mine.trace.json")
        tracer.export_chrome(path)
        n_spans = len(tracer.spans())
        print(f"sharded mine: {res.stats['kernel_calls']} kernel calls, "
              f"host_syncs={res.stats['host_syncs']}, "
              f"{n_spans} spans -> {path}")
        summary = tracer.summary()
        print(summary)
        out.update({"sharded_kernel_calls": int(res.stats["kernel_calls"]),
                    "sharded_host_syncs": int(res.stats["host_syncs"]), "sharded_spans": n_spans,
                    "sharded_summary": summary, "sharded_counts": res.counts})
        out["span_names"]["sharded_mine"] = names()
        out["paths"]["sharded_mine"] = path
        tracer.reset()

        # 2. a few streaming ticks: spans tick -> tick:ingest / tick:plan /
        # tick:mine / tick:score, with executor-counter deltas attributed
        # to the mine span of each tick
        svc = DetectionService(["fan_in", "cycle3"], window=W, device=device)
        g, order = ds.graph, np.argsort(ds.graph.t, kind="stable")
        ticks = []
        obs_trace.enable()
        for ch in np.array_split(order, TICKS):
            batch = svc.submit(g.src[ch], g.dst[ch], g.t[ch], g.amount[ch])
            r = batch.report
            print(f"tick {r.tick}: path={r.path} span_id={r.span_id} "
                  f"trace_misses={r.trace_misses} {r.seconds*1e3:.0f}ms")
            ticks.append({"tick": r.tick, "path": r.path, "span_id": r.span_id, "trace_misses": r.trace_misses,
                          "seconds": r.seconds, "n_alerts": len(batch), "kernel_calls": r.stats["kernel_calls"]})
        obs_trace.disable()
        path = os.path.join(out_dir, "streaming.trace.json")
        tracer.export_chrome(path)
        n_spans = len(tracer.spans())
        print(f"streaming: {n_spans} spans -> {path}")
        out.update({"ticks": ticks, "streaming_spans": n_spans})
        out["span_names"]["streaming"] = names()
        out["paths"]["streaming"] = path
        tracer.reset()

        # the same run also populated the metrics registry (tick latency
        # histogram, executor/store counters), Prometheus-style text
        exposition = obs_metrics.get_registry().exposition()
        print(exposition)
        out["exposition"] = exposition
    finally:
        obs_trace.disable()
        if device.type == "cpu":
            ensure_host_devices(lanes, device)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from repro_torch.data import generate_aml_dataset
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.2, help="dataset scale factor")
    ap.add_argument("--out-dir", default="traces", help="where the trace JSONs land")
    ap.add_argument("--device", default=None, help="cpu; the CUDA card when left out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ds = generate_aml_dataset("HI-Small", seed=0, scale=args.scale)
    return run(ds, out_dir=args.out_dir, device=device)


if __name__ == "__main__":
    main()
