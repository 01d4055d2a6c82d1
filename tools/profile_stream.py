#!/usr/bin/env python3
"""Where the PyTorch port's streaming detection service spends its time.

    python3 tools/profile_stream.py --scale 282   # needs one CUDA card
    python3 tools/profile_stream.py --cpu-twin --no-profile

Streams the feed of ``chip_smoke.py`` phase 11 (HI-Small in time order: a
first tick of 65,536 transactions, then 48 ticks of 8,192) through a
pipelined ``DetectionService`` over the 9-pattern ``"full"`` portfolio,
twice, and reports on the card it runs on:

1. a plain run: each tick's wall and its ``ingest``/``plan``/``mine``/
   ``score`` stages, and the launch shapes (the JAX package's trace keys)
   each tick's dispatch minted, by pattern;
2. the same stream under ``torch.profiler``: the device's busy share of
   the ticks' wall (kernel time over wall; one stream, so kernels do not
   overlap), the top CUDA kernels by device time, and the
   ``intersect_count`` and ``window_search`` kernels' own device time and
   launches over the stream (``--no-profile`` leaves this part out);
3. with ``--cpu-twin``, part 1 again with the service on the CPU (the
   port's CPU service, whose ``TickReport.stats`` the parity tests hold
   equal to the JAX package's): it fails unless the CPU run mints the same
   launch shapes at the same ticks, with the same ``jit_cache_entries``
   after every tick, the same alerts and the same final counts as the card.

``--src`` streams with another checkout's ``src`` (a parent unpacked
under ``build/``), so two commits read the same numbers in one call.

Prints one JSON object per part and writes them to ``--out`` (default
``build/profile_stream.json``).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOP = 15  # kernels kept in the ranking


def stream(svc, g, chunks, on_tick=None):
    """Feed every chunk, flush, and return (walls, committed batches)."""
    walls, batches = [], []
    for ch in chunks:
        t0 = time.perf_counter()
        b = svc.submit(g.src[ch], g.dst[ch], g.t[ch], g.amount[ch])
        walls.append(time.perf_counter() - t0)
        if on_tick is not None:
            on_tick(svc)
        if b is not None:
            batches.append(b)
    t0 = time.perf_counter()
    batches += svc.flush()
    walls[-1] += time.perf_counter() - t0
    return walls, batches


def plain_run(session, g, chunks, kw):
    """Part 1: walls, stages and the launch shapes each tick minted.
    Returns the part's record, the committed batches and the service."""
    import numpy as np

    svc = session.service(**kw)
    seen = {n: set() for n in svc.pattern_names}
    minted, jit = [], []

    def on_tick(s):
        fresh = {}
        for n, keys in s._trace_keys.items():
            new = keys - seen[n]
            if new:
                fresh[n] = sorted(str(k) for k in new)
                seen[n] |= new
        minted.append({"tick": s.tick, "new_keys": fresh})
        jit.append(s.stats["jit_cache_entries"])

    walls, batches = stream(svc, g, chunks, on_tick)
    reps = [b.report for b in batches]
    part = {
        "device": str(svc.device),
        "ticks": len(walls),
        "tick_ms": [w * 1e3 for w in walls],
        "tick_ms_p50_after_first": float(np.percentile(walls[1:], 50) * 1e3),
        "stage_ms": {s: [getattr(r, s) for r in reps] for s in ("ingest_ms", "plan_ms", "mine_ms", "score_ms")},
        "paths": [r.path for r in reps],
        "dirty": [r.n_dirty for r in reps],
        "view_edges": [r.view_edges for r in reps],
        "jit_cache_entries_by_submit": jit,
        "trace_misses_by_tick": [int(r.trace_misses) for r in reps],
        "minted": [m for m in minted if m["new_keys"]],
    }
    return part, batches, svc


def same_run(card, cpu, card_batches, cpu_batches, card_svc, cpu_svc) -> list:
    """What differs between the card's and the CPU's part 1 (empty: none)."""
    import numpy as np

    bad = [k for k in ("minted", "jit_cache_entries_by_submit", "trace_misses_by_tick", "paths", "dirty")
           if card[k] != cpu[k]]
    fields = ("eids", "counts", "score", "triggered")
    if len(card_batches) != len(cpu_batches) or not all(
            a.report.tick == b.report.tick and all(np.array_equal(getattr(a, f), getattr(b, f)) for f in fields)
            for a, b in zip(card_batches, cpu_batches)):
        bad.append("alerts")
    bad += [f"counts:{n}" for n in card_svc.pattern_names
            if not np.array_equal(card_svc.pattern_counts(n), cpu_svc.pattern_counts(n))]
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=282.0)
    ap.add_argument("--cpu-twin", action="store_true", help="rerun part 1 with the service on the CPU and compare")
    ap.add_argument("--no-profile", action="store_true", help="leave out the torch.profiler run (part 2)")
    ap.add_argument("--profile-only", action="store_true", help="leave out the plain run (part 1)")
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory of the checkout to stream with")
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_stream.json"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_stream.py: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from pair_count_trace import PairCountTrace
    from repro_torch.api import MiningSession
    from repro_torch.core.patterns import feature_pattern_set
    from repro_torch.data.synth_aml import generate_aml_dataset
    from repro_torch.kernels.intersect_count import ops as ic_ops

    report = {"scale": args.scale, "src": args.src, "card": cs.card_line()}
    g = generate_aml_dataset("HI-Small", seed=cs.SEED, scale=args.scale).graph
    session = MiningSession(g, window=cs.WINDOW).register(*feature_pattern_set("full"))
    _, chunks, lateness = cs.stream_feed(g)
    kw = dict(thresholds=cs.STREAM_THRESHOLDS, pipeline=True, retain="auto", lateness=lateness)

    # ---- 1. a plain run: walls, stages, the launch shapes each tick minted
    brief = ("device", "ticks", "tick_ms_p50_after_first", "jit_cache_entries_by_submit", "minted")
    if not args.profile_only:
        part1, card_batches, card_svc = plain_run(session, g, chunks, kw)
        report["plain"] = part1
        print(json.dumps({k: v for k, v in part1.items() if k in brief}), flush=True)

    # ---- 3. the same run with the service on the CPU ---------------------
    diff = []
    if args.cpu_twin and not args.profile_only:
        part3, cpu_batches, cpu_svc = plain_run(session, g, chunks, dict(kw, device="cpu"))
        diff = same_run(part1, part3, card_batches, cpu_batches, card_svc, cpu_svc)
        part3["differs_from_card"] = diff
        report["cpu_twin"] = part3
        print(json.dumps({k: v for k, v in part3.items() if k in brief + ("differs_from_card",)}), flush=True)
    if not args.profile_only:
        del card_batches, card_svc

    # ---- 2. the same stream under torch.profiler ------------------------
    if args.no_profile:
        return finish(report, diff, args.out)
    svc = session.service(**kw)
    ic_ops.launches = 0
    torch.cuda.synchronize()
    trace = PairCountTrace()
    with trace.hooked(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        walls, _ = stream(svc, g, chunks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kern[ev.name][0] += ev.device_time_total / 1e3  # us -> ms
            kern[ev.name][1] += 1
    busy = sum(v[0] for v in kern.values())
    ic = [(k, v) for k, v in kern.items() if "intersect_count" in k]
    ws = [v for k, v in kern.items() if "window_search" in k]
    part2 = {
        "wall_s": wall,
        "device_kernel_ms": busy,
        "device_busy_share": busy / (wall * 1e3),
        "intersect_count_launches": ic_ops.launches,
        "intersect_count_kernels": [{"name": k[:80], "ms": v[0], "count": v[1]} for k, v in ic],
        "intersect_count_device_ms": sum(v[0] for _, v in ic),
        "window_search_device_ms": sum(v[0] for v in ws),
        "window_search_kernels": sum(v[1] for v in ws),
        "cuda_kernels": sum(v[1] for v in kern.values()),
        "top_kernels": [{"name": k[:100], "ms": v[0], "count": v[1]}
                        for k, v in sorted(kern.items(), key=lambda kv: -kv[1][0])[:TOP]],
        "pair_count": trace.report(prof),
    }
    report["profiled"] = part2
    print(json.dumps(part2), flush=True)
    return finish(report, diff, args.out)


def finish(report, diff, out) -> int:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(report["card"], flush=True)
    if diff:
        print(f"profile_stream.py: the CPU run differs from the card's in {diff}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
