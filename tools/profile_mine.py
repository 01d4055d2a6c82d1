#!/usr/bin/env python3
"""Where the PyTorch port's portfolio mine spends its time on the card.

    python3 tools/profile_mine.py --scale 282   # needs one CUDA card

Mines synthetic HI-Small with the 9-pattern ``"full"`` portfolio through
``repro_torch.api.MiningSession`` and reports, on the card it runs on:

1. the cold mine's host spans (``repro_torch.obs.trace``): schedule build,
   staging, launch dispatch, and the gathers that wait for the device;
2. a warm mine with a device sync after every kernel call, attributed to
   (pattern, strategy, bucket dims): the device-inclusive wall of each
   strategy, how much of it the ``intersect_count`` kernel took, and its
   CUDA-event span summed by launch shape (B, Da, Db, ordered): each span
   runs from an idle card to the kernel's end, so it also holds the
   wrapper's host time before the launch and is an upper bound;
3. a warm mine under ``torch.profiler``: the top CUDA kernels by device
   time, the ``intersect_count`` kernel's own device time and launches,
   and the device's busy share of the mine's wall (kernel time over
   wall; one stream, so kernels do not overlap); and, through
   ``tools/pair_count_trace.py``, the histogram of the kernel's launch
   shapes ``(B, Da, Db, W1...Wk, ordered)`` with launches and device time
   per shape, and the device time, kernels and peak bytes of the operand
   copies the compiler's ``_kernel_pair_count`` launches around it.

``--parts 1,3`` leaves out part 2 (part 3 needs part 1's cold mine
first, and the cold mine always runs).

Prints one JSON object per part and writes them all to
``build/profile_mine.json``.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STRATS = ("bs1", "bs2", "pw", "plain")
TOP = 20  # rows kept in each ranking


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=282.0)
    ap.add_argument("--parts", default="1,2,3", help="comma list of the parts to report")
    args = ap.parse_args()
    parts = {int(x) for x in args.parts.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("profile_mine.py: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import repro_torch.core.compiler as TC
    from pair_count_trace import PairCountTrace
    from repro_torch.api import MiningSession
    from repro_torch.core.patterns import feature_pattern_set
    from repro_torch.data.synth_aml import generate_aml_dataset
    from repro_torch.kernels.intersect_count import ops as ic_ops
    from repro_torch.obs import trace as obs_trace

    report = {"scale": args.scale, "card": torch.cuda.get_device_name(0)}
    g = generate_aml_dataset("HI-Small", seed=0, scale=args.scale).graph
    session = MiningSession(g, window=4096).register(*feature_pattern_set("full"))

    # ---- 1. cold mine, host spans --------------------------------------
    tracer = obs_trace.get_tracer()
    tracer.reset()
    tracer.enable()
    t0 = time.perf_counter()
    session.mine()
    cold_s = time.perf_counter() - t0
    tracer.disable()
    spans = collections.defaultdict(float)
    for ev in tracer.spans():
        spans[ev["name"]] += ev["dur_ns"] / 1e9
    report["cold"] = {"wall_s": cold_s, "span_s": dict(spans)}
    print(json.dumps({"cold": report["cold"]}), flush=True)

    if 2 in parts:
        warm_synced(session, report, TC, ic_ops)
    if 3 in parts:
        warm_profiled(session, report, PairCountTrace)
    out = ROOT / "build" / "profile_mine.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


def warm_synced(session, report, TC, ic_ops) -> None:
    """Part 2: a warm mine with a device sync after every kernel call."""
    import torch

    walls = collections.defaultdict(float)
    calls = collections.Counter()
    ic_walls = collections.defaultdict(float)
    ic_shapes = collections.defaultdict(list)  # (B, Da, Db, ordered) -> [(start, stop)]
    label = [None]
    orig_kernel = TC.CompiledPattern._kernel
    orig_ic = ic_ops.intersect_count

    def timed_kernel(self, strat, dims, sweeps, branch=False):
        fn = orig_kernel(self, strat, dims, sweeps, branch)
        key = f"{self.spec.name}:{STRATS[strat]}{'/branch' if branch else ''}:{dims}"

        def run(*a):
            label[0] = key
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            walls[key] += time.perf_counter() - s
            calls[key] += 1
            return out

        return run

    def timed_ic(*a, **kw):
        torch.cuda.synchronize()
        s = time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        out = orig_ic(*a, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        shape = (*a[0].shape, a[2].shape[1], bool(kw.get("ordered", False)))
        ic_shapes[shape].append(ev)
        ic_walls[label[0]] += time.perf_counter() - s
        return out

    TC.CompiledPattern._kernel = timed_kernel
    ic_ops.intersect_count = timed_ic
    try:
        t0 = time.perf_counter()
        session.mine()
        synced_s = time.perf_counter() - t0
    finally:
        TC.CompiledPattern._kernel = orig_kernel
        ic_ops.intersect_count = orig_ic
    by_strat = collections.defaultdict(float)
    for k, v in walls.items():
        pat, strat, _ = k.split(":", 2)
        by_strat[f"{pat}:{strat}"] += v
    top = sorted(walls.items(), key=lambda kv: -kv[1])[:TOP]
    by_shape = [
        {"B": b, "Da": da, "Db": db, "ordered": o, "launches": len(evs),
         "device_s": sum(x.elapsed_time(y) for x, y in evs) / 1e3}
        for (b, da, db, o), evs in ic_shapes.items()
    ]
    for r in by_shape:
        r["ms_per_launch"] = r["device_s"] * 1e3 / r["launches"]
    report["warm_synced"] = {
        "wall_s": synced_s,
        "intersect_count_by_shape": sorted(by_shape, key=lambda r: -r["device_s"])[:TOP],
        "intersect_count_device_s": sum(r["device_s"] for r in by_shape),
        "by_pattern_strategy_s": dict(sorted(by_strat.items(), key=lambda kv: -kv[1])),
        "intersect_count_s": sum(ic_walls.values()),
        "top_buckets": [
            {"bucket": k, "s": v, "calls": calls[k], "intersect_count_s": ic_walls.get(k, 0.0)}
            for k, v in top
        ],
    }
    print(json.dumps({"warm_synced": report["warm_synced"]}), flush=True)


def warm_profiled(session, report, PairCountTrace) -> None:
    """Part 3: a warm mine under torch.profiler, with intersect_count's
    launch shapes and the copies around it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace = PairCountTrace()
    with trace.hooked(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.mine()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kern = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kern[ev.name][0] += ev.device_time_total / 1e6  # us -> s
            kern[ev.name][1] += 1
    busy = sum(v[0] for v in kern.values())
    ic = [v for k, v in kern.items() if "intersect_count" in k]
    report["warm_profiled"] = {
        "wall_s": prof_wall,
        "device_kernel_s": busy,
        "device_busy_share": busy / prof_wall if prof_wall else None,
        "intersect_count_kernel_s": sum(v[0] for v in ic),
        "intersect_count_kernel_launches": sum(v[1] for v in ic),
        "top_kernels": [
            {"name": k[:120], "s": v[0], "count": v[1]}
            for k, v in sorted(kern.items(), key=lambda kv: -kv[1][0])[:TOP]
        ],
        "pair_count": trace.report(prof),
    }
    print(json.dumps({"warm_profiled": report["warm_profiled"]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
