#!/usr/bin/env python3
"""Where the PyTorch port's portfolio mine spends its time on the card.

    python3 tools/profile_mine.py --scale 282   # needs one CUDA card

Mines synthetic HI-Small with the 9-pattern ``"full"`` portfolio through
``repro_torch.api.MiningSession`` and reports, on the card it runs on:

1. the cold mine's host spans (``repro_torch.obs.trace``): schedule build,
   staging, launch dispatch, and the gathers that wait for the device;
2. a warm mine with a device sync after every kernel call, attributed to
   (pattern, strategy, bucket dims, sweep grid): the device-inclusive wall
   of each strategy, how much of it the ``intersect_count`` kernel took,
   each swept bs1/bs2 bucket's grid split into its frontier dims' combos
   (a Python loop of the callable) and its intersect dims' combos (inside
   one ``intersect_step`` launch where the checkout has that entry), and
   its
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

Beside ``intersect_count``, parts 2 and 3 read the windowed searches
(``count_window`` and ``count_id_in_window``: the ``window_search``
kernel's wrapper where the checkout has it, else the eager searches of
``repro_torch.core.ops``; and ``intersect_step``, the wrapper's entry for a
whole bs1/bs2 intersect step, where the checkout has it): part 2 their
CUDA-event spans summed by launch shape (the broadcast query shape and
each operand's form: ``s`` a Python int, else the operand's own shape;
``intersect_step`` by strategy, lead shape, D and in-launch sweep count),
part 3 the ``window_search`` kernel's device time and launches split
between its two entries, and the CUDA kernels one call of each search
launches (its largest call of part 2, run again under the profiler).
Part 2 also times the fused seed-local plan's callables.

``chip_smoke.py`` phase 8 times the mining path's largest search and
intersect-step launches with the L2 flushed; run a parent's
``chip_smoke.py`` for its figures.

``--parts 1,3`` leaves out part 2 (part 3 needs part 2's largest calls;
the cold mine always runs).  ``--src`` mines with another
checkout's ``src`` (a parent unpacked under ``build/``), so two commits
read the same numbers.

Prints one JSON object per part and writes them all to ``--out``
(default ``build/profile_mine.json``).
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
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory of the checkout to mine with")
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_mine.json"))
    args = ap.parse_args()
    parts = {int(x) for x in args.parts.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("profile_mine.py: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "tools"))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.core.compiler as TC
    from pair_count_trace import PairCountTrace
    from repro_torch.api import MiningSession
    from repro_torch.core.patterns import feature_pattern_set
    from repro_torch.data.synth_aml import generate_aml_dataset
    from repro_torch.kernels.intersect_count import ops as ic_ops
    from repro_torch.obs import trace as obs_trace

    report = {"scale": args.scale, "src": args.src, "card": torch.cuda.get_device_name(0)}
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

    biggest = {}  # search name -> the args of its largest call in part 2
    if 2 in parts:
        warm_synced(session, report, TC, ic_ops, biggest)
    if 3 in parts:
        warm_profiled(session, report, PairCountTrace, biggest)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


def search_modules():
    """The modules whose windowed searches the mining path calls: the
    ``window_search`` wrapper where the checkout has it (the compiled and
    fused plans' ``"kernel"`` backend), and the eager ``core.ops``."""
    import repro_torch.core.ops as core_ops

    mods = [core_ops]
    try:
        from repro_torch.kernels.window_search import ops as ws_ops
    except ImportError:
        return mods
    return [ws_ops] + mods


def operand_form(x) -> str:
    import torch

    return "x".join(map(str, x.shape)) if isinstance(x, torch.Tensor) else "s"


def warm_synced(session, report, TC, ic_ops, biggest) -> None:
    """Part 2: a warm mine with a device sync after every kernel call."""
    import torch

    walls = collections.defaultdict(float)
    calls = collections.Counter()
    grids = {}  # bucket key -> (frontier dims' combos, intersect dims' combos)
    ic_walls = collections.defaultdict(float)
    ic_shapes = collections.defaultdict(list)  # (B, Da, Db, ordered) -> [(start, stop)]
    label = [None]
    orig_kernel = TC.CompiledPattern._kernel
    orig_ic = ic_ops.intersect_count

    def timed_kernel(self, strat, dims, sweeps, branch=False):
        fn = orig_kernel(self, strat, dims, sweeps, branch)
        key = f"{self.spec.name}:{STRATS[strat]}{'/branch' if branch else ''}:{dims}:{tuple(sweeps)}"
        grids[key] = sweep_split(len(self.ir.frontiers), sweeps)

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

    ws_walls = collections.defaultdict(float)
    ws_shapes = collections.defaultdict(list)  # (search, shape, operand forms) -> [(start, stop)]

    def timed_search(name, orig, n_ops):
        def run(*a):
            torch.cuda.synchronize()
            s = time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            out = orig(*a)
            ev[1].record()
            torch.cuda.synchronize()
            ops_ = a[-1 - n_ops:-1]  # node, [x,] after, until
            ws_shapes[(name, tuple(out.shape), "/".join(map(operand_form, ops_)))].append(ev)
            ws_walls[label[0]] += time.perf_counter() - s
            if out.numel() > biggest.get(name, (0, None))[0]:
                biggest[name] = (out.numel(), orig, a, {})
            return out

        return run

    fused = session._fused
    fused_saved = dict(fused._built) if fused is not None else {}

    def timed_fused(key, fn):
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

    step_shapes = collections.defaultdict(list)  # (strategy, lead shape, D, n_sweep) -> [(start, stop)]

    def timed_step(orig):
        def run(strategy, *a, **kw):
            torch.cuda.synchronize()
            s = time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            out = orig(strategy, *a, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            step_shapes[(strategy, tuple(out.shape), kw["d"], kw["n_sweep"])].append(ev)
            ws_walls[label[0]] += time.perf_counter() - s
            if out.numel() * kw["d"] * kw["n_sweep"] > biggest.get("intersect_step", (0, None))[0]:
                biggest["intersect_step"] = (out.numel() * kw["d"] * kw["n_sweep"], orig, (strategy, *a), kw)
            return out

        return run

    searches = [(mod, name, getattr(mod, name)) for mod in search_modules()
                for name in ("count_window", "count_id_in_window")]
    step_mod = search_modules()[0]
    orig_step = getattr(step_mod, "intersect_step", None)
    if orig_step is not None:
        searches.append((step_mod, "intersect_step", orig_step))
    TC.CompiledPattern._kernel = timed_kernel
    ic_ops.intersect_count = timed_ic
    for mod, name, fn in searches:
        setattr(mod, name, timed_step(fn) if name == "intersect_step"
                else timed_search(name, fn, 3 if name == "count_window" else 4))
    for unit_sel, fn in fused_saved.items():
        fused._built[unit_sel] = timed_fused(f"fused:fused:{len(unit_sel)} units", fn)
    try:
        t0 = time.perf_counter()
        session.mine()
        synced_s = time.perf_counter() - t0
    finally:
        TC.CompiledPattern._kernel = orig_kernel
        ic_ops.intersect_count = orig_ic
        for mod, name, fn in searches:
            setattr(mod, name, fn)
        if fused is not None:
            fused._built.update(fused_saved)
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
    ws_by_shape = [
        {"search": n, "shape": list(shape), "operands": forms, "calls": len(evs),
         "device_s": sum(x.elapsed_time(y) for x, y in evs) / 1e3}
        for (n, shape, forms), evs in ws_shapes.items()
    ]
    for r in ws_by_shape:
        r["ms_per_call"] = r["device_s"] * 1e3 / r["calls"]
    step_by_shape = [
        {"strategy": st, "lead": list(lead), "D": d, "n_sweep": n, "launches": len(evs),
         "device_s": sum(x.elapsed_time(y) for x, y in evs) / 1e3}
        for (st, lead, d, n), evs in step_shapes.items()
    ]
    for r in step_by_shape:
        r["ms_per_launch"] = r["device_s"] * 1e3 / r["launches"]
    swept = []  # the swept bs1/bs2 buckets, with their grids split
    for k, v in walls.items():
        strat = k.split(":")[1].split("/")[0]
        if k in grids and strat in ("bs1", "bs2") and (grids[k][0] > 1 or grids[k][1] > 1):
            swept.append({"bucket": k, "s": v, "calls": calls[k], "frontier_combos": grids[k][0],
                          "intersect_combos": grids[k][1], "search_s": ws_walls.get(k, 0.0)})
    ws_by_strat = collections.defaultdict(float)
    for k, v in ws_walls.items():
        if k is not None:
            pat, strat, _ = k.split(":", 2)
            ws_by_strat[f"{pat}:{strat}"] += v
    report["warm_synced"] = {
        "wall_s": synced_s,
        "search_calls": sum(r["calls"] for r in ws_by_shape),
        "search_device_s": sum(r["device_s"] for r in ws_by_shape),
        "search_s": sum(ws_walls.values()),
        "search_by_pattern_strategy_s": dict(sorted(ws_by_strat.items(), key=lambda kv: -kv[1])),
        "search_by_shape": sorted(ws_by_shape, key=lambda r: -r["device_s"])[:TOP],
        "intersect_step_launches": sum(r["launches"] for r in step_by_shape),
        "intersect_step_device_s": sum(r["device_s"] for r in step_by_shape),
        "intersect_step_by_shape": sorted(step_by_shape, key=lambda r: -r["device_s"])[:TOP],
        "swept_bs_buckets": {
            "s": sum(r["s"] for r in swept),
            "calls": sum(r["calls"] for r in swept),
            # the callable's loop rounds (frontier combos) and the combos
            # the parent's loop also ran per round (intersect combos)
            "frontier_rounds": sum(r["calls"] * r["frontier_combos"] for r in swept),
            "grid_rounds": sum(r["calls"] * r["frontier_combos"] * r["intersect_combos"] for r in swept),
            "buckets": sorted(swept, key=lambda r: -r["s"])[:TOP],
        },
        "intersect_count_by_shape": sorted(by_shape, key=lambda r: -r["device_s"])[:TOP],
        "intersect_count_device_s": sum(r["device_s"] for r in by_shape),
        "by_pattern_strategy_s": dict(sorted(by_strat.items(), key=lambda kv: -kv[1])),
        "intersect_count_s": sum(ic_walls.values()),
        "top_buckets": [
            {"bucket": k, "s": v, "calls": calls[k], "intersect_count_s": ic_walls.get(k, 0.0),
             "search_s": ws_walls.get(k, 0.0), "frontier_combos": grids[k][0] if k in grids else 1,
             "intersect_combos": grids[k][1] if k in grids else 1}
            for k, v in top
        ],
    }
    print(json.dumps({"warm_synced": report["warm_synced"]}), flush=True)


def sweep_split(k: int, sweeps) -> tuple:
    """A bucket's sweep grid as (the frontier dims' combos, the intersect
    dims' combos): dims 0..k-1 are the frontier levels, k and k+1 the
    intersect's two expansions."""
    sweeps = tuple(sweeps) or (1,) * (k + 2)
    prod = lambda xs: int(__import__("math").prod(xs))  # noqa: E731
    return prod(sweeps[:k]), prod(sweeps[k:])


def cuda_kernels(prof):
    """(start, name, device seconds) of every CUDA kernel a profile
    recorded, in launch order (one stream: the device runs them in it)."""
    import torch

    return sorted((ev.time_range.start, ev.name, ev.device_time_total / 1e6) for ev in prof.events()
                  if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA)


def search_launches(kernels, biggest) -> dict:
    """The CUDA kernels one call of each windowed search launches: its
    largest call of part 2, run again after the warm mine inside the same
    profile between two marker kernels (``torch.cuda._sleep(0)``, the
    profile's last markers), so the kernels between them are the call's.
    ``kernels`` holds the profile's (start, name, device seconds) in launch
    order."""
    marks = [i for i, (_, name, _) in enumerate(kernels) if "spin" in name]
    out = {}
    for j, (name, (numel, fn, args, _)) in enumerate(sorted(biggest.items())):
        a, b = marks[-2 * len(biggest) + 2 * j], marks[-2 * len(biggest) + 2 * j + 1]
        inner = kernels[a + 1:b]
        ops_ = args[3:] if name == "intersect_step" else args[-5 if name == "count_id_in_window" else -4:-1]
        out[name] = {"elements": numel, "module": fn.__module__, "cuda_launches": len(inner),
                     "device_ms": sum(s for _, _, s in inner) * 1e3,
                     "operands": "/".join(operand_form(v) for v in ops_ if not isinstance(v, tuple))}
    return out


def warm_profiled(session, report, PairCountTrace, biggest) -> None:
    """Part 3: a warm mine under torch.profiler, with intersect_count's
    launch shapes and the copies around it, and the windowed searches'
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace = PairCountTrace()
    with trace.hooked(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.mine()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
        for _, (_, fn, args, kw) in sorted(biggest.items()):
            torch.cuda._sleep(0)
            fn(*args, **kw)
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
    events = cuda_kernels(prof)
    # the mine's kernels: those before the markers of the calls above, the
    # last 2 * len(biggest) markers (the pair-count trace marks the mine's)
    marks = [i for i, (_, name, _) in enumerate(events) if "spin" in name]
    traced = len(marks) >= 2 * len(biggest)
    cut = marks[-2 * len(biggest)] if biggest and traced else len(events)
    kern = collections.defaultdict(lambda: [0.0, 0])
    for _, name, sec in events[:cut]:
        kern[name][0] += sec
        kern[name][1] += 1
    busy = sum(v[0] for v in kern.values())
    ic = [v for k, v in kern.items() if "intersect_count" in k]
    ws = [v for k, v in kern.items() if "window_search" in k and "step" not in k]
    step = [v for k, v in kern.items() if "window_search_step" in k]
    report["warm_profiled"] = {
        "wall_s": prof_wall,
        "device_kernel_s": busy,
        "device_busy_share": busy / prof_wall if prof_wall else None,
        "intersect_count_kernel_s": sum(v[0] for v in ic),
        "intersect_count_kernel_launches": sum(v[1] for v in ic),
        "window_search_kernel_s": sum(v[0] for v in ws),
        "window_search_kernel_launches": sum(v[1] for v in ws),
        "intersect_step_kernel_s": sum(v[0] for v in step),
        "intersect_step_kernel_launches": sum(v[1] for v in step),
        "cuda_kernels": sum(v[1] for v in kern.values()),
        "top_kernels": [
            {"name": k[:120], "s": v[0], "count": v[1]}
            for k, v in sorted(kern.items(), key=lambda kv: -kv[1][0])[:TOP]
        ],
        "pair_count": trace.report(prof),
        "launches_per_search_call": search_launches(events, biggest) if traced else None,
    }
    print(json.dumps({"warm_profiled": report["warm_profiled"]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
