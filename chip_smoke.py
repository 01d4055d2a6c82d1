#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py                 # HI-Small at its published size
    python3 chip_smoke.py --scale 28      # a tenth of it, for a quick look

Phases, in order; any failure exits non-zero:

1. build  — compile every CUDA kernel of the main path from
   ``src/repro_torch/csrc`` (nvcc, sm_90a) and print the card's name and
   power limit as ``nvidia-smi`` reports them.
2. kernel — hold each kernel to its plain PyTorch version on the card,
   bit for bit, over the bucket-ladder shapes, both ``ordered`` modes,
   ragged batch sizes and the hand-built edge cases; time each shape
   with CUDA events beside its bound.
3. main path — synthetic HI-Small (``--scale 282``: about 451K accounts and
   5.1M transactions, the size of the published IBM HI-Small) mined with
   ``MiningSession(g, window=4096)`` over the 9-pattern ``"full"``
   portfolio, every edge a seed, cold then warm, under
   ``torch.cuda.set_sync_debug_mode("error")`` so that any hidden host
   sync fails the run.  The kernels' launch counts are zeroed just before
   and read just after; each must be > 0, and a compiled portfolio mine
   must sync exactly ``1 + n_compiled`` times.
4. cross-checks — the same mine with ``kernel_backend="torch"`` gives a
   bit-identical count matrix, and 4,096 seeds mined by the port on the
   CPU equal the card's rows for them.
5. report — a ``{"kernels": [...]}`` line (launches, max difference from
   the plain version, kernel / plain / bound times at the main path's
   largest launch), the card line, and last
   ``{"ok": true, "device": {...}}``.  The full record goes to
   ``build/chip_smoke.json``.

It imports torch, numpy and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the non-tensor-core
# rate; one pair test of intersect_count is counted as one operation
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
SMOKE_SHAPES = ((1, 4), (1, 1024), (4, 4), (16, 64), (64, 256), (256, 256), (1024, 1024))
RAGGED_B = (1, 33, 4097)
WINDOW = 4096
SEED = 0  # data seed
CPU_SEEDS = 4096  # seeds the CPU cross-check mines


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ic_bound_ms(b: int, da: int, db: int):
    nbytes = b * (8 * da + 8 * db + 20)
    ops = b * da * db
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ic_inputs(b, da, db, gen, device):
    """Random intersect_count inputs drawn on the card (ids in [-1, 8) so
    rows match often, windows that may invert)."""
    import torch

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    a_lo = ri(-4, 32, (b,))
    b_lo = ri(-4, 32, (b,))
    return (
        ri(-1, 8, (b, da)),
        ri(0, 64, (b, da)),
        ri(-1, 8, (b, db)),
        ri(0, 64, (b, db)),
        a_lo,
        a_lo + ri(-8, 64, (b,)),
        b_lo,
        b_lo + ri(-8, 64, (b,)),
    )


def ic_plain_rows(args, ordered, max_cube=1 << 27):
    """The plain version, row-chunked so its compare cube stays small."""
    import torch
    from repro_torch.kernels.intersect_count.ref import intersect_count_ref

    b, da = args[0].shape
    db = args[2].shape[1]
    step = max(1, max_cube // (da * db))
    outs = [
        intersect_count_ref(*(x[r : r + step] for x in args), ordered=ordered)
        for r in range(0, b, step)
    ]
    return torch.cat(outs) if outs else torch.zeros(0, dtype=torch.int32, device=args[0].device)


def phase_kernel(device, report):
    import torch
    from repro_torch.kernels.intersect_count import ops as ic_ops

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    max_err = 0
    n_cases = 0
    for da, db in SMOKE_SHAPES:
        for ordered in (False, True):
            for b in RAGGED_B:
                args = ic_inputs(b, da, db, gen, device)
                got = ic_ops.intersect_count(*args, ordered=ordered)
                want = ic_plain_rows(args, ordered)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                n_cases += 1
                if err:
                    raise AssertionError(f"intersect_count differs at B={b} Da={da} Db={db} ordered={ordered}: {err}")
    # the hand-built cases: duplicate ids, fully padded sides, an inverted
    # window, ordered ties at equal times
    t = lambda rows: torch.tensor(rows, dtype=torch.int32).to(device)
    case = (
        t([[3, 3, 3, -1], [-1, -1, -1, -1], [0, 1, 2, 3], [5, 5, -1, -1], [7, 7, 7, 7]]),
        t([[10, 20, 30, 99], [0, 0, 0, 0], [5, 6, 7, 8], [50, 60, 0, 0], [10, 10, 10, 10]]),
        t([[3, 3, -1], [1, 2, 3], [-1, -1, -1], [5, 5, 5], [7, 7, 7]]),
        t([[15, 25, 0], [1, 2, 3], [0, 0, 0], [55, 65, 75], [10, 11, 9]]),
        t([0, 0, 4, 40, 0]),
        t([25, 10, 9, 70, 99]),
        t([0, 0, 0, 60, 0]),
        t([30, 10, 9, 50, 99]),
    )
    for ordered in (False, True):
        got = ic_ops.intersect_count(*case, ordered=ordered).cpu()
        want = ic_plain_rows(case, ordered).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"intersect_count edge cases differ (ordered={ordered}): {got} vs {want}")
        expect = {0: 4, 3: 0} if not ordered else {4: 4}
        for r, v in expect.items():
            if int(got[r]) != v:
                raise AssertionError(f"edge case row {r}: {int(got[r])} != {v}")
        n_cases += 1
    log(f"kernel: intersect_count == plain version on {n_cases} cases (max |diff| {max_err})")

    timings = []
    for da, db in SMOKE_SHAPES:
        b = max(256, (1 << 24) // (da * db))
        args = ic_inputs(b, da, db, gen, device)
        ms = cuda_ms(lambda: ic_ops.intersect_count(*args, ordered=True), 20)
        plain_ms = cuda_ms(lambda: ic_plain_rows(args, True, max_cube=1 << 30), 3)
        bound, by = ic_bound_ms(b, da, db)
        row = {"B": b, "Da": da, "Db": db, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
        timings.append(row)
        log("kernel timing: " + json.dumps(row))
    report["intersect_count_shapes"] = timings
    return max_err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=282.0, help="HI-Small scale (282 = published size)")
    args = ap.parse_args()

    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py: run it from a checkout of the repository (src/repro_torch is missing)", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.api import MiningSession
    from repro_torch.core.patterns import feature_pattern_set
    from repro_torch.data.synth_aml import generate_aml_dataset
    from repro_torch.device import allowed_sync
    from repro_torch.kernels import build
    from repro_torch.kernels.intersect_count import ops as ic_ops

    device = torch.device("cuda")
    report = {"scale": args.scale, "seed": SEED}

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    build.load("intersect_count")
    report["build_s"] = time.perf_counter() - t0
    card = card_line()
    report["card"] = card
    log(f"build: intersect_count from src/repro_torch/csrc/intersect_count.cu in {report['build_s']:.2f} s (nvcc {build.build_seconds['intersect_count']:.2f} s)")
    log(f"card: {card}")

    # ---- 2. kernel against plain version ------------------------------
    max_err = phase_kernel(device, report)

    # ---- 3. main path at a real size ----------------------------------
    t0 = time.perf_counter()
    ds = generate_aml_dataset("HI-Small", seed=SEED, scale=args.scale)
    g = ds.graph
    report["data"] = {"n_nodes": g.n_nodes, "n_edges": g.n_edges, "gen_s": time.perf_counter() - t0,
                      "max_out_deg": g.max_out_deg(), "max_in_deg": g.max_in_deg()}
    log("data: " + json.dumps(report["data"]))
    pats = feature_pattern_set("full")
    session = MiningSession(g, window=WINDOW).register(*pats)

    biggest = {}
    kernel_fn = ic_ops.intersect_count

    def capture(*a, **kw):
        b, da = a[0].shape
        work = b * da * a[2].shape[1]
        if work > biggest.get("work", -1):
            biggest.update(work=work, args=a, ordered=kw.get("ordered", False))
        return kernel_fn(*a, **kw)

    ic_ops.intersect_count = capture
    torch.cuda.reset_peak_memory_stats()
    ic_ops.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        cold = session.mine()
        with allowed_sync():
            torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = session.mine()
        with allowed_sync():
            torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        ic_ops.intersect_count = kernel_fn
    launches = ic_ops.launches
    n_compiled = len(session._compiled)
    main = {
        "patterns": list(pats),
        "n_seeds": int(cold.n_seeds),
        "cold_s": cold_s,
        "warm_s": warm_s,
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
        "intersect_count_launches": launches,
        "n_compiled": n_compiled,
        "fused": list(cold.fused),
        "totals": cold.totals(),
        "stats_cold": cold.stats,
        "stats_warm": warm.stats,
        "seconds_cold": cold.seconds,
    }
    report["main_path"] = main
    log("main path: " + json.dumps(main))
    if launches <= 0:
        raise AssertionError("the main path launched intersect_count no time")
    for name, res in (("cold", cold), ("warm", warm)):
        if res.stats["host_syncs"] != 1 + n_compiled:
            raise AssertionError(f"{name} mine synced {res.stats['host_syncs']} times, not {1 + n_compiled}")
    if warm.stats["schedule_hits"] <= 0:
        raise AssertionError("the warm mine did not replay its schedules")
    counts = cold.counts
    if counts.shape != (g.n_edges, len(pats)) or (counts < 0).any():
        raise AssertionError(f"count matrix has shape {counts.shape} or negative counts")
    if not np.array_equal(counts, warm.counts):
        raise AssertionError("warm mine disagrees with the cold mine")

    # ---- 4. cross-checks on the card ----------------------------------
    t0 = time.perf_counter()
    res_t = MiningSession(g, window=WINDOW, kernel_backend="torch").register(*pats).mine()
    torch_s = time.perf_counter() - t0
    if not np.array_equal(res_t.counts, counts):
        bad = np.argwhere(res_t.counts != counts)[:5]
        raise AssertionError(f'kernel_backend="torch" disagrees with "kernel" at {bad.tolist()}')
    rng = np.random.default_rng(SEED)
    sub = rng.choice(g.n_edges, size=min(CPU_SEEDS, g.n_edges), replace=False).astype(np.int32)
    t0 = time.perf_counter()
    res_c = MiningSession(g, window=WINDOW, device="cpu").register(*pats).mine(seeds=sub)
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(res_c.counts, counts[sub]):
        raise AssertionError("the CPU port disagrees with the card on the seed subset")
    report["cross_checks"] = {"torch_backend_s": torch_s, "torch_backend_equal": True,
                              "cpu_seeds": int(len(sub)), "cpu_s": cpu_s, "cpu_equal": True,
                              "cpu_nonzero_cells": int((res_c.counts != 0).sum())}
    log("cross-checks: " + json.dumps(report["cross_checks"]))

    # ---- 5. report -----------------------------------------------------
    a = biggest["args"]
    ordered = biggest["ordered"]
    b, da = a[0].shape
    db = a[2].shape[1]
    got = ic_ops.intersect_count(*a, ordered=ordered)
    want = ic_plain_rows(a, ordered)
    err = int((got.long() - want.long()).abs().max()) if b else 0
    if err:
        raise AssertionError(f"intersect_count differs from its plain version on the main path's launch: {err}")
    max_err = max(max_err, err)
    ms = cuda_ms(lambda: ic_ops.intersect_count(*a, ordered=ordered), 20)
    plain_ms = cuda_ms(lambda: ic_plain_rows(a, ordered, max_cube=1 << 30), 3)
    bound, by = ic_bound_ms(b, da, db)
    kernels = [{
        "name": "intersect_count",
        "route": "cuda",
        "source": "src/repro_torch/csrc/intersect_count.cu",
        "replaces": "src/repro/kernels/intersect_count/kernel.py:83",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "shape": {"B": b, "Da": da, "Db": db, "ordered": bool(ordered)},
    }]
    report["kernels"] = kernels
    out = ROOT / "build" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
