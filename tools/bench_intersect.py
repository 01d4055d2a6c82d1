#!/usr/bin/env python3
"""Time the port's ``intersect_count`` and ``window_degree`` kernels.

    python3 tools/bench_intersect.py [--src DIR ...] [--cases smoke,path,wd] [--out FILE]

Needs one CUDA card.  Each ``--src`` (the ``src/`` of any checkout; the
default is this checkout's) is timed in a process of its own, in the order
given, so that versions can be compared in turns in one call (``--src A
--src B --src B --src A``; ``tools/intersect_variants.py`` writes one-choice
variants).  The cases:

- ``smoke``: ``chip_smoke.py``'s ``SMOKE_SHAPES`` as phase 2 draws them
  (every operand materialised per row, ``ordered=True``, B =
  max(256, 2^24 / (Da * Db)));
- ``path``: the two paths' largest launches in the forms the compiler
  passes them (``tools/profile_mine.py`` and ``tools/profile_stream.py``
  list every launch's): ``mine`` and ``stream`` are ``count_edges`` at
  B = 1,048,576, Da = 1, Db = 4 and at B = 131,072, Da = 1, Db = 32,
  unordered, with no a-side time, the a window (INT32_MIN, INT32_MAX] as
  ints, b_lo per row and b_hi per fixed row; ``mine_pw`` is the ``pw``
  intersect that takes the mine's most kernel time, B = 65,536, Da = 16,
  Db = 4, ordered, both b bounds per fixed row.  W (rows per fixed row)
  is ``--mine-w`` (also ``mine_pw``'s) and ``--stream-w``; a checkout
  whose wrapper takes only materialised operands gets them materialised,
  as its compiler passed them;
- ``wide``: (256, 1,024, 1,024) ordered and not, materialised;
- ``wd``: ``window_degree`` at (16,384, 128), (1,048,576, 32) and
  (262,144, 128).

At every case it reports ``ms`` (CUDA events around ``reps`` back-to-back
wrapper calls), ``kernel_ms`` (the kernel's own mean device time under
``torch.profiler``, null when the profiler records nothing), ``host_us``
(the host's time per wrapper call, not waiting for the card), ``plain_ms``
(the plain version), ``plan`` (the path ``ops.plan`` names, where the
checkout has one), ``max_abs_err`` against the plain version, and the
bound: the bytes the call must move (each input read once, each output
written once; the fixed side at its own rows, a scalar window none) over
3.35 TB/s, or its Da * Db pair tests (D compare-and-adds for
``window_degree``) over 67 T/s, whichever is larger.

Prints one JSON object per row and writes them all to ``--out`` (default
``build/bench_intersect.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
SMOKE_SHAPES = ((1, 4), (1, 1024), (4, 4), (16, 64), (64, 256), (256, 256), (1024, 1024))
WD_SHAPES = ((16384, 128), (1 << 20, 32), (1 << 18, 128))


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ic_bytes(args) -> int:
    """Bytes the call must move: every tensor operand read once, the (B,)
    int32 output written once."""
    import torch

    return sum(x.numel() * 4 for x in args if isinstance(x, torch.Tensor)) + 4 * args[0].shape[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_us(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def kernel_ms(fn, reps: int, match: str):
    """Mean device time per launch of the kernels named ``match`` under
    ``torch.profiler``; None when it records no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [ev.device_time_total for ev in prof.events()
          if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA and match in ev.name]
    return sum(us) / len(us) / 1e3 if us else None


def materialised(args, b: int):
    """The operands as the materialising compiler passed them: the fixed
    side repeated to B rows, every window a (B,) tensor, a zero a-side
    time for a missing one."""
    import torch

    a_ids, a_t, b_ids, b_t = args[:4]
    rep = b // b_ids.shape[0]
    dev = a_ids.device

    def rows(x):
        if not isinstance(x, torch.Tensor):
            return torch.full((b,), x, dtype=torch.int32, device=dev)
        return x if x.shape[0] == b else x.repeat_interleave(rep)

    return (a_ids, torch.zeros_like(a_ids) if a_t is None else a_t,
            b_ids.repeat_interleave(rep, 0), b_t.repeat_interleave(rep, 0), *map(rows, args[4:]))


def ic_case(kind, b, da, db, w, gen):
    """Operands of one case: materialised (``kind == "full"``), or in the
    compiler's broadcast forms (``"edges"``: no a-side time, b_lo per row;
    ``"pw"``: both b bounds per fixed row)."""
    import torch

    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)
    if kind == "full":
        a_lo, b_lo = ri(-4, 32, (b,)), ri(-4, 32, (b,))
        return (ri(-1, 8, (b, da)), ri(0, 64, (b, da)), ri(-1, 8, (b, db)), ri(0, 64, (b, db)),
                a_lo, a_lo + ri(-8, 64, (b,)), b_lo, b_lo + ri(-8, 64, (b,)))
    bf = b // w
    b_hi = ri(20, 80, (bf,))
    b_lo = ri(-4, 32, (b,)) if kind == "edges" else b_hi - ri(-8, 64, (bf,))
    return (ri(-1, 8, (b, da)), None if kind == "edges" else ri(0, 64, (b, da)),
            ri(-1, 8, (bf, db)), ri(0, 64, (bf, db)), I32_MIN, I32_MAX, b_lo, b_hi)


def run_one(src: str, names, mine_w: int, stream_w: int, out_rows: list) -> None:
    import torch

    sys.path.insert(0, src)
    from repro_torch.kernels.intersect_count import ops as ic_ops
    from repro_torch.kernels.intersect_count.ref import intersect_count_ref
    from repro_torch.kernels.window_degree import ops as wd_ops
    from repro_torch.kernels.window_degree.ref import window_degree_ref

    broadcast = hasattr(ic_ops, "plan")  # a wrapper that takes the compiler's broadcast forms
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    if "smoke" in names:
        cases += [("smoke", "full", max(256, (1 << 24) // (da * db)), da, db, 1, True) for da, db in SMOKE_SHAPES]
    if "path" in names:
        cases += [("mine", "edges", 1 << 20, 1, 4, mine_w, False), ("stream", "edges", 1 << 17, 1, 32, stream_w, False),
                  ("mine_pw", "pw", 1 << 16, 16, 4, mine_w, True)]
    if "wide" in names:
        cases += [("wide", "full", 256, 1024, 1024, 1, o) for o in (False, True)]
    for name, kind, b, da, db, w, ordered in cases:
        args = ic_case(kind, b, da, db, w, gen)
        run_args = args if broadcast else materialised(args, b)
        plain_args = materialised(args, b)
        run = lambda: ic_ops.intersect_count(*run_args, ordered=ordered)
        step = max(1, (1 << 27) // (da * db))
        want = torch.cat([intersect_count_ref(*(x[r:r + step] for x in plain_args), ordered=ordered)
                          for r in range(0, b, step)])
        err = int((run().long() - want.long()).abs().max())
        bound, by = bound_ms(ic_bytes(args), b * da * db)
        reps = 20 if b * da * db >= 1 << 26 else 200
        row = {"src": src, "kernel": "intersect_count", "case": name, "form": kind if broadcast else "full",
               "B": b, "Da": da, "Db": db, "W1_Wk": w, "ordered": ordered,
               "plan": ic_ops.plan(b, da, db) if broadcast else "lanes", "max_abs_err": err,
               "ms": cuda_ms(run, reps), "kernel_ms": kernel_ms(run, reps, "intersect_count"),
               "host_us": host_us(run, reps),
               "plain_ms": cuda_ms(lambda: intersect_count_ref(*plain_args, ordered=ordered), 3)
               if b * da * db <= 1 << 30 else None,
               "bound_ms": bound, "bound_by": by, "bytes": ic_bytes(args)}
        print(json.dumps(row), flush=True)
        out_rows.append(row)
    if "wd" in names:
        for b, d in WD_SHAPES:
            t = torch.where(torch.rand((b, d), generator=gen, device="cuda") < 0.25, wd_ops.PAD_T,
                            torch.randint(0, 128, (b, d), generator=gen, device="cuda", dtype=torch.int32))
            lo = torch.randint(0, 64, (b,), generator=gen, device="cuda", dtype=torch.int32)
            hi = lo + torch.randint(0, 64, (b,), generator=gen, device="cuda", dtype=torch.int32)
            run = lambda: wd_ops.window_degree(t, lo, hi)
            bound, by = bound_ms(b * (4 * d + 12), b * d)
            row = {"src": src, "kernel": "window_degree", "B": b, "D": d,
                   "max_abs_err": int((run().long() - window_degree_ref(t, lo, hi).long()).abs().max()),
                   "ms": cuda_ms(run, 50), "kernel_ms": kernel_ms(run, 50, "window_degree"),
                   "host_us": host_us(run, 50), "plain_ms": cuda_ms(lambda: window_degree_ref(t, lo, hi), 10),
                   "bound_ms": bound, "bound_by": by}
            print(json.dumps(row), flush=True)
            out_rows.append(row)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", help="src/ of a checkout (repeatable; default this one)")
    ap.add_argument("--cases", default="smoke,path,wide,wd", help="comma list of smoke, path, wide, wd")
    ap.add_argument("--mine-w", type=int, default=16, help="rows per fixed row at the mining launches")
    ap.add_argument("--stream-w", type=int, default=32, help="rows per fixed row at the streaming launch")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "bench_intersect.json")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = args.cases.split(",")
    if args.one:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("bench_intersect.py: no CUDA device")
        run_one(args.one, names, args.mine_w, args.stream_w, [])
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    rows = []
    for src in args.src or [str(ROOT / "src")]:
        proc = subprocess.run([sys.executable, __file__, "--one", str(Path(src).resolve()), "--cases", args.cases,
                               "--mine-w", str(args.mine_w), "--stream-w", str(args.stream_w)],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            raise SystemExit(f"bench_intersect.py: {src} failed (exit {proc.returncode})")
        for line in proc.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                rows.append({**json.loads(line), "card": card})
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
