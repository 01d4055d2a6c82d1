#!/usr/bin/env python3
"""Time the port's ``flash_attention`` (forward or backward) at FraudGT's shape and long bf16 shapes.

    python3 tools/bench_flash.py [--src DIR ...] [--shapes fraudgt,long] [--direction fwd|bwd]
                                 [--flush-l2] [--ptxas] [--out FILE]

Needs one CUDA card.  Each ``--src`` (the ``src/`` of any checkout; the
default is this checkout's) is timed in a process of its own, in the order
given, so that two versions can be compared in turns in one call
(``--src A --src B --src B --src A``).  At every shape it reports:

- ``ms``: CUDA events around ``reps`` back-to-back launches of the wrapper;
- ``kernel_ms``: the kernel's own mean device time per launch under
  ``torch.profiler`` (the wrapper's host work left out);
- ``host_us``: the host's time per wrapper call (``time.perf_counter``
  over ``reps`` calls that do not wait for the card), which bounds ``ms``
  from below when the kernel is shorter;
- ``library_ms``: one ``F.scaled_dot_product_attention`` on the same inputs;
- ``bound_ms``: the bytes (q, k, v read once, o written once) over
  3.35 TB/s or the flops (4 * hd per visible pair) over 67 TFLOP/s
  (float32) or 989 TFLOP/s (bf16 tensor cores), whichever is larger;
- ``plan``: the path the package's ``ops.plan`` picks, where it has one;
- ``max_abs_err`` against the plain version.

``--direction bwd`` times ``flash_attention_bwd`` instead, on the
forward kernel's o and logsumexp and a standard-normal dO: ``ms``,
``kernel_ms`` (the call's kernels summed) and ``passes`` (the profiler's
device ms a call of each kernel: ``row_dot``, ``dq``, ``dkv`` on the long
backward), ``host_us``, ``library_ms`` (the backward of one
``F.scaled_dot_product_attention``, ``torch.autograd.grad`` at dO),
``bound_ms`` (5 products of 2 * hd flops per visible pair at the peak, or
the bytes: q, k, v, o, dO, lse read once, dQ, dK, dV written once),
``bwd_plan`` (on the short path also ``route`` and ``stages``, where the
checkout has ``short_bwd_route``), and ``max_abs_err`` / ``max_rel_err``
against the plain version (``flash_attention_bwd_ref`` in float32 on the
card; the relative one over the largest |value| of dQ, dK and dV
together).  ``--flush-l2`` times each backward launch after a read of
256 MB has evicted its operands from the 50 MB L2, as the bytes bound
assumes (``ms`` by events a launch, ``kernel_ms`` under the profiler; a
read, so that L2 holds clean lines and the launch pays for no other
buffer's write-back, as it would after a write),
and keeps the back-to-back times, operands in L2, as ``l2_warm_ms`` and
``l2_warm_kernel_ms``.  The short backward at FraudGT's training launch
(``fraudgt_train``, B 256) and at its inference chunk (``fraudgt``, B
1,024), against a parent checkout unpacked under ``build/parent``:

    python3 tools/bench_flash.py --direction bwd --shapes fraudgt_train,fraudgt --flush-l2 \
        --src build/parent/src --src src --src src --src build/parent/src

The long backward's time at qwen2-1.5b's training launch, in turns:

    python3 tools/bench_flash.py --direction bwd --shapes lm_train --ptxas \
        --src build/parent/src --src src --src src --src build/parent/src

``--ptxas`` also compiles each ``--src``'s ``csrc/flash_attention.cu``
with ``-Xptxas -v`` and reports, for every backward kernel
(``flash_bwd_kernel*``), its registers a thread at launch, its stack frame
and its spill stores and loads.

``--shapes fraudgt_path`` times FraudGT's shape on the inputs FraudGT
itself gives its first attention call (seeded weights, the first 1,024
test edges of synthetic HI-Small at ``--scale``), then on copies of
those tensors and on fresh standard-normal tensors of the same shape, so
that the data and the tensors' identity can be told apart.

Prints one JSON object per row and writes them all to ``--out`` (default
``build/bench_flash.json``).
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
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
L2_FLUSH_BYTES = 256 << 20  # read before each launch under --flush-l2 (the L2 is 50 MB)
# (B, T, S, H, K, hd, causal, dtype)
SHAPES = {
    "fraudgt": (1024, 17, 17, 8, 8, 16, True, "float32"),
    "fraudgt_train": (256, 17, 17, 8, 8, 16, True, "float32"),  # FraudGT.fit's batch of 256 edges
    "short_bf16": (1001, 17, 17, 8, 2, 32, False, "bfloat16"),  # the short path in two passes
    "long": (1, 4096, 4096, 32, 8, 128, True, "bfloat16"),
    "long_full": (1, 4096, 4096, 32, 8, 128, False, "bfloat16"),
    "long_hd64": (1, 4096, 4096, 32, 8, 64, True, "bfloat16"),
    "lm_prefill": (4, 2048, 2048, 12, 2, 128, True, "bfloat16"),  # qwen2-1.5b's prefill launch
    "lm_train": (4, 4096, 4096, 12, 2, 128, True, "bfloat16"),  # qwen2-1.5b's training launch
}
REPS = {"fraudgt": 200, "fraudgt_train": 200, "short_bf16": 200, "fraudgt_path": 200, "fraudgt_path_copies": 200,
        "fraudgt_path_randn": 200, "long": 20, "long_full": 20, "long_hd64": 20,
        "lm_prefill": 20, "lm_train": 20}


def bound_ms(b, t, s, h, kvh, hd, causal, dtype):
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * t * h * hd + 2 * b * s * kvh * hd) * size
    pairs = sum(min(i + 1, s) for i in range(t)) if causal else t * s
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * hd * pairs * b * h / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int, before=None) -> float:
    """Mean time of a call by CUDA events: ``reps`` calls in a row, or,
    given ``before``, each call timed alone after ``before()`` ran."""
    import torch

    fn()
    torch.cuda.synchronize()
    if before is not None:
        spans = []
        for _ in range(reps):
            before()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            spans.append((start, stop))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spans) / reps
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


def profiled_kernel_ms(fn, reps: int, before=None):
    """Mean device time per launch of each kernel ``fn`` launches (the
    wrapper launches one a call), over the launches the profiler recorded;
    ``before``, if given, runs ahead of each call (its kernels are listed
    too, under their own names)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    total, count = collections.defaultdict(float), collections.Counter()
    for ev in prof.events():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            total[ev.name] += ev.device_time_total / 1e3  # us -> ms
            count[ev.name] += 1
    return {name: total[name] / count[name] for name in total}


def bwd_bound_ms(b, t, s, h, kvh, hd, causal, dtype):
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (4 * b * t * h * hd + 4 * b * s * kvh * hd) * size + 4 * b * h * t
    pairs = sum(min(i + 1, s) for i in range(t)) if causal else t * s
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 5 * 2 * hd * pairs * b * h / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the long backward's kernels by a part of their names (the wgmma route's and
# the mma route's before it): the row pass, the dQ pass, the dK/dV pass
PASSES = (("row_dot", "rowdot"), ("dq", "_dq"), ("dkv", "_dkv"))


def run_one_bwd(src: str, names, out_rows: list, scale: float = 1.0, flush_l2: bool = False) -> None:
    import torch

    sys.path.insert(0, src)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for name in names:
        b, t, s, h, kvh, hd, causal, dtype = SHAPES[name]
        dt = getattr(torch, dtype)
        q, do = ((torch.randn((b, t, h, hd), generator=gen, device="cuda") * scale).to(dt) for _ in range(2))
        k, v = ((torch.randn((b, s, kvh, hd), generator=gen, device="cuda") * scale).to(dt) for _ in range(2))
        o, lse = fa_ops.flash_attention(q, k, v, causal=causal, block_k=s, return_lse=True)
        run = lambda: fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        got = run()
        g = h // kvh
        flat = lambda x, n: x.float().repeat_interleave(h // x.shape[2], 2).transpose(1, 2).reshape(b * h, n, hd)
        want = flash_attention_bwd_ref(flat(q, t), flat(k, s), flat(v, s), flat(o, t), flat(do, t),
                                       lse.reshape(b * h, t), causal=causal)
        fold = lambda x: x.reshape(b, kvh, g, s, hd).sum(2).transpose(1, 2)
        want = (want[0].reshape(b, h, t, hd).transpose(1, 2), fold(want[1]), fold(want[2]))
        err = max(float((x.float() - z).abs().max()) for x, z in zip(got, want))
        top = max(float(z.abs().max()) for z in want)
        del got, want
        torch.cuda.empty_cache()
        reps = REPS[name]
        flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda") if flush_l2 else None
        before = None if flush is None else flush.max
        kern = profiled_kernel_ms(run, reps, before)
        passes = {key: sum(v for n, v in kern.items() if "flash_bwd_kernel" in n and part in n)
                  for key, part in PASSES}
        path = fa_ops.bwd_plan(b, t, s, h, kvh, hd, dt, causal)
        route = getattr(fa_ops, "short_bwd_route", None)
        route = route(b, t, s, h, kvh, hd, dt, causal) if route and path == "short" else (None, None)
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                                   enable_gqa=h != kvh)
        do_t = do.transpose(1, 2)
        bound, by = bwd_bound_ms(b, t, s, h, kvh, hd, causal, dtype)
        row = {
            "src": src, "direction": "bwd", "shape": name, "input_scale": scale, "B": b, "T": t, "S": s, "H": h,
            "K": kvh, "hd": hd, "causal": causal, "dtype": dtype,
            "bwd_plan": path, "route": route[0], "stages": route[1],
            "max_abs_err": err, "max_rel_err": err / max(top, 1e-30),
            "l2_flushed": flush_l2,
            "ms": cuda_ms(run, reps, before),
            "kernel_ms": sum(v for n, v in kern.items() if "flash_bwd_kernel" in n),
            "passes": passes,
            "kernels": kern,
            "host_us": host_us(run, reps),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), do_t, retain_graph=True), reps),
            "bound_ms": bound, "bound_by": by,
        }
        if flush_l2:
            warm = profiled_kernel_ms(run, reps)
            row.update(l2_warm_ms=cuda_ms(run, reps),
                       l2_warm_kernel_ms=sum(v for n, v in warm.items() if "flash_bwd_kernel" in n))
        print(json.dumps(row), flush=True)
        out_rows.append(row)
        del q, k, v, o, do, lse, lib_out, qt, kt, vt, flush
        torch.cuda.empty_cache()


def ptxas_report(src: str) -> dict:
    """Registers a thread, stack frame and spills of every backward kernel
    of ``<src>/repro_torch/csrc/flash_attention.cu``, from ``nvcc -Xptxas
    -v`` with the package's own flags (compiled, not linked), and ptxas's
    warnings (``"warnings"``)."""
    import re
    import tempfile

    sys.path.insert(0, src)
    from repro_torch.kernels import build

    cu = Path(src) / "repro_torch" / "csrc" / "flash_attention.cu"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared",)]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([build.find_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(Path(tmp) / "x.o"),
                               str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"bench_flash.py: nvcc failed on {cu}:\n{proc.stderr[-4000:]}")
    out, name = {}, None
    # ptxas's own warnings and notes (wgmma serialised, registers) go with the report
    warnings = [line.strip() for line in proc.stderr.splitlines()
                if "warning" in line or "Performance" in line or "injected" in line]
    if warnings:
        out["warnings"] = warnings
    for line in proc.stderr.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w]+)'?", line)
        if m:
            name = m.group(1) if "flash_bwd_kernel" in m.group(1) else None
            continue
        if name is None:
            continue
        entry = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    return out


def fraudgt_inputs(fa_ops, data_scale: float):
    """q, k, v of FraudGT's first attention call over 1,024 test edges."""
    from repro_torch.data.loader import temporal_split
    from repro_torch.data.synth_aml import generate_aml_dataset
    from repro_torch.ml.fraudgt import FraudGT, FraudGTParams

    ds = generate_aml_dataset("HI-Small", seed=0, scale=data_scale)
    _, test_ids = temporal_split(ds)
    got = {}
    fn = fa_ops.flash_attention

    def capture(q, k, v, **kw):
        got.setdefault("qkv", (q, k, v))
        return fn(q, k, v, **kw)

    fa_ops.flash_attention = capture
    try:
        FraudGT(FraudGTParams(), seed=0, device="cuda").predict_proba(ds.graph, test_ids[:1024])
    finally:
        fa_ops.flash_attention = fn
    return got["qkv"]


def run_one(src: str, names, out_rows: list, scale: float = 1.0, data_scale: float = 28.0) -> None:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, src)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for name in names:
        if name != "fraudgt_path":
            cases.append((name, None))
            continue
        qkv = fraudgt_inputs(fa_ops, data_scale)
        cases += [("fraudgt_path", qkv), ("fraudgt_path_copies", tuple(x.clone() for x in qkv)),
                  ("fraudgt_path_randn", tuple(torch.randn(x.shape, generator=gen, device="cuda") for x in qkv))]
    for name, qkv in cases:
        b, t, s, h, kvh, hd, causal, dtype = SHAPES[name if qkv is None else "fraudgt"]
        dt = getattr(torch, dtype)
        if qkv is None:
            q = (torch.randn((b, t, h, hd), generator=gen, device="cuda") * scale).to(dt)
            k = (torch.randn((b, s, kvh, hd), generator=gen, device="cuda") * scale).to(dt)
            v = (torch.randn((b, s, kvh, hd), generator=gen, device="cuda") * scale).to(dt)
        else:
            q, k, v = qkv
        run = lambda: fa_ops.flash_attention(q, k, v, causal=causal, block_k=s)
        got = run()
        flat = lambda x, n: x.repeat_interleave(h // x.shape[2], 2).transpose(1, 2).reshape(b * h, n, hd)
        want = flash_attention_ref(flat(q, t), flat(k, s), flat(v, s), causal=causal)
        want = want.reshape(b, h, t, hd).transpose(1, 2)
        err = float((got.float() - want.float()).abs().max())
        reps = REPS[name]
        kern = profiled_kernel_ms(run, reps)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bound, by = bound_ms(b, t, s, h, kvh, hd, causal, dtype)
        plan = getattr(fa_ops, "plan", None)
        row = {
            "src": src, "shape": name, "input_scale": scale, "B": b, "T": t, "S": s, "H": h, "K": kvh, "hd": hd,
            "causal": causal, "dtype": dtype,
            "plan": plan(b, t, s, h, kvh, hd, dt, causal) if plan else "simt",
            "max_abs_err": err,
            "ms": cuda_ms(run, reps),
            "kernel_ms": sum(v for n, v in kern.items() if "flash" in n),
            "kernels": kern,
            "host_us": host_us(run, reps),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=h != kvh), reps),
            "bound_ms": bound, "bound_by": by,
        }
        print(json.dumps(row), flush=True)
        out_rows.append(row)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", help="src/ of a checkout (repeatable; default this one)")
    ap.add_argument("--shapes", default="fraudgt,long",
                    help=f"comma list of {sorted(SHAPES)} and fraudgt_path")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "bench_flash.json")
    ap.add_argument("--input-scale", type=float, default=1.0,
                    help="multiply the standard-normal q, k, v by this (the data's effect on the time)")
    ap.add_argument("--scale", type=float, default=28.0, help="HI-Small scale of fraudgt_path's data")
    ap.add_argument("--direction", choices=("fwd", "bwd"), default="fwd",
                    help="time flash_attention (fwd) or flash_attention_bwd (bwd)")
    ap.add_argument("--flush-l2", action="store_true",
                    help="with --direction bwd: time each launch after evicting its operands from L2")
    ap.add_argument("--ptxas", action="store_true",
                    help="also report each backward kernel's registers and spills (nvcc -Xptxas -v)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = args.shapes.split(",")
    if args.one:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("bench_flash.py: no CUDA device")
        rows: list = []
        if args.ptxas:
            print(json.dumps({"src": args.one, "ptxas": ptxas_report(args.one)}), flush=True)
        if args.direction == "bwd":
            run_one_bwd(args.one, names, rows, args.input_scale, args.flush_l2)
        else:
            run_one(args.one, names, rows, args.input_scale, args.scale)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    rows = []
    seen = set()
    for src in args.src or [str(ROOT / "src")]:
        src = str(Path(src).resolve())
        ptxas = args.ptxas and src not in seen  # once for each checkout
        seen.add(src)
        proc = subprocess.run([sys.executable, __file__, "--one", src,
                               "--shapes", args.shapes, "--input-scale", str(args.input_scale),
                               "--scale", str(args.scale), "--direction", args.direction,
                               *(["--ptxas"] if ptxas else []), *(["--flush-l2"] if args.flush_l2 else [])],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            raise SystemExit(f"bench_flash.py: {src} failed (exit {proc.returncode})")
        for line in proc.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                rows.append({**json.loads(line), "card": card})
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
