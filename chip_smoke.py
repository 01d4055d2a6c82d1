#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py                 # HI-Small at its published size
    python3 chip_smoke.py --scale 28      # a tenth of it, for a quick look

Phases, in order; any failure exits non-zero:

1. build  — compile every CUDA kernel of the port from
   ``src/repro_torch/csrc`` (nvcc, sm_90a; one nvcc per source, all
   started together) and print the card's name and power limit as
   ``nvidia-smi`` reports them.
2. kernel — hold each kernel to its plain PyTorch version on the card:
   ``intersect_count`` bit for bit over the bucket-ladder shapes, both
   ``ordered`` modes, ragged batch sizes and the hand-built edge cases;
   both entries of ``hist_update`` (``keys`` and ``rows``) bit for bit
   equal to the plain fixed-point replay (``ref.fixed_point_ref``), within
   their stated error bound of the plain version in float64, and
   bit-identical across two launches, at the shapes of
   ``tests/test_kernels.py``, the edge cases, one shape for each cluster
   size (1, 2, 4, 8, 16 blocks) and one past the cluster limit, hot keys
   (every row on one key; 90 % of rows on 1 % of the keys) and the fit's
   level shapes S = 3,072 * 2^L, L = 0..5; ``window_degree`` bit for
   bit at the ``tests/test_kernels.py`` shapes and (16384, 128);
   ``flash_attention`` within 2e-5 (float32) or 2e-2 (bfloat16) at the
   cases of ``tests/test_flash_attention.py``, causal attention over fewer
   keys than queries, FraudGT's shape and the short path in bf16 with
   GQA, and long bfloat16 shapes on the wgmma path (causal and not, hd 64
   and 128, ragged tiles); each row logs the path ``ops.plan`` picked,
   which must be the ``.cu`` entry's, and both the short and the wgmma
   path must be reached.  Each shape is timed with CUDA events beside its
   bound, the plain version and, where one PyTorch call computes the same
   function, that call; ``flash_attention`` also under ``torch.profiler``
   (``kernel_ms``, the kernel without the wrapper's host work).
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
5. detection path — ``run_aml_pipeline(ds, "full")`` (mine, features,
   the default 60-tree GBDT, F1 on the last 20% by time) under
   ``set_sync_debug_mode("error")``, then ``"xgb_only"``, at the same
   size.  The launch counts are zeroed before each and read after; each
   fit must launch ``hist_update`` n_trees * (max_depth + 1) = 420 times,
   n_trees * max_depth = 360 of them through the ``rows`` entry (one per
   level) and the rest the leaf sums, and the pipeline's mined columns
   must equal phase 3's count matrix.  The first launch of each shape of
   the ``"full"`` fit is kept for phase 8.
6. detection cross-checks — two 10-tree fits on the card over the first
   1,048,576 training rows give bit-identical trees and probabilities,
   and a 10-tree fit on the card over 262,144 rows splits as the CPU
   port's does, or differs first at a near tie of the two gains.
7. FraudGT inference — ``FraudGT(FraudGTParams(), seed=0).predict_proba``
   over the test split (the last 20 % by time) under
   ``set_sync_debug_mode("error")``: tokenize on the host, then the graph
   transformer on the card, every block's attention through
   ``flash_attention``, which must launch n_layers * ceil(n_test / 1024)
   times.  Cross-checks on the first 16,384 test edges: the ``"kernel"``
   and ``"torch"`` attention backends agree within 1e-5 in the logits, the
   card within 1e-4 of the CPU port with the same weights, and the tokens
   are bit-identical to a CPU ``tokenize``.  Then the forward over the
   first 131,072 test edges under ``torch.profiler``: the device's busy
   share and the kernels that take its time.
8. report — each kernel checked and timed at the shapes its main path
   gave it (``hist_update``'s ``rows`` entry at every level of the fit,
   its ``keys`` entry at the leaf sums and on the keys the fit would build
   at every level), then a ``{"kernels": [...]}`` line (launches on the
   main paths, max difference from the plain version, kernel / plain /
   bound / library times at the main path's largest launch), the card
   line, and last ``{"ok": true, "device": {...}}``.  The full record
   goes to ``build/chip_smoke.json``.

It imports torch, numpy and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the non-tensor-core
# rate; one pair test of intersect_count, one addition of hist_update and
# one compare-and-add of window_degree are each counted as one operation;
# flash_attention's flops count against float32 (67 T/s, no TF32: float32
# results stay float32) or the dense bf16 tensor-core peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12
KERNELS = ("intersect_count", "hist_update", "window_degree", "flash_attention")
SMOKE_SHAPES = ((1, 4), (1, 1024), (4, 4), (16, 64), (64, 256), (256, 256), (1024, 1024))
RAGGED_B = (1, 33, 4097)
HU_SHAPES = ((16, 8), (1000, 97), (4096, 512), (513, 2048), (1, 1), (0, 64))  # (N, S)
# hist_update's keys entry: each cluster size (the kernel holds 14,528
# keys a block, in clusters of 1, 2, 4, 8 or 16 blocks) and past the limit
HU_CLUSTER_SHAPES = tuple((1 << 20, s) for s in (14_528, 14_529, 29_057, 58_113, 116_225, 232_448, 232_449))
HU_LEVEL_S = tuple(3072 << lv for lv in range(6))  # the fit's levels at F = 12, B = 256
# hist_update's rows entry (N rows, F, B, n_nodes): the fit's levels, a
# 16-block cluster, past the limit, narrow shapes and zero rows
HU_ROWS_SHAPES = (
    *((1 << 19, 12, 256, 1 << lv) for lv in range(6)),
    (1 << 18, 12, 256, 64),
    (1 << 17, 12, 256, 128),
    (1000, 1, 16, 2),
    (4097, 3, 7, 5),
    (0, 12, 256, 4),
)
WD_SHAPES = ((1, 1), (7, 16), (64, 128), (100, 33), (16384, 128))  # (B, D)
WINDOW = 4096
SEED = 0  # data seed
CPU_SEEDS = 4096  # seeds the CPU cross-check mines
DET_ROWS = 1 << 20  # training rows of the card's determinism fits
CPU_FIT_ROWS = 1 << 18  # training rows of the card-against-CPU fits
CHECK_TREES = 10  # trees of each cross-check fit
FGT_CHECK_EDGES = 16384  # test edges of the FraudGT cross-checks
FGT_PROFILE_EDGES = 1 << 17  # test edges of the profiled FraudGT forward
# flash_attention cases (B, T, S, H, K, hd, causal, dtype): those of
# tests/test_flash_attention.py (its hypothesis test is drawn for seeds
# 0-7 in phase_flash_attention and put after them), causal T > S with S
# unaligned, FraudGT's shape (the short path), the short path with GQA in
# bf16, and the wgmma path: a long bf16 shape causal and not, at hd 64,
# and with ragged tiles (1,000 rows and keys)
FA_TEST_CASES = 11  # the first 11 are tests/test_flash_attention.py's
FA_CASES = (
    *((2, t, t, 4, 4, 32, c, "float32") for t in (64, 128, 256) for c in (True, False)),
    (1, 128, 128, 8, 2, 64, True, "float32"),
    (1, 128, 128, 4, 4, 64, True, "bfloat16"),
    (1, 96, 96, 2, 2, 32, True, "float32"),
    (1, 256, 256, 1, 1, 32, True, "float32"),
    (2, 80, 50, 4, 2, 16, True, "float32"),
    (1024, 17, 17, 8, 8, 16, True, "float32"),  # FraudGT: 1,024 edges x 8 heads
    (1001, 17, 17, 8, 2, 32, False, "bfloat16"),
    (1, 4096, 4096, 32, 8, 128, True, "bfloat16"),
    (1, 4096, 4096, 32, 8, 128, False, "bfloat16"),
    (1, 4096, 4096, 32, 8, 64, True, "bfloat16"),
    (2, 1000, 1000, 8, 2, 128, True, "bfloat16"),
)
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


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


def bound_ms(nbytes: int, ops: int, peak_ops: float = PEAK_OPS_PER_S):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger, and which."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ic_bound_ms(b: int, da: int, db: int):
    return bound_ms(b * (8 * da + 8 * db + 20), b * da * db)


def hu_bound_ms(n: int, s: int):
    # keys and gh rows read once, the (S, 2) float32 sums written once
    return bound_ms(n * 12 + s * 8, 2 * n)


def hu_rows_bound_ms(n: int, f: int, s: int):
    # each row's F bins, node id and gh pair read once, the sums written once
    return bound_ms(n * (f + 12) + s * 8, 2 * n * f)


def wd_bound_ms(b: int, d: int):
    return bound_ms(b * (4 * d + 12), b * d)


def fa_bound_ms(b, t, s, h, kvh, hd, causal, dtype):
    """q, k, v read once and o written once; 4 * hd flops per (row, key)
    pair that the mask lets through."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * t * h * hd + 2 * b * s * kvh * hd) * size
    pairs = sum(min(i + 1, s) for i in range(t)) if causal else t * s
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_OPS_PER_S
    return bound_ms(nbytes, 4 * hd * pairs * b * h, peak)


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


def hu_hold(a, b, replay, exact, bound, what: str) -> float:
    """Hold two launches of a hist_update entry to each other and to the
    plain fixed-point replay bit for bit, and to the float64 plain version
    within the stated error bound; returns the largest |difference| from
    the float64 sums."""
    import torch

    if not torch.equal(a, b):
        raise AssertionError(f"hist_update gave other bits on a second launch at {what}")
    if not torch.equal(a, replay):
        bad = int((a != replay).sum())
        raise AssertionError(f"hist_update differs from its fixed-point replay at {what} in {bad} entries")
    diff = (a.double() - exact).abs()
    over = diff > bound
    if bool(over.any()):
        raise AssertionError(f"hist_update outside its error bound at {what}: "
                             f"{int(over.sum())} entries, max |diff| {float(diff.max()):.3g}")
    return float(diff.max()) if diff.numel() else 0.0


def hu_check(keys, gh, s: int) -> float:
    """The keys entry, held as ``hu_hold`` says."""
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.hist_update.ref import fixed_point_ref, hist_update_ref

    n = keys.shape[0]
    return hu_hold(hu_ops.hist_update(keys, gh, s), hu_ops.hist_update(keys, gh, s),
                   fixed_point_ref(keys, gh, s, n), hist_update_ref(keys, gh.double(), s),
                   hu_ops.error_bound(keys, gh, s), f"N={n} S={s}")


def hu_rows_check(xb, node, gh, n_nodes: int, n_bins: int) -> float:
    """The rows entry, held as ``hu_hold`` says; the replay sums the keys
    and repeated gh that the plain version builds, at the scale of the N
    rows."""
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.hist_update.ref import fixed_point_ref, hist_update_rows_ref, row_keys

    n, f = xb.shape
    s = n_nodes * f * n_bins
    replay = fixed_point_ref(row_keys(xb, node, n_bins), gh[:, None, :].expand(n, f, 2).reshape(-1, 2), s, n)
    return hu_hold(hu_ops.hist_update_rows(xb, node, gh, n_nodes, n_bins),
                   hu_ops.hist_update_rows(xb, node, gh, n_nodes, n_bins),
                   replay.reshape(n_nodes, f, n_bins, 2),
                   hist_update_rows_ref(xb, node, gh.double(), n_nodes, n_bins),
                   hu_ops.error_bound_rows(xb, node, gh, n_nodes, n_bins), f"rows N={n} F={f} S={s}")


def hu_times(keys, gh, s: int, reps: int) -> dict:
    """Kernel, plain version (float32) and library call (one index_add_,
    into a spare row for the keys it must drop) on the same inputs."""
    import torch
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.hist_update.ref import hist_update_ref

    n = keys.shape[0]
    safe = torch.where((keys >= 0) & (keys < s), keys, s)
    lib_out = torch.zeros((s + 1, 2), dtype=torch.float32, device=keys.device)
    bound, by = hu_bound_ms(n, s)
    return {
        "ms": cuda_ms(lambda: hu_ops.hist_update(keys, gh, s), reps),
        "plain_ms": cuda_ms(lambda: hist_update_ref(keys, gh, s), reps),
        "library_ms": cuda_ms(lambda: lib_out.index_add_(0, safe, gh), reps),
        "bound_ms": bound,
        "bound_by": by,
    }


def hu_rows_times(xb, node, gh, n_nodes: int, n_bins: int, reps: int) -> dict:
    """The rows entry, its plain version (key build, repeat and segment
    sum in float32) and the library call: one index_add_ of the repeated
    gh on prebuilt keys (the key build and the repeat not counted)."""
    import torch
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.hist_update.ref import hist_update_rows_ref, row_keys

    n, f = xb.shape
    s = n_nodes * f * n_bins
    keys = row_keys(xb, node, n_bins)
    safe = torch.where((keys >= 0) & (keys < s), keys, s)
    gh_rep = gh[:, None, :].expand(n, f, 2).reshape(-1, 2)
    lib_out = torch.zeros((s + 1, 2), dtype=torch.float32, device=xb.device)
    bound, by = hu_rows_bound_ms(n, f, s)
    return {
        "ms": cuda_ms(lambda: hu_ops.hist_update_rows(xb, node, gh, n_nodes, n_bins), reps),
        "plain_ms": cuda_ms(lambda: hist_update_rows_ref(xb, node, gh, n_nodes, n_bins), reps),
        "library_ms": cuda_ms(lambda: lib_out.index_add_(0, safe, gh_rep), reps),
        "bound_ms": bound,
        "bound_by": by,
    }


def hu_keys_cases(gen, device):
    """(name, N, S, keys) of phase 2's keys-entry cases: keys in [-2, S+2)
    as tests/test_kernels.py draws them, each cluster size, the fit's
    level shapes, and hot keys."""
    import torch

    def ri(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=device, dtype=torch.int32)

    for n, s in HU_SHAPES + HU_CLUSTER_SHAPES + tuple((1 << 22, s) for s in HU_LEVEL_S):
        yield "uniform", n, s, ri(-2, s + 2, n)
    s = HU_LEVEL_S[-1]
    yield "one key", 1 << 20, s, torch.full((1 << 20,), 4321, dtype=torch.int32, device=device)
    hot = ri(0, s // 100, 1 << 22)  # 90 % of rows on 1 % of the keys
    yield "hot 90/1", 1 << 22, s, torch.where(torch.rand(1 << 22, generator=gen, device=device) < 0.9,
                                              hot, ri(0, s, 1 << 22))


def hu_rows_cases(gen, device):
    """(name, xb, node, n_nodes, n_bins) of phase 2's rows-entry cases:
    uniform bins and nodes at each shape of HU_ROWS_SHAPES, then hot keys
    at level 5: every row on node 0 and bin 0, and bins drawn from a
    skewed law (90 % bin 0) as the mined counts are."""
    import torch

    for n, f, b, n_nodes in HU_ROWS_SHAPES:
        xb = torch.randint(0, b, (n, f), generator=gen, device=device, dtype=torch.int32).to(torch.uint8)
        node = torch.randint(0, n_nodes, (n,), generator=gen, device=device, dtype=torch.int32)
        yield "uniform", xb, node, n_nodes, b
    n, f, b, n_nodes = 1 << 19, 12, 256, 32
    yield ("one key", torch.zeros((n, f), dtype=torch.uint8, device=device),
           torch.zeros(n, dtype=torch.int32, device=device), n_nodes, b)
    xb = torch.randint(0, b, (n, f), generator=gen, device=device, dtype=torch.int32).to(torch.uint8)
    xb = torch.where(torch.rand((n, f), generator=gen, device=device) < 0.9, 0, xb).to(torch.uint8)
    yield "hot 90 % bin 0", xb, torch.randint(0, n_nodes, (n,), generator=gen, device=device,
                                              dtype=torch.int32), n_nodes, b


def phase_hist_update(device, report) -> float:
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    max_err = 0.0
    rows = []
    for name, n, s, keys in hu_keys_cases(gen, device):
        gh = torch.randn((n, 2), generator=gen, device=device)
        err = hu_check(keys, gh, s)
        max_err = max(max_err, err)
        row = {"entry": "keys", "case": name, "N": n, "S": s, "max_abs_err": err, **hu_times(keys, gh, s, 10)}
        rows.append(row)
        log("kernel timing: hist_update " + json.dumps(row))
    for name, xb, node, n_nodes, b in hu_rows_cases(gen, device):
        n, f = xb.shape
        gh = torch.randn((n, 2), generator=gen, device=device)
        err = hu_rows_check(xb, node, gh, n_nodes, b)
        max_err = max(max_err, err)
        row = {"entry": "rows", "case": name, "N": n, "F": f, "B": b, "n_nodes": n_nodes, "S": n_nodes * f * b,
               "max_abs_err": err, **hu_rows_times(xb, node, gh, n_nodes, b, 10)}
        rows.append(row)
        log("kernel timing: hist_update_rows " + json.dumps(row))
    report["hist_update_shapes"] = rows
    log(f"kernel: hist_update (keys and rows entries) bit-identical to its fixed-point replay and across "
        f"launches, and within its error bound of the float64 plain version, on {len(rows)} cases "
        f"(max |diff| {max_err:.3g})")
    return max_err


def phase_window_degree(device, report):
    import torch
    from repro_torch.kernels.window_degree import ops as wd_ops
    from repro_torch.kernels.window_degree.ref import window_degree_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(2)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    rows = []
    for b, d in WD_SHAPES:
        pad = torch.rand((b, d), generator=gen, device=device) < 0.25
        t = torch.where(pad, wd_ops.PAD_T, ri(0, 128, (b, d)))
        lo = ri(0, 64, (b,))
        hi = lo + ri(0, 64, (b,))
        if not torch.equal(wd_ops.window_degree(t, lo, hi), window_degree_ref(t, lo, hi)):
            raise AssertionError(f"window_degree differs from its plain version at B={b} D={d}")
        bound, by = wd_bound_ms(b, d)
        row = {"B": b, "D": d, "max_abs_err": 0,
               "ms": cuda_ms(lambda: wd_ops.window_degree(t, lo, hi), 20),
               "plain_ms": cuda_ms(lambda: window_degree_ref(t, lo, hi), 20),
               "library_ms": None, "bound_ms": bound, "bound_by": by}
        rows.append(row)
        log("kernel timing: window_degree " + json.dumps(row))
    report["window_degree_shapes"] = rows
    log(f"kernel: window_degree == plain version on {len(WD_SHAPES)} shapes")
    return rows[-1]


def fa_plain(q, k, v, causal):
    """flash_attention's plain version on (B, T, H, hd) / (B, S, K, hd):
    the K/V heads repeated, then the explicit-op reference."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    b, t, h, hd = q.shape
    s = k.shape[1]
    flat = lambda x, n: x.repeat_interleave(h // x.shape[2], 2).transpose(1, 2).reshape(b * h, n, hd)
    out = flash_attention_ref(flat(q, t), flat(k, s), flat(v, s), causal=causal)
    return out.reshape(b, h, t, hd).transpose(1, 2)


def kernel_device_ms(fn, reps: int, match: str = "flash_fwd_kernel"):
    """Mean device time of the launches of kernels named ``match`` that
    ``fn`` makes (one a call), under ``torch.profiler`` (the wrapper's host
    work left out), and how many of the ``reps`` launches the profiler
    recorded: the mean is over those it recorded."""
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
    if not us:
        raise AssertionError(f"the profiler saw no kernel named {match!r}")
    return sum(us) / 1e3 / len(us), len(us)


def fa_row(q, k, v, causal, reps) -> dict:
    """flash_attention against its plain version (max |diff|, within the
    dtype's tolerance), the path it took (``ops.plan``, which must equal
    the ``.cu`` entry's choice), and kernel / plain / library times with
    the bound: ``ms`` under CUDA events over wrapper calls, ``kernel_ms``
    the kernel's own mean device time under ``torch.profiler`` (over the
    ``kernel_launches_profiled`` of the ``reps`` launches it recorded).
    The library call is one ``F.scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops

    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    path = fa_ops.plan(b, t, s, h, kvh, hd, q.dtype, causal)
    if fa_ops.kernel_plan(b, t, s, h, kvh, hd, q.dtype, causal) != path:
        raise AssertionError(f"ops.plan and the .cu entry choose different paths at {tuple(q.shape)}")
    got = fa_ops.flash_attention(q, k, v, causal=causal, block_k=s)
    err = float((got.float() - fa_plain(q, k, v, causal).float()).abs().max())
    if not err <= FA_TOL[dtype]:
        raise AssertionError(f"flash_attention differs from its plain version at {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, causal={causal}: {err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bound, by = fa_bound_ms(b, t, s, h, kvh, hd, causal, dtype)
    run = lambda: fa_ops.flash_attention(q, k, v, causal=causal, block_k=s)
    kernel_ms, seen = kernel_device_ms(run, reps)
    return {"B": b, "T": t, "S": s, "H": h, "K": kvh, "hd": hd, "causal": causal, "dtype": dtype,
            "plan": path, "max_abs_err": err,
            "ms": cuda_ms(run, reps),
            "kernel_ms": kernel_ms, "kernel_launches_profiled": seen,
            "plain_ms": cuda_ms(lambda: fa_plain(q, k, v, causal), max(3, reps // 10)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=h != kvh), reps),
            "bound_ms": bound, "bound_by": by}


def phase_flash_attention(device, report):
    import numpy as np
    import torch

    cases = list(FA_CASES)
    for seed in range(8):  # tests/test_flash_attention.py::test_hypothesis_random
        rng = np.random.default_rng(seed)
        t, h, hd = int(rng.choice([64, 128, 192])), int(rng.choice([1, 2, 4])), int(rng.choice([16, 32, 64]))
        cases.insert(FA_TEST_CASES + seed, (1, t, t, h, h, hd, bool(rng.integers(0, 2)), "float32"))
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    rows = []
    for b, t, s, h, kvh, hd, causal, dtype in cases:
        dt = getattr(torch, dtype)
        q = torch.randn((b, t, h, hd), generator=gen, device=device).to(dt)
        k = torch.randn((b, s, kvh, hd), generator=gen, device=device).to(dt)
        v = torch.randn((b, s, kvh, hd), generator=gen, device=device).to(dt)
        row = fa_row(q, k, v, causal, 20)
        rows.append(row)
        log("kernel timing: flash_attention " + json.dumps(row))
    report["flash_attention_shapes"] = rows
    reached = {r["plan"] for r in rows}
    if not {"short", "wgmma"} <= reached:
        raise AssertionError(f"the flash_attention cases reached only the paths {sorted(reached)}")
    worst = {d: max(r["max_abs_err"] for r in rows if r["dtype"] == d) for d in FA_TOL}
    log(f"kernel: flash_attention within {FA_TOL} of its plain version on {len(rows)} cases "
        f"(max |diff| {worst})")
    return worst


def profile_forward(ft, toks) -> dict:
    """FraudGT's forward over ``toks`` timed alone and then under
    ``torch.profiler``: device kernel time, the device's busy share of
    the wall (one stream, so kernels do not overlap), the
    ``flash_attention`` kernel's share and the top kernels by device time."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ft.logits(*toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ft.logits(*toks)
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0
    kern = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kern[ev.name][0] += ev.device_time_total / 1e6  # us -> s
            kern[ev.name][1] += 1
    busy = sum(v[0] for v in kern.values())
    # every path's kernel is named flash_fwd_kernel* (short, wgmma, or the CUDA-core one)
    flash = sum(v[0] for k, v in kern.items() if "flash_fwd_kernel" in k)
    if not flash:
        raise AssertionError("the profiled FraudGT forward shows no flash_fwd_kernel launch")
    return {
        "edges": int(len(toks[0])),
        "wall_s": wall,
        "wall_profiled_s": wall_profiled,
        "device_kernel_s": busy,
        "device_busy_share": busy / wall_profiled if wall_profiled else None,
        "kernel_launches": sum(v[1] for v in kern.values()),
        "flash_attention_kernel_s": flash,
        "flash_attention_share_of_device": flash / busy if busy else None,
        "top_kernels": [{"name": k[:100], "s": v[0], "count": v[1]}
                        for k, v in sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]],
    }


def phase_fraudgt(ds, device, report, zero_launches, read_launches):
    """FraudGT inference over the test split on the card, its launch count
    and its cross-checks; returns the launch counts and the arguments of
    the path's first (largest) flash_attention launch."""
    import numpy as np
    import torch
    from repro_torch.data.loader import temporal_split
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.ml.fraudgt import FraudGT, FraudGTParams

    g = ds.graph
    _, test_ids = temporal_split(ds)
    n_test = len(test_ids)
    fgt_params = FraudGTParams()
    ft = FraudGT(fgt_params, seed=0, device=device)
    fa_fn = fa_ops.flash_attention
    fa_path = {}  # the first launch: 1,024 edges, the path's largest

    def capture_fa(q, k, v, **kw):
        fa_path.setdefault("args", (q, k, v, kw.get("causal", True)))
        return fa_fn(q, k, v, **kw)

    fa_ops.flash_attention = capture_fa
    zero_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        proba = ft.predict_proba(g, test_ids)
        total_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        fa_ops.flash_attention = fa_fn
    fgt_launches = read_launches()
    want_launches = fgt_params.n_layers * math.ceil(n_test / 1024)
    fgt = {"n_test": n_test, "tokenize_s": ft.seconds["tokenize"], "forward_s": ft.seconds["forward"],
           "total_s": total_s, "edges_per_s": n_test / total_s, "launches": fgt_launches,
           "expected_flash_launches": want_launches,
           "proba_mean": float(proba.mean()), "proba_min": float(proba.min()), "proba_max": float(proba.max())}
    log("FraudGT inference: " + json.dumps(fgt))
    if fgt_launches["flash_attention"] != want_launches:
        raise AssertionError(f"FraudGT launched flash_attention {fgt_launches['flash_attention']} times, "
                             f"not {want_launches}")
    if proba.shape != (n_test,) or not np.all(np.isfinite(proba)) or not np.all((proba >= 0) & (proba <= 1)):
        raise AssertionError(f"FraudGT probabilities of shape {proba.shape} are not finite values in [0, 1]")
    sub = test_ids[:FGT_CHECK_EDGES]
    toks = ft.tokenize(g, sub)
    on_cpu = FraudGT(fgt_params, seed=0, device="cpu")
    t0 = time.perf_counter()
    toks_cpu = on_cpu.tokenize(g, sub)
    cpu_tok_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(toks, toks_cpu)):
        raise AssertionError("the card run's tokens differ from a CPU tokenize")
    logit_k = ft.logits(*toks)
    logit_t = FraudGT(fgt_params, seed=0, device=device, attn_backend="torch").logits(*toks)
    t0 = time.perf_counter()
    logit_c = on_cpu.logits(*toks_cpu)
    cpu_fwd_s = time.perf_counter() - t0
    check = {"edges": int(len(sub)),
             "kernel_vs_torch_max_abs": float((logit_k - logit_t).abs().max()),
             "card_vs_cpu_max_abs": float((logit_k.cpu() - logit_c).abs().max()),
             "run_vs_rescore_max_abs": float(np.abs(proba[: len(sub)] - torch.sigmoid(logit_k).cpu().numpy()).max()),
             "logit_abs_max": float(logit_k.abs().max()), "tokens_equal": True,
             "cpu_tokenize_s": cpu_tok_s, "cpu_forward_s": cpu_fwd_s}
    fgt["cross_checks"] = check
    report["fraudgt"] = fgt
    log("FraudGT cross-checks: " + json.dumps(check))
    if not check["kernel_vs_torch_max_abs"] <= 1e-5:
        raise AssertionError(f'the "kernel" and "torch" attention backends disagree: {check}')
    if not check["card_vs_cpu_max_abs"] <= 1e-4:
        raise AssertionError(f"the card's FraudGT logits differ from the CPU port's: {check}")
    if not check["run_vs_rescore_max_abs"] <= 1e-6:
        raise AssertionError(f"the predict_proba run disagrees with rescoring its first edges: {check}")
    fgt["profile"] = profile_forward(ft, ft.tokenize(g, test_ids[:FGT_PROFILE_EDGES]))
    log("FraudGT forward profile: " + json.dumps(fgt["profile"]))
    return fgt_launches, fa_path["args"]



def same_trees(a, b) -> bool:
    """Bit-equal splits, gains and leaves."""
    import numpy as np

    return len(a.trees) == len(b.trees) and all(
        all(np.array_equal(p, q) for p, q in zip(ta[0] + ta[1] + [ta[2], ga], tb[0] + tb[1] + [tb[2], gb]))
        for ta, tb, ga, gb in zip(a.trees, b.trees, a.gains, b.gains)
    )


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
    from repro_torch.core.features import base_features
    from repro_torch.data.loader import temporal_split
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.hist_update.ref import row_keys
    from repro_torch.kernels.intersect_count import ops as ic_ops
    from repro_torch.kernels.window_degree import ops as wd_ops
    from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams, first_split_difference
    from repro_torch.ml.pipeline import FEATURE_SETS, run_aml_pipeline

    device = torch.device("cuda")
    report = {"scale": args.scale, "seed": SEED}

    def zero_launches():
        ic_ops.launches = hu_ops.launches = hu_ops.rows_launches = wd_ops.launches = fa_ops.launches = 0

    def read_launches():
        # "hist_update" counts both of its entries, "hist_update_rows" the rows entry alone
        return {"intersect_count": ic_ops.launches, "hist_update": hu_ops.launches,
                "hist_update_rows": hu_ops.rows_launches,
                "window_degree": wd_ops.launches, "flash_attention": fa_ops.launches}

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.load, KERNELS))
    report["build_s"] = time.perf_counter() - t0
    report["nvcc_s"] = {k: build.build_seconds[k] for k in KERNELS}
    card = card_line()
    report["card"] = card
    log(f"build: {', '.join(KERNELS)} from src/repro_torch/csrc in {report['build_s']:.2f} s "
        f"(nvcc in parallel: {json.dumps(report['nvcc_s'])})")
    log(f"card: {card}")

    # ---- 2. kernels against their plain versions ----------------------
    max_err = phase_kernel(device, report)
    hu_err = phase_hist_update(device, report)
    wd_row = phase_window_degree(device, report)
    fa_err = phase_flash_attention(device, report)

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
    zero_launches()
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
    main_launches = read_launches()
    launches = main_launches["intersect_count"]
    n_compiled = len(session._compiled)
    main = {
        "patterns": list(pats),
        "n_seeds": int(cold.n_seeds),
        "cold_s": cold_s,
        "warm_s": warm_s,
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
        "launches": main_launches,
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

    # ---- 5. detection path at the same size ---------------------------
    params = GBDTParams()
    fit_launches = params.n_trees * (params.max_depth + 1)
    rows_fit_launches = params.n_trees * params.max_depth
    hu_fn, hu_rows_fn = hu_ops.hist_update, hu_ops.hist_update_rows
    hu_path = {}  # (N, S) -> the first keys-entry launch of each shape the fit makes
    hu_rows_path = {}  # (N, S) -> the first rows-entry launch of each shape

    def capture_hu(keys, gh, s):
        hu_path.setdefault((keys.shape[0], s), (keys, gh, s))
        return hu_fn(keys, gh, s)

    def capture_hu_rows(xb, node, gh, n_nodes, n_bins):
        hu_rows_path.setdefault((xb.shape[0], n_nodes * xb.shape[1] * n_bins), (xb, node, gh, n_nodes, n_bins))
        return hu_rows_fn(xb, node, gh, n_nodes, n_bins)

    detection = {}
    results = {}
    for fs in ("full", "xgb_only"):
        if fs == "full":
            hu_ops.hist_update, hu_ops.hist_update_rows = capture_hu, capture_hu_rows
        zero_launches()
        if fs == "full":
            torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            res = run_aml_pipeline(ds, fs)
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
            hu_ops.hist_update, hu_ops.hist_update_rows = hu_fn, hu_rows_fn
        results[fs] = res
        row = {"f1": res.f1, "precision": res.precision, "recall": res.recall, "confusion": res.confusion,
               "mine_seconds": res.mine_seconds, "train_seconds": res.train_seconds,
               "fit_seconds": res.fit_seconds, "wall_s": wall, "n_train": res.n_train, "n_test": res.n_test,
               "launches": read_launches(),
               "mine_host_syncs": res.mining.stats["host_syncs"] if res.mining else 0}
        detection[fs] = row
        log(f"detection path ({fs}): " + json.dumps(row))
        if row["launches"]["hist_update"] != fit_launches:
            raise AssertionError(f"the {fs} fit launched hist_update {row['launches']['hist_update']} "
                                 f"times, not {fit_launches}")
        if row["launches"]["hist_update_rows"] != rows_fit_launches:
            raise AssertionError(f"the {fs} fit launched the rows entry {row['launches']['hist_update_rows']} "
                                 f"times, not {rows_fit_launches}")
        if not 0.0 <= res.f1 <= 1.0 or res.n_train + res.n_test != g.n_edges:
            raise AssertionError(f"{fs}: F1 {res.f1} or split {res.n_train}+{res.n_test} out of range")
    mined = results["full"].mining
    if mined.columns != FEATURE_SETS["full"] or not np.array_equal(mined.counts, counts):
        raise AssertionError("the pipeline's mined columns differ from phase 3's count matrix")
    if results["full"].f1 <= 0.0:
        raise AssertionError("the full feature set detected nothing")
    report["detection"] = detection

    # ---- 6. detection cross-checks ------------------------------------
    x = np.concatenate([base_features(g), counts.astype(np.float32)], axis=1)
    y = ds.labels.astype(np.float32)
    train_ids, _ = temporal_split(ds)
    small = GBDTParams(n_trees=CHECK_TREES)
    rows = train_ids[:DET_ROWS]
    t0 = time.perf_counter()
    fit_a = GBDTClassifier(small).fit(x[rows], y[rows])
    fit_b = GBDTClassifier(small).fit(x[rows], y[rows])
    det_s = time.perf_counter() - t0
    proba_a, proba_b = fit_a.predict_proba(x[rows]), fit_b.predict_proba(x[rows])
    if not same_trees(fit_a, fit_b) or not np.array_equal(proba_a, proba_b):
        raise AssertionError(f"two fits on the card differ: {first_split_difference(fit_a, fit_b, len(rows))}")
    rows = train_ids[:CPU_FIT_ROWS]
    t0 = time.perf_counter()
    on_card = GBDTClassifier(small).fit(x[rows], y[rows])
    card_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = GBDTClassifier(small, device="cpu").fit(x[rows], y[rows])
    cpu_fit_s = time.perf_counter() - t0
    diff = first_split_difference(on_card, on_cpu, len(rows))
    check = {"determinism_rows": int(min(DET_ROWS, len(train_ids))), "determinism_s": det_s,
             "determinism_equal": True, "cpu_rows": int(len(rows)), "card_fit_s": card_fit_s,
             "cpu_fit_s": cpu_fit_s, "first_difference": diff}
    if diff is None:
        check["leaf_max_abs_diff"] = max(float(np.abs(ta[2] - tb[2]).max())
                                         for ta, tb in zip(on_card.trees, on_cpu.trees))
        check["proba_max_abs_diff"] = float(np.abs(on_card.predict_proba(x[rows])
                                                   - on_cpu.predict_proba(x[rows])).max())
    report["detection_cross_checks"] = check
    log("detection cross-checks: " + json.dumps(check))
    if diff is not None and not diff["near_tie"]:
        raise AssertionError(f"the card and the CPU split differently where the gains are no near tie: {diff}")

    # ---- 7. FraudGT inference ----------------------------------------
    fgt_launches, fa_args = phase_fraudgt(ds, device, report, zero_launches, read_launches)

    # ---- 8. report -----------------------------------------------------
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
    # hist_update on the detection path: the rows entry at every level of
    # the fit and the keys entry at the leaf sums, each as the fit launched
    # it; then the keys entry on the keys and repeated gh that the fit
    # would build at every level, which is where it ran before the rows
    # entry existed
    path_rows = []
    for (n, s), (keys, gh, _) in sorted(hu_path.items()):
        err = hu_check(keys, gh, s)
        hu_err = max(hu_err, err)
        path_rows.append({"entry": "keys", "launched": True, "N": int(n), "S": s, "max_abs_err": err,
                          **hu_times(keys, gh, s, 20)})
        log("kernel timing: hist_update on the detection path " + json.dumps(path_rows[-1]))
    rows_rows = []
    for (n, s), (xb, node, gh, n_nodes, n_bins) in sorted(hu_rows_path.items()):
        err = hu_rows_check(xb, node, gh, n_nodes, n_bins)
        hu_err = max(hu_err, err)
        rows_rows.append({"entry": "rows", "N": int(n), "F": int(xb.shape[1]), "n_nodes": n_nodes, "S": s,
                          "max_abs_err": err, **hu_rows_times(xb, node, gh, n_nodes, n_bins, 20)})
        log("kernel timing: hist_update_rows on the detection path " + json.dumps(rows_rows[-1]))
        keys = row_keys(xb, node, n_bins)
        gh_rep = gh[:, None, :].expand(n, xb.shape[1], 2).reshape(-1, 2)
        err = hu_check(keys, gh_rep, s)
        hu_err = max(hu_err, err)
        path_rows.append({"entry": "keys", "launched": False, "N": int(keys.shape[0]), "S": s,
                          "max_abs_err": err, **hu_times(keys, gh_rep, s, 20)})
        log("kernel timing: hist_update on the fit's level keys " + json.dumps(path_rows[-1]))
        del keys, gh_rep
    report["hist_update_path_shapes"] = path_rows + rows_rows
    top = max(path_rows, key=lambda r: (r["N"], r["S"]))  # the keys entry's largest path shape
    fit_launch = detection["full"]["launches"]
    kernels.append({
        "name": "hist_update",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hist_update.cu",
        "replaces": "src/repro/kernels/hist_update/kernel.py:42",
        # the keys entry: the leaf sums of the fit; 420 with the rows entry's
        "launches": fit_launch["hist_update"] - fit_launch["hist_update_rows"],
        "launches_both_entries": fit_launch["hist_update"],
        "max_abs_err": hu_err,
        **{k: top[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "shape": {"N": top["N"], "S": top["S"], "keys": "the fit's level-5 (node, feature, bin) keys"},
    })
    top = max(rows_rows, key=lambda r: (r["N"], r["S"]))
    kernels.append({
        "name": "hist_update_rows",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hist_update.cu",
        "replaces": "src/repro/kernels/hist_update/kernel.py:42",
        "launches": fit_launch["hist_update_rows"],
        "max_abs_err": max(r["max_abs_err"] for r in rows_rows),
        **{k: top[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "library": "index_add_ of the repeated gh on prebuilt keys (the key build and the repeat not counted)",
        "shape": {k: top[k] for k in ("N", "F", "n_nodes", "S")},
    })
    kernels.append({
        "name": "window_degree",
        "route": "cuda",
        "source": "src/repro_torch/csrc/window_degree.cu",
        "replaces": "src/repro/kernels/window_degree/kernel.py:34",
        # no path of the system calls it (as in the JAX package)
        "launches": main_launches["window_degree"] + detection["full"]["launches"]["window_degree"],
        **{k: wd_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": {"B": wd_row["B"], "D": wd_row["D"]},
    })
    fa_main = fa_row(*fa_args, 50)
    log("kernel timing: flash_attention on the FraudGT path " + json.dumps(fa_main))
    report["flash_attention_path_shape"] = fa_main
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
        "launches": fgt_launches["flash_attention"],
        **{k: fa_main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "kernel_ms", "plan")},
        "max_abs_err_cases": fa_err,
        "shape": {k: fa_main[k] for k in ("B", "T", "S", "H", "K", "hd", "causal", "dtype")},
    })
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
