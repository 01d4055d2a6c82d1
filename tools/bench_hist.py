#!/usr/bin/env python3
"""Time the port's ``hist_update`` on the GBDT fit's own inputs, level by level.

    python3 tools/bench_hist.py capture build/hist_inputs.npz --scale 282
    python3 tools/bench_hist.py time build/hist_inputs.npz [--src DIR] [--out FILE]

Both need one CUDA card.

``capture`` builds the detection path's training matrix as
``tools/profile_fit.py`` does (synthetic HI-Small, base columns plus the 9
``"full"`` pattern counts, the first 80 % of transactions by time), fits
one default-depth tree with ``repro_torch.ml.gbdt._histograms`` wrapped,
and saves what each level's histogram and the leaf sums were given: the
bins, the gradient/hessian pairs, and every level's node ids.

``time`` loads that file and times with CUDA events, at every level:

- the ``keys`` entry ``hist_update(keys, gh_rep, S)`` on the fused
  ``(node, feature, bin)`` keys and the repeated ``gh`` that the fit built
  before the ``rows`` entry existed (N·F items), and once more on uniform
  random keys in ``[0, S)`` with the same ``gh`` (a contention check);
- the ``rows`` entry ``hist_update_rows(xb, node, gh, n_nodes, n_bins)``
  where the package has it;
- one ``index_add_`` of ``gh_rep`` on the prebuilt keys (key build not
  counted);

and the leaf sums (``keys`` entry at S = 2^depth).  ``--src`` picks the
package (the ``src/`` of any checkout), so that two versions can be timed
in turns in one call.  Prints one JSON object per row and writes them all
to ``--out`` (default ``build/bench_hist.json``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = 67e12  # non-tensor-core rate; one addition = one operation


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def capture(path: Path, scale: float) -> None:
    import numpy as np
    import torch

    from repro_torch.api import featurize
    from repro_torch.data import generate_aml_dataset, temporal_split
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.ml import gbdt
    from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams

    ds = generate_aml_dataset("HI-Small", seed=0, scale=scale)
    t0 = time.perf_counter()
    x, _ = featurize(ds.graph, 4096, "full")
    print(json.dumps({"featurize_s": time.perf_counter() - t0}), flush=True)
    train, _ = temporal_split(ds)
    x, y = x[train], ds.labels[train].astype(np.float32)
    saved = {}
    hist_fn, hu_fn = gbdt._histograms, hu_ops.hist_update

    def wrap_hist(xb, gh, node, n_nodes, n_bins):
        saved.setdefault("xb", xb.cpu().numpy())
        saved.setdefault("gh", gh.cpu().numpy())
        saved[f"node_{n_nodes}"] = node.cpu().numpy()
        return hist_fn(xb, gh, node, n_nodes, n_bins)

    def wrap_hu(keys, gh, s):
        if keys.shape[0] == gh.shape[0] == len(y):  # the leaf sums
            saved[f"leaf_{s}"] = keys.cpu().numpy()
        return hu_fn(keys, gh, s)

    gbdt._histograms, hu_ops.hist_update = wrap_hist, wrap_hu
    try:
        GBDTClassifier(GBDTParams(n_trees=1)).fit(x, y)
    finally:
        gbdt._histograms, hu_ops.hist_update = hist_fn, hu_fn
    torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **saved)
    print(json.dumps({"captured": sorted(saved), "rows": int(len(y))}), flush=True)


def time_levels(path: Path, reps: int, out: Path) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.hist_update import ref as hu_ref

    # the plain fixed-point replay, where the package has one: each timed
    # result is first held to it bit for bit
    replay = getattr(hu_ref, "fixed_point_ref", None)

    def exact(got, keys, gh_, s, n_rows):
        if replay is None:
            return None
        if not torch.equal(got.reshape(-1, 2), replay(keys, gh_, s, n_rows)):
            raise AssertionError(f"hist_update differs from its fixed-point replay at N={len(keys)} S={s}")
        return True

    dev = torch.device("cuda")
    data = np.load(path)
    xb = torch.from_numpy(data["xb"]).to(dev)
    gh = torch.from_numpy(data["gh"]).to(dev)
    n, f = xb.shape
    n_bins = 256
    rows_entry = getattr(hu_ops, "hist_update_rows", None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    report = {"card": torch.cuda.get_device_name(0), "src": str(Path(hu_ops.__file__).parents[3]),
              "rows": int(n), "features": int(f), "levels": []}
    levels = sorted((int(k.split("_")[1]), k) for k in data.files if k.startswith("node_"))
    for n_nodes, key in levels:
        node = torch.from_numpy(data[key]).to(dev)
        s = n_nodes * f * n_bins
        keys = (node[:, None] * (f * n_bins) + torch.arange(f, dtype=torch.int32, device=dev)[None, :] * n_bins
                + xb.to(torch.int32)).reshape(-1)
        gh_rep = gh[:, None, :].expand(n, f, 2).reshape(-1, 2)
        uniform = torch.randint(0, s, keys.shape, generator=gen, device=dev, dtype=torch.int32)
        lib_out = torch.zeros((s + 1, 2), dtype=torch.float32, device=dev)
        kb, kby = bound_ms(keys.shape[0] * 12 + s * 8, 2 * keys.shape[0])
        row = {"n_nodes": n_nodes, "N": int(keys.shape[0]), "S": s,
               "keys_exact": exact(hu_ops.hist_update(keys, gh_rep, s), keys, gh_rep, s, len(keys)),
               "uniform_exact": exact(hu_ops.hist_update(uniform, gh_rep, s), uniform, gh_rep, s, len(keys)),
               "keys_ms": cuda_ms(lambda: hu_ops.hist_update(keys, gh_rep, s), reps),
               "keys_uniform_ms": cuda_ms(lambda: hu_ops.hist_update(uniform, gh_rep, s), reps),
               "library_ms": cuda_ms(lambda: lib_out.index_add_(0, keys, gh_rep), reps),
               "keys_bound_ms": kb, "keys_bound_by": kby}
        if rows_entry is not None:
            rb, rby = bound_ms(n * (f + 12) + s * 8, 2 * n * f)
            row.update(rows_exact=exact(rows_entry(xb, node, gh, n_nodes, n_bins), keys, gh_rep, s, n),
                       rows_ms=cuda_ms(lambda: rows_entry(xb, node, gh, n_nodes, n_bins), reps),
                       rows_bound_ms=rb, rows_bound_by=rby)
        report["levels"].append(row)
        print(json.dumps(row), flush=True)
        del keys, gh_rep, uniform
    for key in (k for k in data.files if k.startswith("leaf_")):
        s = int(key.split("_")[1])
        node = torch.from_numpy(data[key]).to(dev)
        lib_out = torch.zeros((s + 1, 2), dtype=torch.float32, device=dev)
        b, by = bound_ms(n * 12 + s * 8, 2 * n)
        row = {"leaf": True, "N": int(n), "S": s,
               "keys_exact": exact(hu_ops.hist_update(node, gh, s), node, gh, s, n),
               "keys_ms": cuda_ms(lambda: hu_ops.hist_update(node, gh, s), reps),
               "library_ms": cuda_ms(lambda: lib_out.index_add_(0, node, gh), reps),
               "keys_bound_ms": b, "keys_bound_by": by}
        report["levels"].append(row)
        print(json.dumps(row), flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("capture", "time"))
    ap.add_argument("inputs", type=Path, help="the .npz of captured fit inputs")
    ap.add_argument("--scale", type=float, default=282.0)
    ap.add_argument("--src", type=Path, default=ROOT / "src", help="the src/ of the package to time")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "bench_hist.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_hist.py: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    if args.mode == "capture":
        capture(args.inputs, args.scale)
    else:
        time_levels(args.inputs, args.reps, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
