#!/usr/bin/env python3
"""Where the PyTorch port's GBDT fit spends its time on the card.

    python3 tools/profile_fit.py --scale 282   # needs one CUDA card
    python3 tools/profile_fit.py --src DIR     # the package under DIR (another checkout's src/)

Builds the detection path's training matrix (synthetic HI-Small, base
columns plus the 9 ``"full"`` pattern counts mined by
``repro_torch.api.featurize``, the first 80% of transactions by time) and
fits the default 60-tree GBDT on the card:

1. a plain fit: its wall split into host binning and device rounds
   (``GBDTClassifier.fit_seconds``);
2. the same fit under ``torch.profiler``: the top CUDA kernels by device
   time, the ``hist_update`` kernel's share (its kernels: absmax, the
   cluster-shared or device-memory histogram, finalize) and the device's
   busy share of the rounds (kernel time over wall; one stream, so
   kernels do not overlap);
3. the same fit once more with CUDA events around every histogram call:
   the device time from the start of a level's histogram (the key build
   and repeat included, where the caller still makes them) to its end,
   summed over the trees, per level and for the leaf sums.

``--src`` picks the package to profile (the ``src/`` of any checkout that
has ``repro_torch``), so that two versions can be profiled in one call.
Prints one JSON object per part and writes them all to ``--out``
(default ``build/profile_fit.json``).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOP = 20  # kernels kept in the ranking
# the device kernels of csrc/hist_update.cu (``hist_smem_kernel`` is the
# shared-memory kernel of its first version, for profiles of older checkouts)
HIST_KERNELS = ("absmax_kernel", "hist_cluster_kernel", "hist_global_kernel", "hist_smem_kernel",
                "finalize_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=282.0)
    ap.add_argument("--src", type=Path, default=ROOT / "src", help="the src/ of the package to profile")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "profile_fit.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_fit.py: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.api import featurize
    from repro_torch.data import generate_aml_dataset, temporal_split
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.ml import gbdt
    from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams

    report = {"scale": args.scale, "card": torch.cuda.get_device_name(0), "src": str(args.src)}
    ds = generate_aml_dataset("HI-Small", seed=0, scale=args.scale)
    t0 = time.perf_counter()
    x, cols = featurize(ds.graph, 4096, "full")
    report["featurize_s"] = time.perf_counter() - t0
    train, _ = temporal_split(ds)
    x, y = x[train], ds.labels[train].astype(np.float32)
    report["train_rows"] = int(len(train))
    report["features"] = list(cols)
    GBDTClassifier(GBDTParams(n_trees=1)).fit(x[:4096], y[:4096])  # loads the kernel

    # ---- 1. plain fit ---------------------------------------------------
    hu_ops.launches = 0
    clf = GBDTClassifier().fit(x, y)
    report["fit"] = {"fit_seconds": clf.fit_seconds, "hist_update_launches": hu_ops.launches}
    print(json.dumps({"fit": report["fit"]}), flush=True)

    # ---- 2. the same fit under torch.profiler ---------------------------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        clf = GBDTClassifier().fit(x, y)
    rounds = clf.fit_seconds["rounds"]
    kern = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kern[ev.name][0] += ev.device_time_total / 1e6  # us -> s
            kern[ev.name][1] += 1
    busy = sum(v[0] for v in kern.values())
    hist = sum(v[0] for k, v in kern.items() if any(h in k for h in HIST_KERNELS))
    report["profiled"] = {
        "fit_seconds": clf.fit_seconds,
        "device_kernel_s": busy,
        "device_busy_share_of_rounds": busy / rounds if rounds else None,
        "hist_update_kernel_s": hist,
        "hist_update_share_of_device": hist / busy if busy else None,
        "top_kernels": [
            {"name": k[:120], "s": v[0], "count": v[1]}
            for k, v in sorted(kern.items(), key=lambda kv: -kv[1][0])[:TOP]
        ],
    }
    print(json.dumps({"profiled": report["profiled"]}), flush=True)

    # ---- 3. histogram device time by level ------------------------------
    spans = collections.defaultdict(list)  # level -> [(start, stop)]
    hist_fn, hu_fn = gbdt._histograms, hu_ops.hist_update
    inside = []

    def timed(level, fn, *a):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a)
        stop.record()
        spans[level].append((start, stop))
        return out

    def wrap_hist(xb, gh, node, n_nodes, n_bins):
        inside.append(1)
        try:
            return timed(f"level {n_nodes.bit_length() - 1}", hist_fn, xb, gh, node, n_nodes, n_bins)
        finally:
            inside.pop()

    def wrap_hu(keys, gh, s):
        # a checkout whose levels call the keys entry reaches it inside _histograms
        return hu_fn(keys, gh, s) if inside else timed("leaf", hu_fn, keys, gh, s)

    gbdt._histograms, hu_ops.hist_update = wrap_hist, wrap_hu
    try:
        clf = GBDTClassifier().fit(x, y)
    finally:
        gbdt._histograms, hu_ops.hist_update = hist_fn, hu_fn
    torch.cuda.synchronize()
    by_level = {lv: sum(a.elapsed_time(b) for a, b in ev) / 1e3 for lv, ev in spans.items()}
    report["hist_by_level"] = {"fit_seconds": clf.fit_seconds, "device_s": by_level,
                               "calls": {lv: len(ev) for lv, ev in spans.items()},
                               "total_s": sum(by_level.values())}
    print(json.dumps({"hist_by_level": report["hist_by_level"]}), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
