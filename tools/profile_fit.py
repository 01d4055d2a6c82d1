#!/usr/bin/env python3
"""Where the PyTorch port's GBDT fit spends its time on the card.

    python3 tools/profile_fit.py --scale 282   # needs one CUDA card

Builds the detection path's training matrix (synthetic HI-Small, base
columns plus the 9 ``"full"`` pattern counts mined by
``repro_torch.api.featurize``, the first 80% of transactions by time) and
fits the default 60-tree GBDT on the card:

1. a plain fit: its wall split into host binning and device rounds
   (``GBDTClassifier.fit_seconds``);
2. the same fit under ``torch.profiler``: the top CUDA kernels by device
   time, the ``hist_update`` kernel's share (its four kernels: absmax,
   the shared-memory or device-memory histogram, finalize) and the
   device's busy share of the rounds (kernel time over wall; one stream,
   so kernels do not overlap).

Prints one JSON object per part and writes them all to
``build/profile_fit.json``.
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
# the device kernels of csrc/hist_update.cu (and its two memsets)
HIST_KERNELS = ("absmax_kernel", "hist_smem_kernel", "hist_global_kernel", "finalize_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=282.0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_fit.py: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import featurize
    from repro_torch.data import generate_aml_dataset, temporal_split
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams

    report = {"scale": args.scale, "card": torch.cuda.get_device_name(0)}
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
    out = ROOT / "build" / "profile_fit.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
