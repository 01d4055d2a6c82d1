#!/usr/bin/env python3
"""Peak device memory of an LM training step by depth, on one CUDA card.

    python3 tools/train_depth.py 9 7 5 4 3 2                  # zamba2-2.7b, units 9, 7, ...
    python3 tools/train_depth.py --arch qwen2-1.5b 28 14

For each depth (in units of the architecture's repeating block), draws
float32 weights at the published width, runs two steps of
``repro_torch.launch.train.make_train_step`` (AdamW, remat, the kernel
attention backend) over 1 x ``--seq`` tokens and prints one JSON line: the
parameter count, the peak of ``torch.cuda.max_memory_allocated`` and each
step's wall, or the out-of-memory error where the depth does not fit.
``chip_smoke.py`` phase 20 takes the largest depth that fits as its
``WIN_TRAIN_UNITS``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("units", type=int, nargs="+")
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("train_depth.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.optimizer import AdamWConfig, adamw_init
    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    device = torch.device("cuda")
    base = get_config(args.arch)
    for units in args.units:
        cfg = dataclasses.replace(base, n_layers=units * len(base.unit))
        row = {"arch": args.arch, "units": units, "n_params": M.n_params(cfg), "seq": args.seq}
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
            opt = adamw_init(params)
            step = T.make_train_step(cfg, AdamWConfig(lr=1e-3))
            walls = []
            for i in range(2):
                batch = T.synthetic_batch(cfg, 1, args.seq, i, device)
                t0 = time.perf_counter()
                params, opt, loss, gn = step(params, opt, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            row.update({"peak_mem_bytes": int(torch.cuda.max_memory_allocated()), "walls_s": walls,
                        "loss": float(loss), "grad_norm": float(gn)})
            del params, opt
        except torch.cuda.OutOfMemoryError as e:
            row["out_of_memory"] = str(e)[:200]
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
