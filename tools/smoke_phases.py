#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s later phases alone on one CUDA card, at
the full size or with their cuts lifted.

    python3 tools/smoke_phases.py --phases bwd,sharded,fit
    python3 tools/smoke_phases.py --phases fit --fit-rows 0   # every training edge
    python3 tools/smoke_phases.py --phases flash,lm           # the LM path alone
    python3 tools/smoke_phases.py --phases bwd,train          # the LM's training alone
    python3 tools/smoke_phases.py --phases mesh               # the LM's (1, 1) mesh step alone
    python3 tools/smoke_phases.py --phases windowed           # zamba2 and mixtral with the window
    python3 tools/smoke_phases.py --phases wide               # the seven other architectures at full width
    python3 tools/smoke_phases.py --phases examples           # the JAX package's five examples as entry points
    python3 tools/smoke_phases.py --phases search             # window_search's phase-2 cases, both entries
    python3 tools/smoke_phases.py --phases pairs              # intersect_count's pair_step phase-2 cases

Builds the kernels, prints the card line, and runs, in order:

- ``search``: phase 2's ``window_search`` cases (both entries, every form
  and the hub rows) against their plain version, timed at the hub;
- ``pairs``: phase 2's ``pair_step`` cases (``intersect_count``'s pw step
  entry, every form and the mining path's largest pw shapes) against
  their plain version, timed at the path shapes;
- ``flash``: phase 2's ``flash_attention`` cases (``FA_CASES``, with
  qwen2-1.5b's prefill launch) against their plain version, timed;
- ``bwd``: phase 2's backward cases (the short path's ``FA_BWD_CASES``
  and the long backward's ``FA_LONG_BWD_CASES``) against their plain
  version, timed beside their bound and SDPA's backward;
- ``sharded``: phase 3's cold mine of the 9 ``"full"`` patterns over
  HI-Small (``--scale``, 282 by default), then phase 15 (the sharded
  mines against its rows, ``repro_torch.launch.mine`` once);
- ``fit``: phase 16 (FraudGT trained for one epoch on the first
  ``--fit-rows`` training edges, 0 for all of them; threshold, F1, the
  profile of a few steps), then the backward kernel at the fit's first
  launch;
- ``lm``: phase 17 (the LM scaffold at qwen2-1.5b's full width: prefill,
  float32 checks, serving, every smoke config against the CPU port, the
  launcher), then ``flash_attention`` at the prefill's first launch;
- ``train``: phase 18 (the LM's training loop: qwen2-1.5b at full width,
  4 x 4,096 tokens a step, timed, profiled and its launches counted; the
  float32 and bf16 cross-backend checks; every smoke config trained on
  the card against the CPU port; the launcher), then the long backward at
  a launch of the cell;
- ``mesh``: phase 19 (the sharded train step on a (1, 1) NCCL mesh at
  qwen2-1.5b's full width against the plain step, its launches counted);
- ``windowed``: phase 20 (zamba2-2.7b at 54 layers and mixtral-8x7b at
  full width, 2 layers, prefilling 32,768 tokens through the windowed
  kernels; a zamba2 training step at ``--train-units`` units, 3 by
  default), then ``flash_attention`` at both prefills' first launches;
- ``wide``: phase 21 (musicgen-medium, granite-8b, mistral-nemo-12b,
  deepseek-coder-33b, chameleon-34b, moonshot-v1-16b-a3b and xlstm-125m
  at published width, the last three of the attention models at cut
  depth: a 4 x 2,048 prefill through the kernels, the bf16 and decode
  checks, serving, each prefill's first launch against the plain
  version and timed);
- ``examples``: phase 22 (the JAX package's five example scripts as the
  port's entry points, each ``main`` at the script's defaults on the
  card with its launches counted, then each against the CPU port at a
  small size).

Every check of the phases holds as in ``chip_smoke.py``.  Prints each
phase's wall and writes the phases' records to ``--out`` (default
``build/smoke_phases.json``).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="bwd,sharded,fit")
    ap.add_argument("--scale", type=float, default=282.0)
    ap.add_argument("--fit-rows", type=int, default=None, help="training edges of the fit (0: all)")
    ap.add_argument("--train-units", type=int, default=None, help="zamba2 units of phase 20's training step")
    ap.add_argument("--out", default=str(ROOT / "build" / "smoke_phases.json"))
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("smoke_phases.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.api import MiningSession
    from repro_torch.core.patterns import feature_pattern_set
    from repro_torch.data.synth_aml import generate_aml_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hist_update import ops as hu_ops
    from repro_torch.kernels.intersect_count import ops as ic_ops
    from repro_torch.kernels.window_degree import ops as wd_ops
    from repro_torch.kernels.window_search import ops as ws_ops

    if args.fit_rows is not None:
        cs.FGT_FIT_ROWS = args.fit_rows or None
    if args.train_units is not None:
        cs.WIN_TRAIN_UNITS = args.train_units
    with concurrent.futures.ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        list(pool.map(build.load, cs.KERNELS))
    report = {"card": cs.card_line(), "walls_s": {}}
    print(report["card"], flush=True)

    def zero():
        ic_ops.launches = hu_ops.launches = hu_ops.rows_launches = wd_ops.launches = fa_ops.launches = 0
        ic_ops.step_launches = ws_ops.launches = ws_ops.step_launches = 0
        fa_ops.lse_launches = fa_ops.bwd_launches = fa_ops.long_bwd_launches = 0

    def read():
        return {"intersect_count": ic_ops.launches, "intersect_count_step": ic_ops.step_launches,
                "hist_update": hu_ops.launches,
                "hist_update_rows": hu_ops.rows_launches, "window_degree": wd_ops.launches,
                "flash_attention": fa_ops.launches, "flash_attention_lse": fa_ops.lse_launches,
                "flash_attention_bwd": fa_ops.bwd_launches, "flash_attention_bwd_long": fa_ops.long_bwd_launches,
                "window_search": ws_ops.launches, "window_search_step": ws_ops.step_launches}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        report["walls_s"][name] = time.perf_counter() - t0
        print(f"{name}: {report['walls_s'][name]:.1f} s", flush=True)
        return out

    if "search" in phases:
        timed("search", lambda: cs.phase_window_search(torch.device("cuda"), report))
    if "pairs" in phases:
        timed("pairs", lambda: cs.phase_pair_step(torch.device("cuda"), report))
    if "flash" in phases:
        timed("flash", lambda: cs.phase_flash_attention(torch.device("cuda"), report))
    if "bwd" in phases:
        timed("bwd", lambda: cs.phase_flash_attention_bwd(torch.device("cuda"), report))
    if "lm" in phases:
        _, (q, k, v, causal) = timed("lm", lambda: cs.phase_lm(report, zero, read))
        report["flash_attention_lm_shape"] = cs.fa_row(q, k, v, causal, 20)
        print("kernel timing: flash_attention on the LM prefill path "
              + json.dumps(report["flash_attention_lm_shape"]), flush=True)
    if "train" in phases:
        _, (q, k, v, o, do, lse, causal) = timed("train", lambda: cs.phase_train(report, zero, read))
        report["flash_attention_bwd_train_shape"] = cs.fa_bwd_row(q, k, v, do, causal, 20, o=o, lse=lse,
                                                                  rtol32=cs.FA_BWD_TOL)
        del q, k, v, o, do, lse
        print("kernel timing: flash_attention_bwd on the LM training path "
              + json.dumps(report["flash_attention_bwd_train_shape"]), flush=True)
    if "mesh" in phases:
        timed("mesh", lambda: cs.phase_mesh(report, zero, read))
    if "windowed" in phases:
        _, *prefills = timed("windowed", lambda: cs.phase_windowed_lm(report, zero, read))
        for key, (q, k, v, window) in zip(("zamba2", "mixtral"), prefills):
            report[f"flash_attention_{key}_shape"] = cs.fa_window_row(q, k, v, window, 10)
            print(f"kernel timing: flash_attention on the {key} prefill path "
                  + json.dumps(report[f"flash_attention_{key}_shape"]), flush=True)
        del prefills, q, k, v
    if "wide" in phases:
        timed("wide", lambda: cs.phase_wide_lm(report, zero, read))
    if "examples" in phases:
        timed("examples", lambda: cs.phase_examples(torch.device("cuda"), report, zero, read))
    ds = generate_aml_dataset("HI-Small", seed=cs.SEED, scale=args.scale) if phases & {"sharded", "fit"} else None
    if "sharded" in phases:
        session = MiningSession(ds.graph, window=cs.WINDOW).register(*feature_pattern_set("full"))
        counts = timed("cold_mine", lambda: session.mine().counts)
        timed("sharded", lambda: cs.phase_sharded(session, ds.graph, counts, report, zero, read))
    if "fit" in phases:
        _, (q, k, v, o, do, lse, causal) = timed("fit", lambda: cs.phase_fraudgt_fit(ds, report, zero, read))
        report["flash_attention_bwd_path_shape"] = cs.fa_bwd_row(q, k, v, do, causal, 50, o=o, lse=lse,
                                                                 flush_l2=True)
        print("kernel timing: flash_attention_bwd on the FraudGT training path "
              + json.dumps(report["flash_attention_bwd_path_shape"]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1, default=str))
    print(report["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
