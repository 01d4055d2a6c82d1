"""Quickstart: author a fuzzy AML pattern in the fluent DSL, mine a whole
pattern portfolio in one session, and train the downstream classifier
(the port of the JAX package's ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart            # full demo, on the card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --scale 0.1 --trees 5 --device cpu

Flags: ``--scale`` (0.5) and ``--trees`` (30) as the script's;
``--device`` (``cpu``; the CUDA card when left out).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

__all__ = ["W", "run", "main"]

W = 4096


def run(ds, trees: int = 30, device=None) -> dict:
    """The script's three steps over the dataset ``ds``, printed as the
    script prints them.  Returns the printed numbers, and for checks the
    portfolio's count matrix (``counts``, columns ``columns``), the
    ``roundtrip3`` column and the oracle's (``roundtrip3_counts``,
    ``roundtrip3_oracle``) and the pipeline's result (``pipeline``, with
    its fitted classifier)."""
    from repro_torch.api import MiningSession, pattern, seed
    from repro_torch.core import GFPReference
    from repro_torch.ml.gbdt import GBDTParams
    from repro_torch.ml.pipeline import run_aml_pipeline

    # 1. a pattern portfolio: register once, compile once, mine everything
    session = MiningSession(ds.graph, window=W, device=device)
    session.register("scatter_gather", "fan_in", "fan_out", "cycle3")
    plan = session.plan_text()
    print(plan)
    res = session.mine()
    sg = res.column("scatter_gather")
    print(f"scatter-gather participation: {sg.sum()} instances "
          f"over {ds.graph.n_edges} edges; max/edge {sg.max()}; "
          f"portfolio mined with {res.stats['kernel_calls']} kernel calls "
          f"(fused seed-local columns: {', '.join(res.fused)})")

    # 2. a CUSTOM pattern in the fluent DSL: "round-trip laundering", v
    # routes money back to u through one intermediary within the window,
    # in order  u->v (seed), v->w, w->u
    roundtrip3 = (
        pattern("roundtrip3")
        .for_all("w", seed.dst.out, after_seed=W, skip=[seed.src, seed.dst])
        .count_edges("close", "w", seed.src, after_stage="w")
        .emit("close")
    )
    got = session.mine([roundtrip3]).column("roundtrip3")
    ref = GFPReference(roundtrip3.build(), ds.graph).mine()
    assert np.array_equal(got, ref)
    print(f"custom roundtrip3: {got.sum()} instances (matches the reference)")

    # 3. end-to-end: mined features -> GBDT -> F1
    pipe = run_aml_pipeline(ds, feature_set="full", params=GBDTParams(n_trees=trees), device=device)
    print(
        f"AML pipeline on {ds.name}: F1={pipe.f1:.3f} "
        f"(precision={pipe.precision:.3f}, recall={pipe.recall:.3f}); "
        f"mining {pipe.mine_seconds:.1f}s, training {pipe.train_seconds:.1f}s"
    )
    return {
        "plan_text": plan,
        "scatter_gather_instances": int(sg.sum()),
        "n_edges": int(ds.graph.n_edges),
        "scatter_gather_max": int(sg.max()),
        "kernel_calls": int(res.stats["kernel_calls"]),
        "fused": list(res.fused),
        "roundtrip3_instances": int(got.sum()),
        "f1": pipe.f1,
        "precision": pipe.precision,
        "recall": pipe.recall,
        "mine_seconds": pipe.mine_seconds,
        "train_seconds": pipe.train_seconds,
        "counts": res.counts,
        "columns": list(res.columns),
        "roundtrip3_counts": got,
        "roundtrip3_oracle": ref,
        "pipeline": pipe,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from repro_torch.data import generate_aml_dataset
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.5, help="dataset scale factor")
    ap.add_argument("--trees", type=int, default=30, help="GBDT size for step 3")
    ap.add_argument("--device", default=None, help="cpu; the CUDA card when left out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ds = generate_aml_dataset("HI-Small", seed=0, scale=args.scale)
    return run(ds, trees=args.trees, device=device)


if __name__ == "__main__":
    main()
