"""End-to-end driver: train the full AML system (the port of the JAX
package's ``examples/train_aml_pipeline.py``).

Stage 1 — mine pattern features over the transaction graph (BlazingAML
compiled miner).  Stage 2 — train the gradient-boosted classifier (the
paper's pipeline).  Stage 3 — train the FraudGT-style graph-transformer
baseline on the same split for a few hundred optimizer steps and compare
F1 + throughput (paper Table 4).

  PYTHONPATH=src python -m repro_torch.examples.train_aml_pipeline              # on the card
  PYTHONPATH=src python -m repro_torch.examples.train_aml_pipeline --device cpu

The script has no flags.  These shrink its constants for tests, and
default to them: ``--scale`` (0.4), ``--trees`` (40), ``--epochs`` (3,
FraudGT's).  ``--device`` (``cpu``; the CUDA card when left out).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

__all__ = ["FEATURE_SETS", "run", "main"]

FEATURE_SETS = ("xgb_only", "fan", "fan_degree", "fan_degree_cycle", "full")


def run(ds, ft, trees: int = 40, device=None) -> dict:
    """The five feature sets' pipelines over the dataset ``ds`` at
    ``trees`` trees, then the FraudGT instance ``ft`` fitted on the
    training split and scored on the test split, printed as the script
    prints them.  Returns the printed numbers (``pipelines`` by feature
    set, with precision and recall beside F1; ``fraudgt_f1``,
    ``fraudgt_seconds``), and for checks FraudGT's threshold
    (``fraudgt_threshold``), its test probabilities (``fraudgt_proba``)
    and the pipelines' results (``results``, each with its classifier)."""
    from repro_torch.data import temporal_split
    from repro_torch.ml.gbdt import GBDTParams
    from repro_torch.ml.metrics import best_f1_threshold, f1_score
    from repro_torch.ml.pipeline import run_aml_pipeline

    train_ids, test_ids = temporal_split(ds)
    y = ds.labels.astype(np.float32)
    print(f"{ds.name}: {ds.graph.n_edges} tx, {int(ds.labels.sum())} illicit "
          f"({ds.illicit_rate*100:.2f}%)")

    pipelines, results = {}, {}
    for fs in FEATURE_SETS:
        res = run_aml_pipeline(ds, feature_set=fs, params=GBDTParams(n_trees=trees), device=device)
        print(f"  features={fs:18s} F1={res.f1:.3f} "
              f"(mine {res.mine_seconds:5.1f}s, train {res.train_seconds:5.1f}s)")
        pipelines[fs] = {"f1": res.f1, "precision": res.precision, "recall": res.recall,
                         "mine_seconds": res.mine_seconds, "train_seconds": res.train_seconds}
        results[fs] = res

    print("training FraudGT baseline (a few hundred steps)...")
    t0 = time.time()
    ft.fit(ds.graph, ds.labels, train_ids)
    thr = best_f1_threshold(y[train_ids], ft.predict_proba(ds.graph, train_ids))
    proba = ft.predict_proba(ds.graph, test_ids)
    f1 = f1_score(y[test_ids], proba >= thr)
    dt = time.time() - t0
    print(f"  FraudGT: F1={f1:.3f} ({dt:.0f}s train+infer)")
    return {
        "n_edges": int(ds.graph.n_edges),
        "n_illicit": int(ds.labels.sum()),
        "illicit_rate": float(ds.illicit_rate),
        "pipelines": pipelines,
        "fraudgt_f1": f1,
        "fraudgt_seconds": dt,
        "fraudgt_threshold": thr,
        "fraudgt_proba": proba,
        "results": results,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from repro_torch.data import generate_aml_dataset
    from repro_torch.device import resolve_device
    from repro_torch.ml.fraudgt import FraudGT, FraudGTParams

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.4)
    ap.add_argument("--trees", type=int, default=40)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default=None, help="cpu; the CUDA card when left out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ds = generate_aml_dataset("HI-Small", seed=0, scale=args.scale)
    ft = FraudGT(FraudGTParams(epochs=args.epochs), device=device)
    return run(ds, ft, trees=args.trees, device=device)


if __name__ == "__main__":
    main()
