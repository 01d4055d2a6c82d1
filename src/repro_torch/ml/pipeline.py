"""End-to-end AML pipeline: mine -> features -> GBDT -> F1 (paper Fig. 1).

The port of the JAX package's ``repro.ml.pipeline``.  It reproduces the
Table 2 protocol: features are pattern-participation counts per edge on
top of the base transaction columns; train on the first 80% of
timestamped transactions, test on the last 20%; report F1 on the (heavily
imbalanced) laundering class.  The mine and the fit run on ``device`` (the
CUDA card by default; the CPU only when asked).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.api import MiningResult, MiningSession
from repro_torch.core.features import base_features
from repro_torch.core.patterns import feature_pattern_set
from repro_torch.data.loader import temporal_split
from repro_torch.data.synth_aml import AMLDataset
from repro_torch.device import resolve_device
from repro_torch.ml.gbdt import GBDTClassifier, GBDTParams
from repro_torch.ml.metrics import best_f1_threshold, confusion, precision_recall_f1

__all__ = ["PipelineResult", "run_aml_pipeline", "FEATURE_SETS"]

# Table 2 columns
FEATURE_SETS = {
    "xgb_only": (),
    "fan": feature_pattern_set("fan"),
    "fan_degree": feature_pattern_set("fan") + feature_pattern_set("degree"),
    "fan_degree_cycle": feature_pattern_set("fan")
    + feature_pattern_set("degree")
    + feature_pattern_set("cycle"),
    "full": feature_pattern_set("full"),
    "full_deep": feature_pattern_set("full_deep"),
}


@dataclasses.dataclass
class PipelineResult:
    """The reference's result fields, plus ``fit_seconds`` (the fit's
    split into host binning and device rounds, see
    :class:`~repro_torch.ml.gbdt.GBDTClassifier`), ``mining`` (the
    pipeline's own mine with its counters; ``None`` without patterns) and
    ``classifier`` (the fitted GBDT, whose trees a check can compare)."""

    dataset: str
    feature_set: str
    f1: float
    precision: float
    recall: float
    confusion: dict
    mine_seconds: float
    train_seconds: float
    n_train: int
    n_test: int
    fit_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    mining: Optional[MiningResult] = None
    classifier: Optional[GBDTClassifier] = None


def run_aml_pipeline(
    ds: AMLDataset,
    feature_set: str = "full",
    backend: str = "compiled",
    params: Optional[GBDTParams] = None,
    window: Optional[int] = None,
    device=None,
    session: Optional[MiningSession] = None,
) -> PipelineResult:
    """``session``, if given, is a session over ``ds.graph`` at the same
    window and device that the mine goes through instead of a new one: a
    session that mined every edge before replays its cached schedules."""
    device = resolve_device(device)
    g = ds.graph
    w = window or ds.meta.get("window", 4096)
    patterns = FEATURE_SETS[feature_set]
    if session is not None and (session.graph is not g or session.window != w or session.device != device):
        raise ValueError("session must be over ds.graph at the pipeline's window and device")

    t0 = time.perf_counter()
    x = base_features(g)
    mining = None
    if patterns:
        # portfolio session: one shared compile + seed-local kernel fusion
        # across the whole feature group
        session = session or MiningSession(g, window=w, device=device)
        mining = session.register(*patterns).mine(list(patterns), backend=backend)
        x = np.concatenate([x, mining.as_features()], axis=1)
    mine_s = time.perf_counter() - t0

    train_ids, test_ids = temporal_split(ds)
    y = ds.labels.astype(np.float32)

    t0 = time.perf_counter()
    clf = GBDTClassifier(params or GBDTParams(), device=device)
    clf.fit(x[train_ids], y[train_ids])
    # threshold tuned on the training period (no test leakage)
    thr = best_f1_threshold(y[train_ids], clf.predict_proba(x[train_ids]))
    train_s = time.perf_counter() - t0

    proba = clf.predict_proba(x[test_ids])
    pred = (proba >= thr).astype(np.int8)
    prec, rec, f1 = precision_recall_f1(y[test_ids], pred)
    return PipelineResult(
        dataset=ds.name,
        feature_set=feature_set,
        f1=f1,
        precision=prec,
        recall=rec,
        confusion=confusion(y[test_ids], pred),
        mine_seconds=mine_s,
        train_seconds=train_s,
        n_train=len(train_ids),
        n_test=len(test_ids),
        fit_seconds=dict(clf.fit_seconds),
        mining=mining,
        classifier=clf,
    )
