"""Classification metrics for imbalanced AML prediction (paper §8.4).

A copy of the JAX package's framework-free ``repro.ml.metrics``."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["confusion", "precision_recall_f1", "f1_score", "best_f1_threshold"]


def confusion(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, int]:
    y_true = np.asarray(y_true).astype(bool)
    y_pred = np.asarray(y_pred).astype(bool)
    return {
        "tp": int(np.sum(y_true & y_pred)),
        "fp": int(np.sum(~y_true & y_pred)),
        "fn": int(np.sum(y_true & ~y_pred)),
        "tn": int(np.sum(~y_true & ~y_pred)),
    }


def precision_recall_f1(y_true, y_pred) -> Tuple[float, float, float]:
    c = confusion(y_true, y_pred)
    prec = c["tp"] / max(1, c["tp"] + c["fp"])
    rec = c["tp"] / max(1, c["tp"] + c["fn"])
    f1 = 2 * prec * rec / max(1e-12, prec + rec)
    return prec, rec, f1


def f1_score(y_true, y_pred) -> float:
    return precision_recall_f1(y_true, y_pred)[2]


def best_f1_threshold(y_true, proba, n_grid: int = 64) -> float:
    """Threshold sweep on (a held-out slice of) the training period —
    standard practice for heavily imbalanced classifiers."""
    best_t, best_f = 0.5, -1.0
    for t in np.linspace(0.05, 0.95, n_grid):
        f = f1_score(y_true, proba >= t)
        if f > best_f:
            best_f, best_t = f, float(t)
    return best_t
