"""Feature extraction: mined pattern counts -> per-edge feature matrix.

The port of the JAX package's ``repro.core.features`` (paper §8.1): each
transaction edge gets one column per mined pattern (its participation
count) on top of the raw transaction columns (source account, destination
account, amount) used by the XGB-only baseline.

.. deprecated::
    ``mine_features`` / ``featurize`` live in :mod:`repro_torch.api` and
    run through a portfolio :class:`~repro_torch.api.MiningSession`.  The
    functions here are thin shims that emit a ``DeprecationWarning`` and
    return identical results; ``base_features`` remains canonical here.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.graph.csr import TemporalGraph

__all__ = ["BASE_COLUMNS", "base_features", "mine_features", "featurize"]

BASE_COLUMNS = ("src", "dst", "amount")


def base_features(g: TemporalGraph) -> np.ndarray:
    # paper §8.1: the XGB-only baseline sees raw transaction columns
    # (account ids; we add amount).  No timestamp: under the temporal
    # train/test split a raw-time feature lets trees memorize the training
    # period and send every test edge into unseen-time leaves.
    return np.stack(
        [
            g.src.astype(np.float32),
            g.dst.astype(np.float32),
            g.amount.astype(np.float32),
        ],
        axis=1,
    )


def mine_features(
    g: TemporalGraph,
    window: int,
    patterns: Sequence[str],
    backend: str = "compiled",
    seed_eids: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """Deprecated shim — use :func:`repro_torch.api.mine_features`."""
    warnings.warn(
        "repro_torch.core.features.mine_features is deprecated; use "
        "repro_torch.api.MiningSession / repro_torch.api.mine_features",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.api import mine_features as _mine_features

    return _mine_features(
        g, window, patterns, backend=backend, seed_eids=seed_eids, device=device
    )


def featurize(
    g: TemporalGraph,
    window: int,
    patterns: Optional[Sequence[str]] = None,
    backend: str = "compiled",
    device=None,
) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Deprecated shim — use :func:`repro_torch.api.featurize`."""
    warnings.warn(
        "repro_torch.core.features.featurize is deprecated; use "
        "repro_torch.api.featurize",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.api import featurize as _featurize

    return _featurize(g, window, patterns, backend=backend, device=device)
