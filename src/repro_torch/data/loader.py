"""Train/test temporal split (paper §8.1).

The paper trains on the first 80% of timestamped transactions and tests on
the last 20%; this is a copy of the JAX package's framework-free
``repro.data.loader``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.data.synth_aml import AMLDataset

__all__ = ["temporal_split"]


def temporal_split(
    ds: AMLDataset, train_frac: float = 0.8
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (train_edge_ids, test_edge_ids) split by timestamp quantile."""
    t = ds.graph.t
    cutoff = np.quantile(t, train_frac)
    train = np.nonzero(t <= cutoff)[0].astype(np.int32)
    test = np.nonzero(t > cutoff)[0].astype(np.int32)
    return train, test
