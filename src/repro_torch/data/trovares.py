"""Trovares-style synthetic scaling graphs (paper Fig. 10).

Power-law temporal multigraphs spanning orders of magnitude in edge count,
used for the scalability study of scatter-gather mining throughput.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import TemporalGraph, build_temporal_graph
from repro_torch.data.synth_aml import _powerlaw_nodes, T_HORIZON

__all__ = ["generate_trovares_graph", "TROVARES_SIZES"]

TROVARES_SIZES = {
    "Trovares-10K": 10_000,
    "Trovares-100K": 100_000,
    "Trovares-1M": 1_000_000,
}


def generate_trovares_graph(n_edges: int, seed: int = 0) -> TemporalGraph:
    rng = np.random.default_rng(seed)
    n_nodes = max(64, n_edges // 12)  # avg degree ~12, like the TT datasets
    src = _powerlaw_nodes(rng, n_nodes, n_edges)
    dst = _powerlaw_nodes(rng, n_nodes, n_edges)
    fix = src == dst
    dst[fix] = (dst[fix] + 1) % n_nodes
    t = rng.integers(0, T_HORIZON, n_edges, dtype=np.int64)
    return build_temporal_graph(src, dst, t, n_nodes=n_nodes)
