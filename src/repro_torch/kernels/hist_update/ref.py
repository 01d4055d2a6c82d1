"""Plain PyTorch version of the hist_update kernel (a segment-sum
histogram).

The CPU tests run it, the wrapper takes it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel to it (in float64) on the card.
It sums in ``gh``'s dtype; on the CPU ``index_add_`` adds the rows of a
key in row order, as the JAX package's ``segment_sum`` does there."""
from __future__ import annotations

import torch

__all__ = ["hist_update_ref"]


def hist_update_ref(keys, gh, n_segments: int):
    """keys (N,) int, gh (N, 2) -> (n_segments, 2): the sum of the gh rows
    of each key; keys outside [0, n_segments) are dropped (summed into a
    spare row that is cut off)."""
    safe = torch.where((keys >= 0) & (keys < n_segments), keys, n_segments)
    out = torch.zeros((n_segments + 1, 2), dtype=gh.dtype, device=gh.device)
    out.index_add_(0, safe, gh)
    return out[:n_segments]
