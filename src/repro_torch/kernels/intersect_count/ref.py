"""Plain PyTorch version of the intersect_count kernel.

The CPU tests run it, the wrapper takes it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel to it bit for bit on the card."""
from __future__ import annotations

import torch

__all__ = ["intersect_count_ref"]


def intersect_count_ref(
    a_ids, a_t, b_ids, b_t, a_lo, a_hi, b_lo, b_hi, *, ordered: bool = False
):
    a_ok = (a_ids >= 0) & (a_t > a_lo[:, None]) & (a_t <= a_hi[:, None])
    b_ok = (b_ids >= 0) & (b_t > b_lo[:, None]) & (b_t <= b_hi[:, None])
    pair = (
        (a_ids[:, :, None] == b_ids[:, None, :])
        & a_ok[:, :, None]
        & b_ok[:, None, :]
    )
    if ordered:
        pair = pair & (b_t[:, None, :] > a_t[:, :, None])
    return pair.sum(dim=(1, 2), dtype=torch.int32)
