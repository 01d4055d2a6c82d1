"""Plain PyTorch version of the window_degree kernel.

The CPU tests run it, the wrapper takes it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel to it bit for bit on the card."""
from __future__ import annotations

import torch

__all__ = ["window_degree_ref"]


def window_degree_ref(t, lo, hi):
    ok = (t > lo[:, None]) & (t <= hi[:, None])
    return ok.sum(dim=1, dtype=torch.int32)
