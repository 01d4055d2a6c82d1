"""Device placement for the port: resolve, upload, and the one fetch.

Every entry point of :mod:`repro_torch` runs on the CUDA card unless the
caller names the CPU explicitly.  There is no silent fallback: a default
device on a machine without CUDA is an error, so a green run on the card
proves the card did the work.

The host↔device traffic of a mine goes through two helpers:

* :func:`h2d` — numpy → device.  On CUDA the array is copied into pinned
  host memory and moved with ``non_blocking=True``, so staging never
  blocks the host (PyTorch's caching host allocator keeps the pinned
  block alive until the copy has run).  On the CPU it is a zero-copy
  ``torch.from_numpy`` view; nothing in the port writes into it.
* :func:`to_host` — device → numpy, THE host sync of a mine.  It is the
  only place the port waits for the card, and it lifts
  ``torch.cuda.set_sync_debug_mode`` for exactly that copy, so a run under
  ``set_sync_debug_mode("error")`` fails on any other hidden sync
  (``.item()``, a boolean-mask index, a pageable copy).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "h2d", "to_host", "allowed_sync"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; anything else must name a device
    that exists.  Raises rather than falling back to the CPU."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; cuda|cpu")
    return dev


def h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload one host array (pinned + non-blocking on CUDA)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@contextlib.contextmanager
def allowed_sync():
    """Suspend the CUDA sync debug mode for one deliberate sync."""
    if not torch.cuda.is_available():
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def to_host(t: torch.Tensor) -> np.ndarray:
    """The blocking device→host copy of a finished result."""
    with allowed_sync():
        return t.cpu().numpy()
