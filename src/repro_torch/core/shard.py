"""The host gather of device outputs (the part of the JAX package's
``repro.core.shard`` that the streaming service needs).

:func:`gather` fetches the streaming tick's per-pattern count vectors in
ONE blocking device→host copy: they are flattened and concatenated on the
device, moved with one :func:`repro_torch.device.to_host` call, and split
back into numpy views of that one buffer.  The rest of the
reference module (the sharded dispatch pool, the collective gather,
``run_sharded``) is the sharded mine, not ported yet (ROADMAP.md, item
A8).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import to_host
from repro_torch.obs import trace as obs_trace

__all__ = ["gather"]


def gather(
    outs: Dict[str, torch.Tensor], stats: Dict[str, int], mode: str = "host"
) -> Dict[str, np.ndarray]:
    """One blocking device→host copy of a dict of finished device tensors
    (one dtype, one device) — the single host sync of whatever dispatched
    them.  Returns the same keys with numpy views of the one host buffer.

    The streaming service's portfolio tick fetches EVERY pattern's
    device-resident count vector in this one call (``mode="portfolio"``
    tags the span so trace tooling can tell it from other gathers)."""
    dtypes = {x.dtype for x in outs.values()}
    if len(dtypes) > 1:
        raise TypeError(f"gather needs one dtype across outputs; got {dtypes}")
    with obs_trace.span("gather", stats=stats, mode=mode):
        flat = to_host(torch.cat([x.reshape(-1) for x in outs.values()])) if outs else None
        stats["host_syncs"] += 1
        stats["bytes_d2h"] += int(sum(x.numel() * x.element_size() for x in outs.values()))
    host = {}
    off = 0
    for name, x in outs.items():
        host[name] = flat[off : off + x.numel()].reshape(tuple(x.shape))
        off += x.numel()
    return host
