"""The shard device list of a sharded mine, and the CPU lanes that stand
in for several devices on a machine without them.

The port of the JAX package's ``repro.launch.mesh``, for the part the
sharded mining executor (:mod:`repro_torch.core.shard`) uses:

* :func:`make_shard_mesh` is the explicit 1-D list of shard devices that
  the collective gather reduces over (the reference builds a
  ``("shard",)`` ``jax.sharding.Mesh``; torch dispatches to devices by
  name, so the mesh is the ordered list itself).
* :func:`ensure_host_devices` is the counterpart of the reference's
  ``--xla_force_host_platform_device_count`` flag.  On CUDA it requests
  nothing and returns the visible card count: a caller that asks for
  more cards than there are degrades to the visible set.  On the CPU it
  sets how many CPU *lanes* :func:`repro_torch.core.shard.mining_devices`
  presents, so the multi-device dispatch pool and the round-robin run on
  a machine without cards.  The lanes share the one CPU device and one
  graph replica; each reports under its own name (``cpu:0``, ``cpu:1``,
  ...).

The training meshes of the LM scaffold (``make_production_mesh``,
``make_local_mesh``) come with the LM's training, ROADMAP item A12b, and
raise until then.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "make_production_mesh",
    "make_local_mesh",
    "make_shard_mesh",
    "ensure_host_devices",
    "host_lanes",
]

_lanes = 1  # CPU lanes that mining_devices presents for the CPU


def ensure_host_devices(n: int, device: DeviceLike = None) -> int:
    """Ask for ``n`` mining devices of ``device``'s kind (the CUDA card by
    default) and return the count visible.

    CUDA: nothing to request; the visible card count comes back, and a
    caller that gets fewer than it asked for degrades to them.  CPU: sets
    the process-wide lane count to ``n`` (at least 1) and returns it."""
    global _lanes
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    _lanes = max(1, int(n))
    return _lanes


def host_lanes() -> int:
    """The CPU lanes a sharded mine on the CPU dispatches over."""
    return _lanes


def make_shard_mesh(devices: Sequence) -> List[torch.device]:
    """The 1-D shard axis over an explicit mining-device list, in order:
    shard ``p`` of a collective gather lives on ``mesh[p]``.  Takes the
    devices explicitly (not every visible card) so a mine over a subset,
    or a forced single device, reduces over exactly the devices it
    dispatched to."""
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a shard mesh needs at least one device")
    return mesh


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the LM scaffold's training meshes are not ported yet (ROADMAP A12b)"
    )


def make_local_mesh(data: int = 1, model: int = 1):
    raise NotImplementedError(
        "the LM scaffold's training meshes are not ported yet (ROADMAP A12b)"
    )
