"""The meshes of the port: the shard device list of a sharded mine, the
CPU lanes that stand in for several devices on a machine without them,
and the LM scaffold's device meshes (the JAX package's
``repro.launch.mesh``).

For the sharded mining executor (:mod:`repro_torch.core.shard`):

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

The LM scaffold's meshes are ``torch.distributed`` device meshes
(:class:`~torch.distributed.device_mesh.DeviceMesh`) over the initialised default process group (NCCL on the card, gloo on
the CPU), with the reference's dim names: :func:`make_local_mesh`
(``("data", "model")``, any small shape) and :func:`make_production_mesh`
(16 x 16, or 2 x 16 x 16 with a ``"pod"`` dim).  A world whose size is not
the product of the mesh dims raises.  :class:`MeshShape` is the same
description without ranks: the sharding rules
(:mod:`repro_torch.distributed.sharding`) read only names and sizes, so
they evaluate for a production mesh on one process.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "MeshShape",
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


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and sizes, with no ranks behind it: what the
    sharding rules read.  ``MeshShape(("data", "model"), (16, 16))``."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.names) != len(self.sizes):
            raise ValueError(f"mesh dims {self.names} and sizes {self.sizes} differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


PRODUCTION = MeshShape(("data", "model"), (16, 16))
PRODUCTION_MULTI_POD = MeshShape(("pod", "data", "model"), (2, 16, 16))


def _device_mesh(shape: MeshShape, device: DeviceLike):
    """A DeviceMesh of ``shape`` over the default process group, on
    ``device``'s type (the CUDA card by default)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape.names} mesh needs an initialised torch.distributed process group")
    world = dist.get_world_size()
    if world != shape.size:
        raise ValueError(f"a {shape.names} mesh of {shape.sizes} needs {shape.size} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(dev.type, shape.sizes, mesh_dim_names=shape.names)


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks)."""
    return _device_mesh(PRODUCTION_MULTI_POD if multi_pod else PRODUCTION, device)


def make_local_mesh(data: int = 1, model: int = 1, device: DeviceLike = None):
    """A small ``("data", "model")`` mesh over every rank (tests, one card)."""
    return _device_mesh(MeshShape(("data", "model"), (int(data), int(model))), device)
