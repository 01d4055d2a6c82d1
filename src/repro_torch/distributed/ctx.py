"""Sharding-hint context: layers can ask for an activation layout without
knowing whether they run under a mesh (the port of the JAX package's
``repro.distributed.ctx``; smoke runs are meshless).

Launch code (the sharded train step, a mesh-placed decode) calls
``set_axes(mesh, data, model)``; layer code calls ``hint(x, template)``,
which is the identity when no mesh is set or when ``x`` is a plain
tensor.  On a :class:`~torch.distributed.tensor.DTensor` it redistributes
to the template's layout (each named dim sharded over its axes, every
other dim replicated), dropping an axis whose size does not divide the
dim: it moves data between ranks and never changes a value.  ``mesh`` is
a :class:`~torch.distributed.device_mesh.DeviceMesh` or, where only sizes
are read, a :class:`~repro_torch.launch.mesh.MeshShape`.

The layers' other DTensor helpers live here too, each the plain op on a
plain tensor: ``reshape`` (gathers a dim first where the reshape would
cut its shards), ``replicate_like`` (a constant joins the mesh
replicated) and ``mesh_coordinate`` (which shard a rank holds).
"""
from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

__all__ = [
    "set_axes",
    "clear",
    "data_size",
    "model_size",
    "mesh_and_axes",
    "hint",
    "mesh_sizes",
    "is_dtensor",
    "replicate_like",
    "mesh_coordinate",
    "reshape",
]

_MESH = None
_AXES: Optional[dict] = None  # {"data": ("pod","data")|("data",), "model": ("model",)}


def mesh_sizes(mesh) -> Dict[str, int]:
    """Dim name -> size of a DeviceMesh or a MeshShape, in mesh order."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.names, mesh.sizes))


def set_axes(
    mesh,
    data_axes: Optional[Tuple[str, ...]],
    model_axes: Optional[Tuple[str, ...]],
):
    global _MESH, _AXES
    _MESH = mesh
    _AXES = (
        None
        if mesh is None
        else {"data": tuple(data_axes or ()), "model": tuple(model_axes or ())}
    )


def clear():
    set_axes(None, None, None)


def _axis_size(axes) -> int:
    sizes = mesh_sizes(_MESH)
    s = 1
    for a in axes:
        s *= sizes[a]
    return s


def data_size() -> int:
    """Size of the data-parallel axis group (1 when meshless)."""
    if _MESH is None or _AXES is None:
        return 1
    return _axis_size(_AXES.get("data", ()))


def model_size() -> int:
    if _MESH is None or _AXES is None:
        return 1
    return _axis_size(_AXES.get("model", ()))


def mesh_and_axes():
    """(mesh, data_axes, model_axes) or (None, (), ())."""
    if _MESH is None or _AXES is None:
        return None, (), ()
    return _MESH, _AXES.get("data", ()), _AXES.get("model", ())


def hint(x, template: Tuple):
    """template entries: None | "data" | "model", one per leading dim.
    The identity on a plain tensor or with no mesh set."""
    from repro_torch.distributed.sharding import spec_placements

    if _MESH is None or _AXES is None or not is_dtensor(x):
        return x
    spec = []
    for i in range(x.ndim):
        t = template[i] if i < len(template) else None
        axes = _AXES.get(t, ()) if t is not None else ()
        size = _axis_size(axes) if axes else 1
        spec.append(axes if axes and size > 1 and x.shape[i] % size == 0 else None)
    want = spec_placements(_MESH, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False, with nothing imported, while no
    code has loaded ``torch.distributed.tensor``)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def replicate_like(ref, t):
    """``t`` (a constant every rank builds alike: positions, masks, a
    zero) as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor; ``t`` itself otherwise.  DTensor ops refuse to mix the two."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def mesh_coordinate(mesh, dims) -> int:
    """This rank's index along the mesh dims ``dims`` taken together
    (major first): the shard it holds of a dim they shard."""
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def reshape(x, shape):
    """``x.reshape(shape)``, also for a DTensor whose sharding the reshape
    cannot carry: a mesh dim that shards a dim past the shapes' common
    prefix is replicated first, unless it shards the first such dim and
    the shard count divides that dim's size on both sides (a head split
    that keeps whole heads, a merge whose leading dim is sharded).  Half a
    head (qwen2's 2 kv heads on a 4-way model axis) is thus gathered
    before the split."""
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate

    shape = tuple(shape)
    old = tuple(x.shape)
    p = 0
    while p < min(len(old), len(shape)) and old[p] == shape[p]:
        p += 1
    mesh = x.device_mesh
    counts = {}
    for i, pl in enumerate(x.placements):
        if pl.is_shard():
            counts[pl.dim] = counts.get(pl.dim, 1) * mesh.size(i)
    keep = lambda d: d < p or (d == p and p < len(shape) and shape[p] % counts[d] == 0
                               and (old[p] % shape[p] == 0 or shape[p] % old[p] == 0))
    want = [Replicate() if pl.is_shard() and not keep(pl.dim) else pl for pl in x.placements]
    if want != list(x.placements):
        x = x.redistribute(mesh, want)
    return x.reshape(shape)
