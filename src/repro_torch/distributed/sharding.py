"""Sharding rules: param/batch/cache/optimizer specs, and their DTensor
placements (the port of the JAX package's ``repro.distributed.sharding``).

Megatron-style TP over the ``model`` axis, DP over ``pod`` x ``data``,
EP (expert parallelism) maps the expert dim onto ``model``, and ZeRO-1
shards optimizer moments over ``data`` on top of the param sharding.

Every rule is divisibility-checked against the actual shape: a dim that
does not divide by its mesh-axis size falls back to replication for that
dim (robust across the heterogeneous architectures, e.g. 4-head xLSTM
blocks on a 16-way model axis).

A spec is a tuple with one entry per tensor dim: ``None`` (replicated) or
a tuple of mesh axis names (the dim sharded over their product, major
first): the reference's ``PartitionSpec`` entry for entry.  The rules read
only the mesh's dim names and sizes, so ``mesh`` is a
:class:`~torch.distributed.device_mesh.DeviceMesh` or a
:class:`~repro_torch.launch.mesh.MeshShape`; :func:`spec_placements` turns
a spec into the placements of a live DeviceMesh, and
:func:`distribute_tree` places a tree of tensors by a tree of them.
Trees are nested dicts (lists and tuples by index); a leaf is anything
with a ``.shape``.
"""
from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

from repro_torch.distributed import opts
from repro_torch.distributed.ctx import mesh_sizes

__all__ = [
    "param_sharding",
    "batch_sharding",
    "cache_sharding",
    "opt_sharding",
    "zero1_sharding",
    "mesh_axes",
    "spec_placements",
    "placement_tree",
    "distribute_tree",
]

Spec = Tuple[Optional[Tuple[str, ...]], ...]


def _walk(fn: Callable, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn(path, leaf, *rest_leaves)`` over a tree's leaves, rebuilt."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, *(r[k] for r in rest), path=path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, *(r[i] for r in rest), path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree, *rest)


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(data_axes, model_axes) for a production mesh."""
    names = tuple(mesh_sizes(mesh))
    data = tuple(n for n in names if n in ("pod", "data"))
    model = tuple(n for n in names if n == "model")
    return data, model


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    s = 1
    for a in axes:
        s *= sizes[a]
    return s


def _fit(mesh, shape, spec) -> Spec:
    """Drop spec axes whose dim is not divisible by the axis size."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, entries):
        if ax is not None and dim % _axis_size(mesh, ax) == 0 and dim > 0:
            out.append(ax)
        else:
            out.append(None)
    return tuple(out)


# (path regex, spec template) — matched against 'a/b/c' paths
def _param_rules(model: Tuple[str, ...]):
    m = model
    return [
        (r"embed$", (m, None)),            # vocab-sharded embedding
        (r"lm_head$", (None, m)),
        (r"heads$", (None, None, m)),      # musicgen codebook heads
        (r"attn/wq$", (None, m)),
        (r"attn/wk$", (None, m)),
        (r"attn/wv$", (None, m)),
        (r"attn/wo$", (m, None)),
        (r"attn/b[qkv]$", (m,)),
        (r"moe/router$", (None, None)),
        (r"moe/w[13]$", (m, None, None)),  # EP: experts over model
        (r"moe/w2$", (m, None, None)),
        (r"mlp/w[13]$", (None, m)),
        (r"mlp/w2$", (m, None)),
        (r"mixer/in_proj$", (None, m)),
        (r"mixer/out_proj$", (m, None)),
        (r"mixer/conv_w$", (None, m)),
        (r"mixer/w(q|k|v|gate|o_gate)$", (None, m)),
        (r"mixer/wout$", (m, None)),
        (r"mixer/wx$", (None, m)),
        (r"mixer/r$", (m, None, None)),
        (r"mixer/(A_log|D|dt_bias)$", (m,)),
    ]


def param_sharding(mesh, param_specs):
    """Spec tree matching a param (spec) tree.

    Stacked unit params get their leading (unit) dim skipped: the rule is
    matched on the path suffix and the spec is shifted right by one for
    leaves under 'units/'.
    """
    _, model = mesh_axes(mesh)
    rules = _param_rules(model)

    def assign(ps, leaf):
        spec = ()
        for pat, template in rules:
            if re.search(pat, ps):
                spec = template
                break
        if ps.startswith("units/"):
            spec = (None,) + tuple(spec)
        return _fit(mesh, leaf.shape, spec)

    return _walk(assign, param_specs)


def batch_sharding(mesh, batch_specs):
    data, _ = mesh_axes(mesh)
    return _walk(lambda _, leaf: _fit(mesh, leaf.shape, (data,)), batch_specs)


def cache_sharding(mesh, cache_specs_tree):
    """Decode caches: (units, batch, ...) leaves, shape-driven rule.

    * batch (dim 1) shards over data when divisible;
    * the LAST trailing dim divisible by the model size shards over model
      (head_dim for KV caches — robust when n_kv_heads < model size);
      under the ``kv_seq_model`` opt a 5-d ``k``/``v`` cache shards its
      sequence dim over model instead, when it divides;
    * if batch could not shard (long-context batch=1), the first remaining
      trailing dim divisible by data shards over data instead — for KV
      caches that is the sequence dim: sequence-parallel "flash-decode".
    """
    data, model = mesh_axes(mesh)
    data_size = _axis_size(mesh, data)
    model_size = _axis_size(mesh, model)
    kv_seq_model = opts.enabled("kv_seq_model")

    def assign(ps, leaf):
        name = ps.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        used_data = False
        if len(shape) >= 2 and shape[1] % data_size == 0 and data_size > 1:
            spec[1] = data
            used_data = True
        if model_size > 1:
            if kv_seq_model and name in ("k", "v") and len(shape) == 5:
                # flash-decode layout: sequence over the model axis
                if shape[2] % model_size == 0:
                    spec[2] = model
            if model not in spec:
                for i in range(len(shape) - 1, 1, -1):
                    if spec[i] is None and shape[i] % model_size == 0:
                        spec[i] = model
                        break
        if not used_data and data_size > 1:
            for i in range(2, len(shape)):
                if spec[i] is None and shape[i] % data_size == 0:
                    spec[i] = data
                    break
        return _fit(mesh, shape, spec)

    return _walk(assign, cache_specs_tree)


def opt_sharding(mesh, param_shardings):
    """The moments' specs as the reference's ``opt_sharding`` gives them:
    the param specs unchanged (its ZeRO refinement is
    :func:`zero1_sharding`)."""
    copy = lambda t: {k: copy(v) for k, v in t.items()} if isinstance(t, dict) else t
    return copy(param_shardings)


def zero1_sharding(mesh, param_specs, param_shardings):
    """Moment specs: param spec + shard dim0 over data if free."""
    data, _ = mesh_axes(mesh)

    def assign(_, leaf_spec, spec):
        spec = list(spec) + [None] * (len(leaf_spec.shape) - len(spec))
        if spec and spec[0] is None:
            return _fit(mesh, leaf_spec.shape, (data, *spec[1:]))
        return _fit(mesh, leaf_spec.shape, spec)

    return _walk(assign, param_specs, param_shardings)


def spec_placements(mesh, spec: Spec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: tensor dim ``i``
    whose entry names axes is ``Shard(i)`` on each of those mesh dims (a
    dim named by ``("pod", "data")`` on both, which must come in mesh
    order, major first, as a ``PartitionSpec`` lists them), every other
    mesh dim ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    out = [Replicate()] * len(names)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {i} are not in the mesh's order {tuple(names)}")
        for j in idx:
            if not out[j].is_replicate():
                raise ValueError(f"mesh dim {names[j]!r} shards two tensor dims in {spec}")
            out[j] = Shard(i)
    return tuple(out)


def placement_tree(mesh, spec_tree):
    """A tree of specs as a tree of placements on ``mesh``."""
    is_spec = lambda s: isinstance(s, tuple) and all(e is None or isinstance(e, tuple) for e in s)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if is_spec(t):
            return spec_placements(mesh, t)
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        raise TypeError(f"not a spec: {t!r}")

    return walk(spec_tree)


def distribute_tree(tree, placements, mesh):
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` with the
    placements of the matching leaf of ``placements``.  Each rank passes
    the same full values; it keeps its own shard, with no collective."""
    from torch.distributed.tensor import DTensor, Replicate

    def place(t, pl):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        if not t.is_meta:  # a meta tensor stays one: shapes only (the dry run)
            t = t.to(mesh.device_type)
        full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return full.redistribute(mesh, pl)

    def walk(t, pl):
        if isinstance(t, dict):
            return {k: walk(v, pl[k]) for k, v in t.items()}
        return place(t, pl)

    return walk(tree, placements)
