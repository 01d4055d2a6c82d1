"""Dry run: trace every (architecture x shape x mesh) cell's step on
``meta`` tensors and record its parameter counts, memory per card, cost,
collectives and roofline terms, with no card and nothing allocated.  The
port of the JAX package's ``repro.launch.dryrun``.

Usage (the CPU is enough):
  PYTHONPATH=src python -m repro_torch.launch.dryrun                    # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --force --out /tmp/dry.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh single --out results/dryrun.json

What carries over from the reference: ``input_specs``, ``skip_reason``,
``_n_params``, ``_active_params``, ``main`` with the same command line,
and ``run_cell`` with the same record keys (``status`` "ok", "skipped"
or "error", as the reference's).  Unlike the reference module, it sets
no ``XLA_FLAGS`` and needs no forced host devices.

Where the reference lowers and compiles each cell for a 512-device TPU
mesh and reads XLA's cost, memory and collective analyses, the port
traces each cell's step twice on ``meta`` tensors:

- The plain trace, over the cell's global shapes (``param_specs``,
  ``batch_specs``, ``cache_specs`` and an AdamW state of the same
  shapes): the train step's ``loss_fn`` gradient and AdamW update, the
  prefill's ``forward``, the decode step.  Attention takes
  ``attn_backend="torch"``, the counterpart of the reference's ``_sdpa``
  that the dry run lowers (the kernel takes no ``meta`` tensor).  FLOPs
  come from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, forward, backward and the remat's recompute); "bytes
  accessed" from a ``TorchDispatchMode`` that sums each op's input and
  output bytes, as XLA's own count does per instruction (views move
  nothing and are not counted; eager ops are not fused, so this is above
  a fused program's count).  Per card, both are divided by the mesh's
  size (``launch.mesh.PRODUCTION`` 16 x 16, ``PRODUCTION_MULTI_POD``
  2 x 16 x 16).
- The sharded trace, of the port's own sharded step on ``meta`` DTensors
  over a ``DeviceMesh`` of the cell's mesh under a fake process group of
  its size (``_fake_world``; the group is process-global: one is made only
  where none exists, and destroyed after): ``make_sharded_train_step``
  over ``place_state`` / ``place_batch``, ``forward`` and ``decode_step``
  over params, batch and cache placed by the sharding rules, attention on
  each rank's heads under the kernels' placements.  ``_CollectiveBytes``
  sums the per-rank result bytes of each functional collective inside
  the step (not the placement) under the reference's kind names
  (all-reduce, all-gather, reduce-scatter, all-to-all,
  collective-permute).  ``cost_raw["collective_bytes"]`` is the per-card
  total, the roofline's ``collectives`` lists each kind, ``collective_s``
  is the total over ``hlo_analysis.HW["link_bw"]``, and the record says
  ``"collectives_modelled": true``.  ``collective_trace_s`` is its time
  beside the plain trace's ``compile_s``.

Memory per card comes from the port's placements (``distributed.sharding``:
``param_sharding``, ``zero1_sharding``, ``batch_sharding``,
``cache_sharding``) applied to the shapes of a ``MeshShape``, with no
ranks: each argument's and output's bytes over the product of its sharded
mesh dims, at the cell's full shapes.

Both traces run every layer, so the reference's 1-unit and 2-unit
extrapolation (``src/repro/launch/dryrun.py:225-252``, for an XLA cost
analysis that counts a loop body once) drops out: ``extrapolated_from_units``
is ``[]``.  The one loop extrapolated is the sLSTM's over tokens (the
reference adds ``_slstm_flops_corr`` for it, ``:79-90``): an sLSTM
architecture's train and prefill cells trace the step without its sLSTM
blocks at the cell's T and add the blocks' share, which is affine in T,
from two short traces (``SLSTM_PROBE``); the record says
``"extrapolated_from_seq_len": [64, 128]``.  The counts equal a direct
trace's (``tests/test_torch_dryrun.py`` holds them to one).

A trace repeats a few hundred op signatures many thousand times, so each
op's meta kernel runs once per signature (``_MetaMode``); no count
depends on it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import LM_SHAPES, ModelConfig, ShapeSpec
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.distributed import ctx, opts
from repro_torch.distributed.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.distributed.sharding import (_walk, batch_sharding, cache_sharding, distribute_tree, mesh_axes,
                                              param_sharding, placement_tree, zero1_sharding)
from repro_torch.launch.hlo_analysis import _COLL, roofline
from repro_torch.launch.mesh import PRODUCTION, PRODUCTION_MULTI_POD
from repro_torch.launch.train import make_sharded_train_step, place_batch, place_state
from repro_torch.models.model import (_dtype, batch_specs, cache_specs, decode_step, forward, loss_fn, param_specs,
                                      tree_leaves, tree_map)

__all__ = ["input_specs", "skip_reason", "run_cell", "main"]

OPT = AdamWConfig()


def input_specs(arch: str, shape_name: str):
    """``meta`` stand-ins for every model input of a cell."""
    cfg = get_config(arch)
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    return batch_specs(cfg, shape.seq_len, shape.global_batch, shape.kind)


def _n_params(specs) -> int:
    return sum(a.numel() for a in tree_leaves(specs))


def _active_params(cfg: ModelConfig, specs) -> int:
    """6*N*D uses ACTIVE params for MoE (experts scaled by top_k/E)."""
    counts = []

    def count(ps, leaf):
        n = leaf.numel()
        if re.search(r"moe/w[123]$", ps) and cfg.moe is not None:
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        counts.append(n)

    _walk(count, specs)
    return sum(counts)


def skip_reason(cfg: ModelConfig, shape: ShapeSpec):
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return "full-attention arch: 500k decode needs sub-quadratic attention (DESIGN.md §Arch-applicability)"
    return None


class _BytesAccessed(TorchDispatchMode):
    """The sum of every op's input and output tensor bytes (views, which
    move nothing, left out)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes += sum(x.numel() * x.element_size() for x in _pytree_leaves((args, kwargs, out))
                              if isinstance(x, torch.Tensor))
        return out


def _signature(xs, key: list, tensors: list) -> bool:
    """Append to ``key`` what a meta kernel's output depends on in ``xs``
    (a tensor's dtype, shape, strides and offset; a list's or tuple's items
    in turn; any other value and its type) and to ``tensors`` each tensor;
    False if an item has no hashable form."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            key.append((x.dtype, x.shape, x.stride(), x.storage_offset()))
        elif isinstance(x, (list, tuple)):
            key.append(len(x))
            if not _signature(x, key, tensors):
                return False
        elif isinstance(x, (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
                            torch.memory_format)):
            key.append((type(x), x))
        else:
            return False
    return True


class _MetaMode(TorchDispatchMode):
    """Below the counting modes, runs each op's meta kernel once per
    signature (:func:`_signature`: the op, its tensors' dtypes, shapes and
    strides, its other arguments): a later call with the same signature
    gets fresh ``meta`` tensors of the shapes and strides the kernel
    returned, which is all a meta kernel returns.  A view, an in-place op,
    an op on a tensor subclass (a DTensor) or off ``meta``, or one whose
    output is off ``meta`` or shares an input's storage always runs.  The meta kernels are
    Python and a trace repeats a few hundred signatures many thousand
    times (the layers, the chunk loops, the sLSTM's token loop), so this
    cuts a trace's time about in half and changes no count."""

    def __init__(self):
        super().__init__()
        self._seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self._run(func, args, kwargs or {})

    def _run(self, func, args, kwargs):
        key, tensors = [func], []
        if (not _signature(args, key, tensors) or not _signature(kwargs.items(), key, tensors)
                or func.namespace != "aten" or func.is_view or func._schema.is_mutable
                or any(type(x) is not torch.Tensor or not x.is_meta for x in tensors)):
            return func(*args, **kwargs)
        key = tuple(key)
        got = self._seen.get(key)
        if got is None:
            out = func(*args, **kwargs)
            outs = [out] if isinstance(out, torch.Tensor) else list(out) if isinstance(out, (list, tuple)) else [None]
            ins = {x.untyped_storage()._cdata for x in tensors}
            fresh = all(type(o) is torch.Tensor and o.is_meta and o.untyped_storage()._cdata not in ins for o in outs)
            self._seen[key] = (type(out), [(o.shape, o.stride(), o.dtype) for o in outs]) if fresh else False
            return out
        if got is False:
            return func(*args, **kwargs)
        kind, metas = got
        outs = [torch.empty_strided(sh, st, dtype=dt, device="meta") for sh, st, dt in metas]
        return outs[0] if kind is torch.Tensor else kind(outs)


def _spec_size(mesh, spec) -> int:
    """The product of the mesh dims a spec shards over."""
    sizes = dict(zip(mesh.names, mesh.sizes))
    return math.prod(sizes[a] for axes in spec if axes is not None for a in axes)


def _bytes_on_card(mesh, tree, spec_tree) -> int:
    """Bytes of a tree on one card: each leaf over its spec's shards."""
    sizes = []
    _walk(lambda _, leaf, spec: sizes.append(leaf.numel() * leaf.element_size() // _spec_size(mesh, spec)),
          tree, spec_tree)
    return sum(sizes)


def _logits_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Bytes of the head's logits, (B, T, V) or (B, T, K, V) in the
    activations' dtype."""
    return batch * seq * max(cfg.n_codebooks, 1) * cfg.vocab * _dtype(cfg).itemsize


def _memory(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """Memory per card from the placements at the cell's shapes: each
    argument's and output's bytes over its sharded mesh dims (no trace)."""
    p_specs = param_specs(cfg)
    b_specs = batch_specs(cfg, shape.seq_len, shape.global_batch, shape.kind)
    p_sh = param_sharding(mesh, p_specs)
    args = {"params": _bytes_on_card(mesh, p_specs, p_sh),
            "batch": _bytes_on_card(mesh, b_specs, batch_sharding(mesh, b_specs))}
    data, _ = mesh_axes(mesh)
    data_size = math.prod(dict(zip(mesh.names, mesh.sizes))[a] for a in data)
    alias = 0
    if shape.kind == "train":
        z1 = zero1_sharding(mesh, p_specs, p_sh)
        args["opt"] = 2 * _bytes_on_card(mesh, p_specs, z1) + adamw_init(p_specs)["step"].element_size()
        out_bytes = args["params"] + args["opt"] + 2 * 4  # new params and state, loss and norm
    elif shape.kind == "prefill":
        out_bytes = _logits_bytes(cfg, shape.global_batch, shape.seq_len) // data_size
    else:
        c_specs = cache_specs(cfg, shape.global_batch, shape.seq_len)
        args["cache"] = alias = _bytes_on_card(mesh, c_specs, cache_sharding(mesh, c_specs))  # donated
        out_bytes = _logits_bytes(cfg, shape.global_batch, 1) // data_size + alias
    return {"argument_size_in_bytes": sum(args.values()), "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias, "arguments": args}


def _trace_cell(cfg: ModelConfig, shape: ShapeSpec):
    """Trace one cell's step on ``meta`` over global shapes: (flops, bytes
    accessed).  Nothing is allocated."""
    p_specs = param_specs(cfg)
    b_specs = batch_specs(cfg, shape.seq_len, shape.global_batch, shape.kind)
    with _MetaMode(), FlopCounterMode(display=False) as flops, _BytesAccessed() as acc:
        if shape.kind == "train":
            opt = adamw_init(p_specs)
            leaves = [a.detach().requires_grad_() for a in tree_leaves(p_specs)]
            it = iter(leaves)
            loss = loss_fn(tree_map(lambda _: next(it), p_specs), b_specs, cfg, remat=True, attn_backend="torch")
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(a) if g is None else g for a, g in zip(leaves, grads)]
            if opts.enabled("bf16_grad_ar"):
                grads = [g.to(torch.bfloat16) for g in grads]
            it = iter(grads)
            adamw_update(p_specs, tree_map(lambda _: next(it), p_specs), opt, OPT)
        elif shape.kind == "prefill":
            with torch.no_grad():
                forward(p_specs, b_specs, cfg, remat=False, attn_backend="torch")
        else:
            c_specs = cache_specs(cfg, shape.global_batch, shape.seq_len)
            with torch.no_grad():
                decode_step(p_specs, c_specs, b_specs, cfg)
    return float(flops.get_total_flops()), float(acc.bytes)


# the functional collectives (``torch.ops._c10d_functional``) by the
# reference's HLO kind; the point-to-point ops are its collective-permute
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "isend": "collective-permute",
    "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
    "shard_dim_alltoall": "all-to-all",  # ``_dtensor``: DTensor's Shard(i) -> Shard(j) on a cuda mesh
}
_NOT_COLLECTIVES = ("_wrap_tensor_autograd", "wait_tensor")  # the same bytes again, or none


class _CollectiveBytes(_MetaMode):
    """Per-rank result bytes of every functional collective, summed by the
    reference's kind names (``hlo_analysis._COLL``).  An op of the
    namespace that the table does not know raises, so none goes
    uncounted."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(_COLL, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = self._run(func, args, kwargs or {})
        if func.namespace in ("_c10d_functional", "_dtensor"):
            name = func.name().split("::")[1]
            if name in _KINDS:
                self.bytes[_KINDS[name]] += sum(x.numel() * x.element_size() for x in _pytree_leaves(out)
                                                if isinstance(x, torch.Tensor))
            elif name not in _NOT_COLLECTIVES:
                raise NotImplementedError(f"collective {func} has no kind in the dry run's table")
        return out


@contextlib.contextmanager
def _fake_world(mesh_shape):
    """A ``DeviceMesh`` of ``mesh_shape`` over a fake process group of its
    size (this process is rank 0; no collective moves data, and on ``meta``
    tensors none reaches the group), destroyed on exit.  The mesh is a
    cuda mesh, as the card's NCCL mesh is, so DTensor picks the
    collectives it picks there (on a cpu mesh it trades an all-to-all for
    an all-gather); no tensor goes to a card.  The group is
    process-global: an initialised one is refused, never replaced."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run traces collectives under a fake process group of the mesh's size, and "
                           "this process already has a process group: run the dry run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh_shape.size)
    try:
        yield init_device_mesh("cuda", mesh_shape.sizes, mesh_dim_names=mesh_shape.names)
    finally:
        dist.destroy_process_group()


def _trace_collectives(cfg: ModelConfig, shape: ShapeSpec, mesh_shape) -> dict:
    """Per-rank bytes of each collective kind in one cell's sharded step,
    traced on ``meta`` DTensors over a ``DeviceMesh`` of ``mesh_shape``
    (a fake process group): the train step of ``make_sharded_train_step``
    over ``place_state`` / ``place_batch``, the prefill's ``forward`` and
    the decode step over params, batch and cache placed by the sharding
    rules.  Attention takes the torch backend's ops on each rank's heads
    under the kernels' placements.  Only the step is counted, not the
    placement."""
    p_specs = param_specs(cfg)
    b_specs = batch_specs(cfg, shape.seq_len, shape.global_batch, shape.kind)
    count = _CollectiveBytes()
    with _fake_world(mesh_shape) as mesh:
        batch = place_batch(mesh, b_specs)
        if shape.kind == "train":
            params, opt = place_state(mesh, p_specs, adamw_init(p_specs))
            step = make_sharded_train_step(cfg, OPT, mesh, attn_backend="torch")
            with count:
                step(params, opt, batch)
        else:
            params = distribute_tree(p_specs, placement_tree(mesh, param_sharding(mesh, p_specs)), mesh)
            if shape.kind == "decode":
                c_specs = cache_specs(cfg, shape.global_batch, shape.seq_len)
                cache = distribute_tree(c_specs, placement_tree(mesh, cache_sharding(mesh, c_specs)), mesh)
            saved = ctx.mesh_and_axes()
            ctx.set_axes(mesh, *mesh_axes(mesh))
            try:
                with torch.no_grad(), count:
                    if shape.kind == "prefill":
                        forward(params, batch, cfg, remat=False, attn_backend="torch")
                    else:
                        decode_step(params, cache, batch, cfg)
            finally:
                ctx.set_axes(*saved)
    return count.bytes


SLSTM_PROBE = (64, 128)  # the two short sequence lengths an sLSTM's increment is traced at


def _extrapolation(cfg: ModelConfig, shape: ShapeSpec):
    """(the config without its sLSTM blocks, :data:`SLSTM_PROBE`) for a
    train or prefill cell of an architecture whose unit holds the sLSTM,
    or None where the cell is traced directly.

    The sLSTM steps token by token, so a direct trace grows with units x
    T (thousands of ops a token).  Its blocks' share of every
    count (FLOPs, bytes, each collective kind) is the difference between
    the cell's step and the same step with those blocks left out, and that
    share is affine in T: each step's work is fixed and nothing in the
    block is chunked (the blocks around it, the mLSTM's chunks and the
    loss's, are the same in both steps and cancel).  So the cell's counts
    are the step without the sLSTM traced at the cell's T, plus the
    share extrapolated from the two short lengths.  Refuses, saying why, a
    unit of sLSTM blocks alone (nothing to trace at full T) or a T the
    probe's step does not divide (the extrapolation would not be exact)."""
    if "slstm" not in cfg.unit or shape.kind == "decode":
        return None
    rest = tuple(b for b in cfg.unit if b != "slstm")
    if not rest:
        raise ValueError(f"{cfg.name}: a unit of sLSTM blocks alone leaves no step to trace at the cell's T")
    t1, t2 = SLSTM_PROBE
    if shape.seq_len % (t2 - t1):
        raise ValueError(f"{cfg.name}: T = {shape.seq_len} is not a multiple of {t2 - t1}, the step between the "
                         f"sLSTM's probe lengths {SLSTM_PROBE}; its extrapolation in T would not be exact")
    return dataclasses.replace(cfg, name=cfg.name + "-no-slstm", unit=rest, n_layers=cfg.n_units * len(rest)), \
        SLSTM_PROBE


def _cell_counts(cfg: ModelConfig, shape: ShapeSpec, mesh, times: dict) -> dict:
    """FLOPs and bytes accessed of the plain trace (global) and per-rank
    bytes of each collective kind of the sharded trace, at ``shape``;
    adds each trace's seconds to ``times``."""
    t0 = time.time()
    flops, bytes_ = _trace_cell(cfg, shape)
    t1 = time.time()
    coll = _trace_collectives(cfg, shape, mesh)
    times["plain"] = times.get("plain", 0.0) + t1 - t0
    times["collectives"] = times.get("collectives", 0.0) + time.time() - t1
    return {"flops": flops, "bytes": bytes_, **coll}


def _counts(cfg: ModelConfig, shape: ShapeSpec, mesh, times: dict):
    """:func:`_cell_counts` of the cell, or (an sLSTM architecture's train
    and prefill cells, :func:`_extrapolation`) the step without the sLSTM
    at the cell's T plus the sLSTM's share, extrapolated from the probe's
    lengths: exact, integer counts, T a multiple of the probe's step.
    Returns (counts, the probe's lengths or None)."""
    ex = _extrapolation(cfg, shape)
    if ex is None:
        return _cell_counts(cfg, shape, mesh, times), None
    rest, (t1, t2) = ex
    at = lambda c, t: _cell_counts(c, dataclasses.replace(shape, seq_len=t), mesh, times)
    share = []
    for t in (t1, t2):
        full, without = at(cfg, t), at(rest, t)
        share.append({k: full[k] - without[k] for k in full})
    n = (shape.seq_len - t1) // (t2 - t1)
    base = at(rest, shape.seq_len)
    return {k: base[k] + share[0][k] + n * (share[1][k] - share[0][k]) for k in base}, [t1, t2]


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose=True, with_roofline=None) -> dict:
    """Trace the full config's step for one cell on ``meta`` and record its
    counts, memory per card, raw cost with the collectives and (single pod
    by default, as the reference's roofline table) roofline terms."""
    cfg = get_config(arch)
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
    }
    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    if with_roofline is None:
        with_roofline = not multi_pod  # roofline table is single-pod

    t0 = time.time()
    mesh = PRODUCTION_MULTI_POD if multi_pod else PRODUCTION
    n_chips = mesh.size
    try:
        p_specs = param_specs(cfg)
        n_act = _active_params(cfg, p_specs)
        rec["n_params"] = _n_params(p_specs)
        rec["n_active_params"] = n_act
        rec["lower_s"] = round(time.time() - t0, 2)  # the specs; the traces below stand for the compile
        times = {}
        counts, probe = _counts(cfg, shape, mesh, times)
        rec["compile_s"] = round(times["plain"], 2)
        rec["collective_trace_s"] = round(times["collectives"], 2)
        rec["memory"] = _memory(cfg, shape, mesh)
        coll = {k: counts[k] for k in _COLL}
        coll["total"] = sum(coll.values())
        rec["cost_raw"] = {"flops": counts["flops"], "bytes": counts["bytes"], "collective_bytes": coll["total"]}
        rec["collectives_modelled"] = True
        if probe:
            rec["extrapolated_from_seq_len"] = probe
        if with_roofline:
            if shape.kind == "train":
                model_flops = 6.0 * n_act * shape.seq_len * shape.global_batch
            elif shape.kind == "prefill":
                model_flops = 2.0 * n_act * shape.seq_len * shape.global_batch
            else:
                model_flops = 2.0 * n_act * shape.global_batch
            cost = {"flops": counts["flops"] / n_chips, "bytes accessed": counts["bytes"] / n_chips}
            rec["roofline"] = roofline(cost, coll, n_chips, model_flops=model_flops)
            # every layer was traced: nothing extrapolated over units
            rec["roofline"]["extrapolated_from_units"] = []
            if probe:
                rec["roofline"]["extrapolated_from_seq_len"] = probe
            rec["roofline"]["collectives_modelled"] = True
        rec["status"] = "ok"
        if verbose:
            trace = f"trace={rec['compile_s']:6.1f}s+{rec['collective_trace_s']:6.1f}s"
            if "roofline" in rec:
                r = rec["roofline"]
                print(
                    f"[ok] {arch:22s} {shape_name:12s} {rec['mesh']:8s} {trace} "
                    f"compute={r['compute_s']*1e3:9.3f}ms mem={r['memory_s']*1e3:9.3f}ms "
                    f"coll={r['collective_s']*1e3:9.3f}ms dom={r['dominant']} "
                    f"frac={r.get('roofline_fraction', 0):.3f}",
                    flush=True,
                )
            else:
                print(f"[ok] {arch:22s} {shape_name:12s} {rec['mesh']:8s} {trace} "
                      f"coll={coll['total']} B (no roofline)", flush=True)
    except Exception as e:  # record the failure; dry-run bugs are OUR bugs
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[ERR] {arch} {shape_name} {rec['mesh']}: {rec['error']}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["both", "single", "multi"])
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in LM_SHAPES] if args.shape == "all" else [args.shape]
    meshes = {"both": [False, True], "single": [False], "multi": [True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
                if key in results and results[key].get("status") in ("ok", "skipped"):
                    continue
                results[key] = run_cell(arch, shape, mp)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"dry-run: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
