"""Dry run: trace every (architecture x shape x mesh) cell's step on
``meta`` tensors and record its parameter counts, memory per card, cost
and roofline terms, with no card and nothing allocated.  The port of the
JAX package's ``repro.launch.dryrun``.

Usage (the CPU is enough):
  PYTHONPATH=src python -m repro_torch.launch.dryrun                    # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh single --out results/dryrun.json

What carries over from the reference: ``input_specs``, ``skip_reason``,
``_n_params``, ``_active_params``, ``main`` with the same command line,
and ``run_cell`` with the same record keys (``status`` "ok", "skipped"
or "error", as the reference's).  Unlike the reference module, it sets
no ``XLA_FLAGS`` and needs no forced host devices.

Where the reference lowers and compiles each cell for a 512-device TPU
mesh and reads XLA's cost and memory analyses, the port traces the same
step (the train step's ``loss_fn`` gradient and AdamW update, the
prefill's ``forward``, the decode step) once over the cell's global
shapes on ``meta`` tensors: ``param_specs``, ``batch_specs``,
``cache_specs`` and an AdamW state of the same shapes.  Attention takes
``attn_backend="torch"``, the counterpart of the reference's ``_sdpa``
that the dry run lowers (the kernel takes no ``meta`` tensor).

- FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over the
  trace (matrix products, forward and backward and the remat's recompute).
- "Bytes accessed" comes from a ``TorchDispatchMode`` that sums each op's
  input and output bytes, as XLA's own count does per instruction; views
  move nothing and are not counted.  Eager ops are not fused, so this is
  above a fused program's count.
- Per card, both are divided by the mesh's size
  (``launch.mesh.PRODUCTION`` 16 x 16, ``PRODUCTION_MULTI_POD`` 2 x 16 x
  16).  Memory per card comes from the port's placements
  (``distributed.sharding``: ``param_sharding``, ``zero1_sharding``,
  ``batch_sharding``, ``cache_sharding``) applied to the shapes of a
  ``MeshShape``, with no ranks: each argument's and output's bytes over
  the product of its sharded mesh dims.
- The trace runs every layer, so the reference's 1-unit and 2-unit
  extrapolation and its sLSTM correction (``src/repro/launch/dryrun.py:
  79-90, 225-260``, for an XLA cost analysis that counts a loop body
  once) drop out: ``extrapolated_from_units`` is ``[]``.
- Collectives are not modelled: there is no partitioned program to read
  them from.  ``collective_s`` is 0 and the record says
  ``"collectives_modelled": false``.
"""
from __future__ import annotations

import argparse
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
from repro_torch.distributed import opts
from repro_torch.distributed.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.distributed.sharding import (_walk, batch_sharding, cache_sharding, mesh_axes, param_sharding,
                                              zero1_sharding)
from repro_torch.launch.hlo_analysis import roofline
from repro_torch.launch.mesh import PRODUCTION, PRODUCTION_MULTI_POD
from repro_torch.models.model import (batch_specs, cache_specs, decode_step, forward, loss_fn, param_specs,
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


def _trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Trace one cell's step on ``meta``: (flops, bytes accessed, memory
    per card).  Global shapes; nothing is allocated."""
    p_specs = param_specs(cfg)
    b_specs = batch_specs(cfg, shape.seq_len, shape.global_batch, shape.kind)
    p_sh = param_sharding(mesh, p_specs)
    b_sh = batch_sharding(mesh, b_specs)
    args = {"params": _bytes_on_card(mesh, p_specs, p_sh), "batch": _bytes_on_card(mesh, b_specs, b_sh)}
    out_bytes = alias = 0
    data, _ = mesh_axes(mesh)
    data_size = math.prod(dict(zip(mesh.names, mesh.sizes))[a] for a in data)
    with FlopCounterMode(display=False) as flops, _BytesAccessed() as acc:
        if shape.kind == "train":
            opt = adamw_init(p_specs)
            z1 = zero1_sharding(mesh, p_specs, p_sh)
            opt_bytes = 2 * _bytes_on_card(mesh, p_specs, z1) + opt["step"].element_size()
            args["opt"] = opt_bytes
            leaves = [a.detach().requires_grad_() for a in tree_leaves(p_specs)]
            it = iter(leaves)
            loss = loss_fn(tree_map(lambda _: next(it), p_specs), b_specs, cfg, remat=True, attn_backend="torch")
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(a) if g is None else g for a, g in zip(leaves, grads)]
            if opts.enabled("bf16_grad_ar"):
                grads = [g.to(torch.bfloat16) for g in grads]
            it = iter(grads)
            adamw_update(p_specs, tree_map(lambda _: next(it), p_specs), opt, OPT)
            out_bytes = args["params"] + opt_bytes + 2 * 4  # new params and state, loss and norm
        elif shape.kind == "prefill":
            with torch.no_grad():
                logits, _ = forward(p_specs, b_specs, cfg, remat=False, attn_backend="torch")
            out_bytes = logits.numel() * logits.element_size() // data_size
        else:
            c_specs = cache_specs(cfg, shape.global_batch, shape.seq_len)
            cache = _bytes_on_card(mesh, c_specs, cache_sharding(mesh, c_specs))
            args["cache"] = cache
            with torch.no_grad():
                logits, _ = decode_step(p_specs, c_specs, b_specs, cfg)
            out_bytes = logits.numel() * logits.element_size() // data_size + cache
            alias = cache  # the cache is donated: updated in place
    memory = {"argument_size_in_bytes": sum(args.values()), "output_size_in_bytes": out_bytes,
              "alias_size_in_bytes": alias, "arguments": args}
    return float(flops.get_total_flops()), float(acc.bytes), memory


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose=True, with_roofline=None) -> dict:
    """Trace the full config's step for one cell on ``meta`` and record its
    counts, memory per card, raw cost and (single pod by default, as the
    reference's roofline table) roofline terms."""
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
        rec["lower_s"] = round(time.time() - t0, 2)  # the specs; the trace below stands for the compile
        t1 = time.time()
        flops, bytes_, memory = _trace_cell(cfg, shape, mesh)
        rec["compile_s"] = round(time.time() - t1, 2)
        rec["memory"] = memory
        rec["cost_raw"] = {"flops": flops, "bytes": bytes_, "collective_bytes": 0}
        rec["collectives_modelled"] = False
        if with_roofline:
            if shape.kind == "train":
                model_flops = 6.0 * n_act * shape.seq_len * shape.global_batch
            elif shape.kind == "prefill":
                model_flops = 2.0 * n_act * shape.seq_len * shape.global_batch
            else:
                model_flops = 2.0 * n_act * shape.global_batch
            cost = {"flops": flops / n_chips, "bytes accessed": bytes_ / n_chips}
            rec["roofline"] = roofline(cost, {"total": 0}, n_chips, model_flops=model_flops)
            # every layer was traced: nothing extrapolated
            rec["roofline"]["extrapolated_from_units"] = []
            rec["roofline"]["collectives_modelled"] = False
        rec["status"] = "ok"
        if verbose:
            if "roofline" in rec:
                r = rec["roofline"]
                print(
                    f"[ok] {arch:22s} {shape_name:12s} {rec['mesh']:8s} "
                    f"trace={rec['compile_s']:6.1f}s "
                    f"compute={r['compute_s']*1e3:9.3f}ms mem={r['memory_s']*1e3:9.3f}ms "
                    f"coll=not modelled dom={r['dominant']} "
                    f"frac={r.get('roofline_fraction', 0):.3f}",
                    flush=True,
                )
            else:
                print(f"[ok] {arch:22s} {shape_name:12s} {rec['mesh']:8s} "
                      f"trace={rec['compile_s']:6.1f}s (memory only)", flush=True)
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
