"""The training loop of the port: the JAX package's ``repro.launch.train``
on one torch device.

Runs the reference's single-device loop: the loss under autograd with
every unit rematerialised, the global-norm clip and AdamW
(:mod:`repro_torch.distributed.optimizer`), optional int8 error-feedback
gradient compression, step-atomic checkpoints with resume
(:mod:`repro_torch.distributed.checkpoint`, the reference's on-disk
layout: a checkpoint either package wrote resumes in the other), and
heartbeats with straggler tracking.

On a mesh (:func:`make_sharded_train_step`) the same step runs on
DTensors placed by the reference's rules
(:mod:`repro_torch.distributed.sharding`): params by ``param_sharding``,
the AdamW moments by ``zero1_sharding`` (ZeRO-1: sharded over data on top
of the param layout), the batch over data.  The gradients are
reduce-scattered to the moments' layout, the update runs on each rank's
shards with the gradient norm reduced over the mesh, and the new params
are all-gathered back to their layout.  The reference's dry-run lowering
has its counterpart in :mod:`repro_torch.launch.dryrun`, a trace of the
same step on ``meta`` tensors.

On the card every layer's attention runs through the hand-written
``flash_attention`` kernels both ways (``loss_fn``'s default
``attn_backend="kernel"``): the forward writes the row logsumexp and the backward kernel
takes it.  A step (:func:`make_train_step`) makes no host sync; the loop
fetches the loss once a step, as the reference's ``float(loss)`` does.

Usage (the CUDA card by default; ``--device cpu`` for the plain path):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
      --steps 20 --ckpt-dir build/ckpt --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.device import DeviceLike, h2d, resolve_device, to_host
from repro_torch.distributed.checkpoint import latest_step, prune, restore_checkpoint, save_checkpoint
from repro_torch.distributed.fault_tolerance import Heartbeat, StragglerMonitor
from repro_torch.distributed import ctx
from repro_torch.distributed.optimizer import (AdamWConfig, _leaves, _rebuild, adamw_apply, adamw_init,
                                               adamw_update, ef_compress_grads, ef_init)
from repro_torch.distributed.sharding import (batch_sharding, distribute_tree, mesh_axes, param_sharding,
                                              placement_tree, zero1_sharding)
from repro_torch.models.model import init_params, loss_fn, tree_leaves, tree_map

__all__ = [
    "make_train_step",
    "make_sharded_train_step",
    "state_placements",
    "place_state",
    "place_batch",
    "train_loop",
    "synthetic_batch",
    "main",
]


def _loss_and_grads(params, batch, cfg, attn_backend: str = "kernel"):
    """``loss_fn`` (remat on) and its gradient tree; a leaf the loss does
    not use gets a zero gradient, as ``jax.grad`` gives it."""
    leaves = tree_leaves(params)
    req = [a.detach().requires_grad_() for a in leaves]
    it = iter(req)
    loss = loss_fn(tree_map(lambda _: next(it), params), batch, cfg, remat=True, attn_backend=attn_backend)
    if ctx.is_dtensor(loss):  # the data-parallel partial sums: one all-reduce
        loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
    got = torch.autograd.grad(loss, req, allow_unused=True)
    del req
    it = iter([torch.zeros_like(a) if g is None else g for a, g in zip(leaves, got)])
    del got
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(cfg, opt_cfg: AdamWConfig):
    """``train_step(params, opt, batch) -> (params, opt, loss, grad_norm)``:
    the gradient of ``loss_fn`` (remat on, as the reference's default) by
    ``torch.autograd.grad`` over the parameter tree's leaves, then
    ``ef_compress_grads`` when ``opt_cfg.compress``, then ``adamw_update``.
    Returns new trees; loss and norm are 0-d device tensors (no host
    sync).  A leaf the loss does not use (the reference's unused mixer
    norms) gets a zero gradient, as ``jax.grad`` gives it."""
    compress = opt_cfg.compress

    def train_step(params, opt, batch):
        loss, grads = _loss_and_grads(params, batch, cfg)
        if compress:
            grads, opt_resid = ef_compress_grads(grads, opt["ef"])
        new_p, new_core, gn = adamw_update(params, grads, {k: opt[k] for k in ("m", "v", "step")}, opt_cfg)
        new_opt = dict(new_core)
        if compress:
            new_opt["ef"] = opt_resid
        elif "ef" in opt:
            new_opt["ef"] = opt["ef"]
        return new_p, new_opt, loss, gn

    return train_step


def state_placements(mesh, params):
    """(param placements, AdamW state placements) on ``mesh`` by the
    reference's rules: ``param_sharding`` for the params, ``zero1_sharding``
    for ``m`` and ``v``, the step counter replicated."""
    p_specs = param_sharding(mesh, params)
    zero = placement_tree(mesh, zero1_sharding(mesh, params, p_specs))
    return placement_tree(mesh, p_specs), {"m": zero, "v": zero, "step": (Replicate(),) * mesh.ndim}


def place_state(mesh, params, opt):
    """Params and AdamW state (the same full values on every rank) as
    DTensors on ``mesh`` by :func:`state_placements`."""
    p_pl, o_pl = state_placements(mesh, params)
    return distribute_tree(params, p_pl, mesh), distribute_tree(opt, o_pl, mesh)


def place_batch(mesh, batch):
    """A batch (the same full values on every rank) sharded over the data
    axes by ``batch_sharding``."""
    return distribute_tree(batch, placement_tree(mesh, batch_sharding(mesh, batch)), mesh)


def _mesh_norm(shards, mesh):
    """The global norm of leaves laid out on ``mesh``: each rank's sum of
    squares over its shards, divided by the leaf's replica count, summed
    over every rank."""
    parts = []
    for g in shards:
        reps = math.prod(mesh.size(i) for i, pl in enumerate(g.placements) if pl.is_replicate())
        parts.append(g.to_local().float().square().sum() / reps)
    total = DTensor.from_local(torch.stack(parts).sum(), mesh, [Partial()] * mesh.ndim, run_check=False)
    return torch.sqrt(total.full_tensor())


def make_sharded_train_step(cfg, opt_cfg: AdamWConfig, mesh, attn_backend: str = "kernel"):
    """``train_step(params, opt, batch) -> (params, opt, loss, grad_norm)``
    on DTensors placed by :func:`place_state` and :func:`place_batch`:
    :func:`make_train_step`'s step under the mesh (``ctx`` set to its data
    and model axes while it runs).  Every layer's attention runs the
    hand-written kernels on each rank's heads (``local_map``).  The
    gradients come out of the backward as data-parallel partial sums; each
    is reduce-scattered to its moments' ZeRO-1 layout, AdamW updates each
    rank's shards (``adamw_apply``, the norm reduced over the mesh), and
    the new params are all-gathered to the params' layout, so the
    placements that come out equal those that went in.  Loss and norm
    come back as plain 0-d tensors, equal on every rank.  No host sync.
    ``attn_backend="torch"`` runs each rank's heads through the torch
    backend's plain ops under the same placements, so the step moves the
    same data between ranks without the kernels (the dry run traces it so
    on ``meta`` tensors)."""
    if opt_cfg.compress:
        raise ValueError("int8 gradient compression has no sharded step (the reference's mesh step has none)")
    data, model = mesh_axes(mesh)

    def train_step(params, opt, batch):
        saved = ctx.mesh_and_axes()
        ctx.set_axes(mesh, data, model)
        try:
            loss, grads = _loss_and_grads(params, batch, cfg, attn_backend)
        finally:
            ctx.set_axes(*saved)
        p_l, g_l = _leaves(params), _leaves(grads)
        m_l, v_l = _leaves(opt["m"]), _leaves(opt["v"])
        zero = [m.placements for m in m_l]
        g_z = [g.redistribute(mesh, pl) for g, pl in zip(g_l, zero)]
        p_z = [a.redistribute(mesh, pl) for a, pl in zip(p_l, zero)]
        gn = _mesh_norm(g_z, mesh)
        new_p, m_new, v_new, step = adamw_apply(
            [a.to_local() for a in p_z], [g.to_local() for g in g_z], [m.to_local() for m in m_l],
            [v.to_local() for v in v_l], opt["step"].to_local(), gn, opt_cfg)
        wrap = lambda xs, pls: [DTensor.from_local(x, mesh, pl, run_check=False) for x, pl in zip(xs, pls)]
        new_p = [x.redistribute(mesh, a.placements) for x, a in zip(wrap(new_p, zero), p_l)]
        new_opt = {"m": _rebuild(opt["m"], iter(wrap(m_new, zero))), "v": _rebuild(opt["v"], iter(wrap(v_new, zero))),
                   "step": DTensor.from_local(step, mesh, opt["step"].placements, run_check=False)}
        if "ef" in opt:
            new_opt["ef"] = opt["ef"]
        return _rebuild(params, iter(new_p)), new_opt, loss.to_local(), gn

    return train_step


def synthetic_batch(cfg, batch: int, seq: int, step: int, device: DeviceLike = None):
    """The reference's synthetic batch of ``step`` (the same
    ``np.random.default_rng(1234 + step)`` draws), as tensors on ``device``
    (the CUDA card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1234 + step)
    if cfg.precomputed_embeddings:
        embeds = rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab, (batch, seq, cfg.n_codebooks)).astype(np.int32)
        return {"embeds": h2d(embeds, dev), "labels": h2d(labels, dev)}
    toks = rng.integers(0, cfg.vocab, (batch, seq + 1))
    return {
        "tokens": h2d(toks[:, :-1].astype(np.int32), dev),
        "labels": h2d(toks[:, 1:].astype(np.int32), dev),
    }


def _to_numpy(tree):
    return tree_map(lambda a: to_host(a.detach()), tree)


def train_loop(
    cfg,
    steps: int,
    batch: int,
    seq: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 10,
    opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3),
    resume: bool = True,
    host_id: str = "host0",
    verbose: bool = True,
    data_fn=None,
    device: DeviceLike = None,
):
    """Returns (params, losses).  Resumes from ``ckpt_dir`` when it holds a
    committed step.  Runs on ``device`` (the CUDA card by default)."""
    dev = resolve_device(device)
    params = init_params(cfg, 0, device=dev)
    opt = adamw_init(params)
    if opt_cfg.compress:
        opt["ef"] = ef_init(params)
    start = 0
    if ckpt_dir and resume and latest_step(ckpt_dir) is not None:
        (p_np, o_np), start, _ = restore_checkpoint(ckpt_dir, (params, opt))
        up = lambda like, a: torch.from_numpy(np.asarray(a, dtype=np.float32 if like.is_floating_point()
                                                         else np.int32).copy()).to(dev)
        params, opt = tree_map(up, params, p_np), tree_map(up, opt, o_np)
        if verbose:
            print(f"[train] resumed from step {start}")
    step_fn = make_train_step(cfg, opt_cfg)
    hb = Heartbeat(ckpt_dir + "/hb", host_id) if ckpt_dir else None
    mon = StragglerMonitor()
    data_fn = data_fn or (lambda s: synthetic_batch(cfg, batch, seq, s, dev))

    losses = []
    for step in range(start, steps):
        t0 = time.perf_counter()
        b = data_fn(step)
        params, opt, loss, gn = step_fn(params, opt, b)
        losses.append(float(to_host(loss)))  # the step's one fetch: its time ends here
        dt = time.perf_counter() - t0
        mon.record(host_id, dt)
        if hb:
            hb.beat(step)
        if verbose and (step % 10 == 0 or step == steps - 1):
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} gnorm {float(to_host(gn)):.3f} ({dt*1e3:.0f} ms)")
        if ckpt_dir and ((step + 1) % ckpt_every == 0 or step == steps - 1):
            save_checkpoint(ckpt_dir, step + 1, (_to_numpy(params), _to_numpy(opt)))
            prune(ckpt_dir, keep=3)
    return params, losses


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    _, losses = train_loop(
        cfg,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        opt_cfg=AdamWConfig(lr=args.lr, compress=args.compress),
        device=args.device,
    )
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
