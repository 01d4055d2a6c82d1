"""Residual block wrappers per block type, and their caches: the JAX
package's ``repro.models.blocks``.

Block types (cfg.unit entries):
  attn         pre-norm GQA attention + SwiGLU MLP (d_ff > 0)
  moe_attn     pre-norm GQA attention + top-k MoE FFN
  shared_attn  same as attn but parameters are SHARED across all units
               (Zamba2's shared block): they live outside the unit stack
  mamba2       pre-norm Mamba2 (SSD) mixer, no FFN
  mlstm        pre-norm mLSTM mixer, no FFN
  slstm        pre-norm sLSTM mixer, no FFN

``attn_backend`` ("kernel" or "torch", :data:`~repro_torch.models.layers.BACKENDS`)
picks the prefill attention; decode is torch ops on both.  A MoE block
dispatches through ``moe_apply_shard_map`` under the ``moe_shard_map``
opt (on by default; it is ``moe_apply`` when meshless), as the
reference's does.  On DTensors a recurrent mixer runs data-parallel on
each rank's batch rows through ``local_map`` (:func:`_mesh_mixer`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx, opts
from repro_torch.distributed.sharding import mesh_axes
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

__all__ = ["block_init", "block_apply", "block_decode", "block_cache_init", "ATTN_TYPES"]

ATTN_TYPES = ("attn", "moe_attn", "shared_attn")
_MIXERS = {  # block type -> (full-sequence apply, one-token decode)
    "mamba2": (S.mamba2_apply, S.mamba2_decode),
    "mlstm": (S.mlstm_apply, S.mlstm_decode),
    "slstm": (S.slstm_apply, S.slstm_decode),
}


def block_init(gen: Optional[torch.Generator], btype: str, cfg: ModelConfig):
    """A block's parameters drawn from ``gen`` on its device (``gen=None``:
    shapes on ``meta``)."""
    d = cfg.d_model
    p = {"norm1": L.rms_norm_init(d, L._device(gen))}
    if btype in ATTN_TYPES:
        p["attn"] = L.attn_init(gen, cfg)
        if btype == "moe_attn":
            p["norm2"] = L.rms_norm_init(d, L._device(gen))
            p["moe"] = L.moe_init(gen, cfg)
        elif cfg.d_ff > 0:
            p["norm2"] = L.rms_norm_init(d, L._device(gen))
            p["mlp"] = L.mlp_init(gen, d, cfg.d_ff)
    elif btype == "mamba2":
        p["mixer"] = S.mamba2_init(gen, cfg)
    elif btype == "mlstm":
        p["mixer"] = S.mlstm_init(gen, cfg)
    elif btype == "slstm":
        p["mixer"] = S.slstm_init(gen, cfg)
    else:
        raise ValueError(f"unknown block type {btype!r}")
    return p


def block_apply(p, btype: str, x, cfg: ModelConfig, attn_backend: str = "kernel"):
    """Full-sequence (train/prefill). Returns (x, aux_loss)."""
    aux = ctx.replicate_like(x, torch.zeros((), dtype=torch.float32, device=x.device))
    h = L.rms_norm(p["norm1"], x, cfg.norm_eps)
    if btype in ATTN_TYPES:
        x = x + L.attn_apply(p["attn"], h, cfg, backend=attn_backend)
        if btype == "moe_attn":
            h2 = L.rms_norm(p["norm2"], x, cfg.norm_eps)
            b, t, d = h2.shape
            # moe_apply_shard_map falls back to plain dispatch when meshless
            moe_fn = L.moe_apply_shard_map if opts.enabled("moe_shard_map") else L.moe_apply
            y, aux = moe_fn(p["moe"], h2.reshape(b * t, d), cfg)
            x = x + y.reshape(b, t, d)
        elif cfg.d_ff > 0:
            h2 = L.rms_norm(p["norm2"], x, cfg.norm_eps)
            x = x + L.mlp_apply(p["mlp"], h2)
    elif btype in _MIXERS:
        apply = _MIXERS[btype][0]
        if ctx.is_dtensor(h):
            x = x + _mesh_mixer(lambda p_, h_: apply(p_, h_, cfg), p["mixer"], h)
        else:
            x = x + apply(p["mixer"], h, cfg)
    return x, aux


def _mesh_mixer(fn, p, x, cache=None):
    """A recurrent mixer (Mamba2, mLSTM, sLSTM) on DTensors: ``local_map``
    hands each rank its batch rows (Shard over the data axes when B
    divides, else every row) with the mixer's whole weights and, in
    decode, its whole state (both gathered over model), and ``fn`` runs
    the mixer's plain ops on those local tensors: ``fn(p, x)`` -> y, or
    ``fn(p, x, cache)`` -> (y, new cache).  The scans have no head-sharded
    form, so a mixer is data-parallel only.  y comes back with the rows'
    placements, a new cache leaf laid out as the leaf it replaces; each
    data rank saw only its rows, so the weights' gradients are partial
    sums over data.  Returns y, or (y, new cache)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    sizes = ctx.mesh_sizes(mesh)
    data, _ = mesh_axes(mesh)
    rows = x.shape[0] % math.prod(sizes[n] for n in data) == 0
    on_data = [rows and n in data for n in sizes]
    row_pl = [Shard(0) if dd else Replicate() for dd in on_data]
    rep = [Replicate()] * mesh.ndim
    w_grad = [Partial() if dd else Replicate() for dd in on_data]
    weights, spec = tree_flatten(p)
    keys = [] if cache is None else list(cache)
    n = len(weights)

    def body(*args):
        p_l = tree_unflatten(list(args[:n]), spec)
        if cache is None:
            return fn(p_l, args[n])
        y, new = fn(p_l, args[n], dict(zip(keys, args[n + 1:])))
        return (y, *(new[k] for k in keys))

    state = [row_pl] * len(keys)
    mapped = local_map(body, out_placements=row_pl if cache is None else (row_pl, *state),
                       in_placements=(*[rep] * n, row_pl, *state),
                       in_grad_placements=(*[w_grad] * n, row_pl, *state), device_mesh=mesh,
                       redistribute_inputs=True)
    out = mapped(*weights, x, *(cache[k] for k in keys))
    if cache is None:
        return out
    return out[0], {k: a.redistribute(mesh, cache[k].placements) for k, a in zip(keys, out[1:])}


def block_cache_init(btype: str, cfg: ModelConfig, batch: int, cache_len: int, dtype, device=None):
    if btype in ATTN_TYPES:
        kv, hd = cfg.n_kv_heads, cfg.head_dim
        s = cache_len if cfg.attn_window is None else min(cache_len, cfg.attn_window)
        return {
            "k": torch.zeros((batch, s, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, s, kv, hd), dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        }
    if btype == "mamba2":
        return S.mamba2_cache_init(cfg, batch, dtype, device)
    if btype == "mlstm":
        return S.mlstm_cache_init(cfg, batch, dtype, device)
    if btype == "slstm":
        return S.slstm_cache_init(cfg, batch, dtype, device)
    raise ValueError(btype)


def block_decode(p, btype: str, x, cfg: ModelConfig, cache):
    """One token through a block.  Returns (x, cache): an attention block's
    cache is the same dict, updated in place (``attn_decode``); a mixer's
    is a new dict."""
    h = L.rms_norm(p["norm1"], x, cfg.norm_eps)
    if btype in ATTN_TYPES:
        y, cache = L.attn_decode(p["attn"], h, cfg, cache)
        x = x + y
        if btype == "moe_attn":
            h2 = L.rms_norm(p["norm2"], x, cfg.norm_eps)
            b, t, d = h2.shape
            y2, _ = L.moe_apply(p["moe"], h2.reshape(b * t, d), cfg)
            x = x + y2.reshape(b, t, d)
        elif cfg.d_ff > 0:
            h2 = L.rms_norm(p["norm2"], x, cfg.norm_eps)
            x = x + L.mlp_apply(p["mlp"], h2)
    elif btype in _MIXERS:
        decode = _MIXERS[btype][1]
        if ctx.is_dtensor(h):
            y, cache = _mesh_mixer(lambda p_, h_, c_: decode(p_, h_, cfg, c_), p["mixer"], h, cache)
        else:
            y, cache = decode(p["mixer"], h, cfg, cache)
        x = x + y
    return x, cache
