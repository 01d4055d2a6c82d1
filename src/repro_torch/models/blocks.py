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
reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx, opts
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

__all__ = ["block_init", "block_apply", "block_decode", "block_cache_init", "ATTN_TYPES"]

ATTN_TYPES = ("attn", "moe_attn", "shared_attn")


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
    elif btype == "mamba2":
        x = x + S.mamba2_apply(p["mixer"], h, cfg)
    elif btype == "mlstm":
        x = x + S.mlstm_apply(p["mixer"], h, cfg)
    elif btype == "slstm":
        x = x + S.slstm_apply(p["mixer"], h, cfg)
    return x, aux


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
    elif btype == "mamba2":
        y, cache = S.mamba2_decode(p["mixer"], h, cfg, cache)
        x = x + y
    elif btype == "mlstm":
        y, cache = S.mlstm_decode(p["mixer"], h, cfg, cache)
        x = x + y
    elif btype == "slstm":
        y, cache = S.slstm_decode(p["mixer"], h, cfg, cache)
        x = x + y
    return x, cache
