"""Transformer layers of the port: RMS norm, RoPE, GQA attention and the
SwiGLU MLP, the parts of the JAX package's ``repro.models.layers`` that
FraudGT runs.

Functional core, as in the reference: ``*_init`` draws a parameter dict
from a :class:`torch.Generator`, ``*_apply`` consumes one.  Weights keep
the JAX layout ``x @ W`` with W (in, out), so carrying weights across is
a copy (:mod:`repro_torch.convert`).  :class:`RMSNorm`, :class:`Attention`
and :class:`MLP` hold the same dicts as ``nn.Module`` parameters.

Attention has two backends: ``"kernel"`` runs the hand-written CUDA
``flash_attention`` (the plain version on the CPU), ``"torch"`` is the
counterpart of the reference's XLA ``_sdpa`` (the whole score matrix,
explicit ops).  Under autograd (grad enabled and an input that requires
it) the kernel backend goes through
:class:`~repro_torch.kernels.flash_attention.ops.FlashAttentionFn`, whose
backward is the hand-written short-path backward kernel; the torch
backend is differentiated by autograd, as the reference's fit
differentiates ``_sdpa``.  Neither chunks the queries above the reference's
``Q_CHUNK`` (1024): the kernel never forms the score matrix, and the
torch backend forms it whole.  Sliding-window attention, decode against a KV
cache and MoE are not ported (ROADMAP A12).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import h2d
from repro_torch.kernels.flash_attention import ops as fa_ops

__all__ = [
    "rms_norm",
    "rms_norm_init",
    "rope",
    "attn_init",
    "attn_apply",
    "mlp_init",
    "mlp_apply",
    "RMSNorm",
    "Attention",
    "MLP",
    "BACKENDS",
    "attn_decode",
    "moe_init",
    "moe_apply",
]

NEG = -1e30
BACKENDS = ("kernel", "torch")


def _dense(gen: torch.Generator, shape, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------
def rms_norm_init(d: int):
    return {"scale": torch.ones((d,), dtype=torch.float32)}


def rms_norm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def rope(x, positions, theta: float):
    """x (..., T, H, hd); positions (..., T)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _unported(cfg: ModelConfig):
    if cfg.attn_window is not None:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (ROADMAP A12); "
            f"{cfg.name} has attn_window={cfg.attn_window}"
        )


def attn_init(gen: torch.Generator, cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense(gen, (d, h * hd)),
        "wk": _dense(gen, (d, kv * hd)),
        "wv": _dense(gen, (d, kv * hd)),
        "wo": _dense(gen, (h * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=torch.float32)
        p["bk"] = torch.zeros((kv * hd,), dtype=torch.float32)
        p["bv"] = torch.zeros((kv * hd,), dtype=torch.float32)
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(hd)
        p["k_norm"] = rms_norm_init(hd)
    return p


def _qkv(p, x, cfg: ModelConfig, positions):
    b, t, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, t, h, hd)
    k = k.reshape(b, t, kv, hd)
    v = v.reshape(b, t, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask):
    """q (B,T,K,G,hd), k/v (B,S,K,hd), mask (T,S): the reference's XLA
    attention with explicit ops (scores in float32, softmax by max,
    exp and sum, then the product)."""
    hd = q.shape[-1]
    scores = torch.einsum("btkgh,bskh->bkgts", q, k) / math.sqrt(hd)
    scores = scores.float()
    scores = torch.where(mask[None, None, None], scores, NEG)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    w = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bkgts,bskh->btkgh", w, v)


def attn_apply(p, x, cfg: ModelConfig, positions=None, backend: str = "kernel"):
    """Training/prefill attention: full-sequence causal.  x (B, T, d)."""
    _unported(cfg)
    if backend not in BACKENDS:
        raise ValueError(f"attention backend {backend!r}; options: {BACKENDS}")
    b, t, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)[None, :].expand(b, t)
    q, k, v = _qkv(p, x, cfg, positions)
    if backend == "kernel":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            out = fa_ops.FlashAttentionFn.apply(q, k, v, True)
        else:
            out = fa_ops.flash_attention(q, k, v, causal=True)
    else:
        j = torch.arange(t, device=x.device)
        out = _sdpa(q.reshape(b, t, kv, h // kv, hd), k, v, j[None, :] <= j[:, None])
    return out.reshape(b, t, h * hd) @ p["wo"].to(x.dtype)


def attn_decode(p, x, cfg: ModelConfig, cache: dict):
    raise NotImplementedError("decode against a KV cache is not ported yet (ROADMAP A12)")


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d: int, d_ff: int):
    return {
        "w1": _dense(gen, (d, d_ff)),
        "w3": _dense(gen, (d, d_ff)),
        "w2": _dense(gen, (d_ff, d)),
    }


def mlp_apply(p, x):
    h = F.silu(x @ p["w1"].to(x.dtype)) * (x @ p["w3"].to(x.dtype))
    return h @ p["w2"].to(x.dtype)


def moe_init(gen: torch.Generator, cfg: ModelConfig):
    raise NotImplementedError("MoE layers are not ported yet (ROADMAP A12)")


def moe_apply(p, x, cfg: ModelConfig):
    raise NotImplementedError("MoE layers are not ported yet (ROADMAP A12)")


# ---------------------------------------------------------------------------
# the same layers as modules (parameters in the reference's dict layout)
# ---------------------------------------------------------------------------
def _param(x, device=None) -> nn.Parameter:
    """A float32 parameter on ``device``, uploaded pinned and non-blocking
    (no host sync), from an array or a tensor of any device."""
    a = np.array(x.detach().cpu() if isinstance(x, torch.Tensor) else x, dtype=np.float32)
    return nn.Parameter(h2d(a, torch.device(device or "cpu")).reshape(a.shape))


class RMSNorm(nn.Module):
    def __init__(self, p, eps: float = 1e-5, device=None):
        super().__init__()
        self.scale = _param(p["scale"], device)
        self.eps = eps

    def tree(self):
        return {"scale": self.scale}

    def forward(self, x):
        return rms_norm(self.tree(), x, self.eps)


class Attention(nn.Module):
    """Causal GQA self-attention over a parameter dict of ``attn_init``'s
    layout; ``backend`` picks the kernel or the torch attention."""

    def __init__(self, p, cfg: ModelConfig, backend: str = "kernel", device=None):
        super().__init__()
        self.cfg = cfg
        self.backend = backend
        self.w = nn.ParameterDict({n: _param(a, device) for n, a in p.items() if not isinstance(a, dict)})
        self.norms = nn.ModuleDict(
            {n: RMSNorm(p[n], cfg.norm_eps, device) for n in ("q_norm", "k_norm") if n in p}
        )

    def tree(self):
        return {**self.w, **{n: m.tree() for n, m in self.norms.items()}}

    def forward(self, x, positions: Optional[torch.Tensor] = None):
        return attn_apply(self.tree(), x, self.cfg, positions, backend=self.backend)


class MLP(nn.Module):
    def __init__(self, p, device=None):
        super().__init__()
        self.w = nn.ParameterDict({n: _param(p[n], device) for n in ("w1", "w3", "w2")})

    def tree(self):
        return dict(self.w)

    def forward(self, x):
        return mlp_apply(self.tree(), x)
