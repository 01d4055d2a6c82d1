"""Transformer layers of the port: RMS norm, RoPE, GQA attention (full or
sliding-window, prefill and one-token decode against a KV cache), the
SwiGLU MLP and the sort-based top-k MoE with static capacity: the JAX
package's ``repro.models.layers``.

Functional core, as in the reference: ``*_init`` draws a parameter dict
from a :class:`torch.Generator` on the generator's device (``gen=None``
builds the shapes on ``meta`` and draws nothing), ``*_apply`` consumes
one.  Weights keep the JAX layout ``x @ W`` with W (in, out), so carrying
weights across is a copy (:mod:`repro_torch.convert`).  Weights are
float32 and are cast to the activations' dtype at every use, as the
reference's ``.astype(x.dtype)``.  :class:`RMSNorm`, :class:`Attention`
and :class:`MLP` hold the same dicts as ``nn.Module`` parameters.

Attention has two backends: ``"kernel"`` runs the hand-written CUDA
``flash_attention`` (the plain version on the CPU), ``"torch"`` is the
counterpart of the reference's XLA ``_sdpa`` (the score matrix in
explicit ops, queries in chunks of ``Q_CHUNK`` above it, as the reference
scans them).  Under autograd (grad enabled and an input that requires
it) the kernel backend goes through
:class:`~repro_torch.kernels.flash_attention.ops.FlashAttentionFn`, whose
backward is the hand-written backward kernel at every shape (the short
path's for T, S <= 32, the long backward otherwise); the torch backend is
differentiated by autograd, as the reference's train step differentiates
``_sdpa``.  The kernel never forms the
score matrix, so it needs no query chunks.  It has no window: a sliding
window that masks something (T > ``attn_window``) raises on the kernel
backend (ROADMAP A15); at T <= window the mask is the causal one and the
kernel runs.  Decode (``attn_decode``) is torch ops on both backends, as
the reference's is XLA: one query against the cache.

Not ported: ``moe_apply_shard_map``, the reference's expert-parallel MoE
over a mesh, and the mesh hints in ``moe_apply``; the port runs the LM on
one device, where the reference's dispatch is :func:`moe_apply`'s
(ROADMAP A12b).
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
    "Q_CHUNK",
]

NEG = -1e30
BACKENDS = ("kernel", "torch")


def _device(gen: Optional[torch.Generator]) -> torch.device:
    """Where an init puts its tensors: the generator's device, or ``meta``
    (shapes only) when there is no generator."""
    return torch.device("meta") if gen is None else gen.device


def _dense(gen: Optional[torch.Generator], shape, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * scale


def _full(gen: Optional[torch.Generator], shape, value: float):
    return torch.full(shape, value, dtype=torch.float32, device=_device(gen))


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------
def rms_norm_init(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


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
def attn_init(gen: torch.Generator, cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense(gen, (d, h * hd)),
        "wk": _dense(gen, (d, kv * hd)),
        "wv": _dense(gen, (d, kv * hd)),
        "wo": _dense(gen, (h * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = _full(gen, (h * hd,), 0.0)
        p["bk"] = _full(gen, (kv * hd,), 0.0)
        p["bv"] = _full(gen, (kv * hd,), 0.0)
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(hd, _device(gen))
        p["k_norm"] = rms_norm_init(hd, _device(gen))
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
    """q (B,T,K,G,hd), k/v (B,S,K,hd), mask (T,S) or (B,T,S): the
    reference's XLA attention with explicit ops (scores in float32, the
    softmax by max, exp and sum in float32, then the product in q's
    dtype)."""
    hd = q.shape[-1]
    scores = (torch.einsum("btkgh,bskh->bkgts", q, k) / math.sqrt(hd)).float()
    mask = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    scores = torch.where(mask, scores, NEG)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    w = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bkgts,bskh->btkgh", w, v)


Q_CHUNK = 1024  # the torch backend takes queries in chunks above this T


def _window_mask(i, j, cfg: ModelConfig):
    mask = j <= i
    if cfg.attn_window is not None:
        mask = mask & (i - j < cfg.attn_window)
    return mask


def attn_apply(p, x, cfg: ModelConfig, positions=None, backend: str = "kernel"):
    """Training/prefill attention: full-sequence causal, optionally
    sliding-window.  x (B, T, d).  The torch backend takes T > Q_CHUNK in
    chunks of Q_CHUNK queries (the score temporary is (B, H, Q_CHUNK, T)),
    as the reference's scan over query chunks does."""
    if backend not in BACKENDS:
        raise ValueError(f"attention backend {backend!r}; options: {BACKENDS}")
    b, t, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if backend == "kernel" and cfg.attn_window is not None and t > cfg.attn_window:
        raise NotImplementedError(
            f"flash_attention has no sliding window (ROADMAP A15): {cfg.name} has attn_window="
            f"{cfg.attn_window} < T = {t}; use attn_backend='torch'"
        )
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)[None, :].expand(b, t)
    q, k, v = _qkv(p, x, cfg, positions)
    if backend == "kernel":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            out = fa_ops.FlashAttentionFn.apply(q, k, v, True)
        else:
            out = fa_ops.flash_attention(q, k, v, causal=True)
        return out.reshape(b, t, h * hd) @ p["wo"].to(x.dtype)
    q = q.reshape(b, t, kv, h // kv, hd)
    j = torch.arange(t, device=x.device)[None, :]
    if t <= Q_CHUNK:
        out = _sdpa(q, k, v, _window_mask(j.T, j, cfg))
    else:
        assert t % Q_CHUNK == 0, "pad sequence to the attention chunk"
        out = torch.cat([
            _sdpa(q[:, c:c + Q_CHUNK], k, v, _window_mask(j.T[c:c + Q_CHUNK], j, cfg))
            for c in range(0, t, Q_CHUNK)
        ], dim=1)
    return out.reshape(b, t, h * hd) @ p["wo"].to(x.dtype)


def attn_decode(p, x, cfg: ModelConfig, cache: dict):
    """One-token decode against a KV cache, on either backend (torch ops).

    cache: {"k": (B,S,kv,hd), "v": (B,S,kv,hd), "pos": (B,) int32}.  S is
    the cache's capacity: the sequence length for full attention, or the
    window for sliding-window attention, where the cache is a ring buffer
    (slot = pos % S; RoPE is applied at absolute positions when a key is
    written, so slots need no re-rotation).  Unlike the reference, which
    returns new arrays, this writes the new key and value into the cache's
    tensors in place and advances ``pos`` in place: it returns the same
    dict, whose tensors now hold the new state."""
    b, t, _ = x.shape
    assert t == 1
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = cache["pos"]  # (B,)
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    ck, cv = cache["k"], cache["v"]
    s = ck.shape[1]
    rows = torch.arange(b, device=x.device)
    slot = (pos % s).long()
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    j = torch.arange(s, device=x.device)[None, :]  # (1,S)
    # ring semantics: before wrap only slots <= pos are live; after wrap all
    mask = (j <= pos[:, None]) | (pos[:, None] >= s)
    out = _sdpa(q.reshape(b, 1, kv, h // kv, hd), ck, cv, mask[:, None, :])  # (B,1,S) mask
    out = out.reshape(b, 1, h * hd) @ p["wo"].to(x.dtype)
    pos.add_(1)
    return out, cache


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


# ---------------------------------------------------------------------------
# MoE (top-k, static capacity, sort-based dispatch)
# ---------------------------------------------------------------------------
def moe_init(gen: torch.Generator, cfg: ModelConfig):
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_expert_ff
    return {
        "router": _dense(gen, (d, e)),
        "w1": _dense(gen, (e, d, f)),
        "w3": _dense(gen, (e, d, f)),
        "w2": _dense(gen, (e, f, d)),
    }


def _moe_route(p, x, cfg: ModelConfig):
    """The dispatch of :func:`moe_apply`: top-k routing, a stable sort of
    the (token, choice) pairs by expert, each pair's place in its expert's
    run, and its slot in the (E * cap) buffer, ``E * cap`` (the sentinel
    row) where the expert's capacity is spent.  Returns the router's
    probabilities, the top-k ids, ``cap``, and per sorted pair its token,
    gate, whether it is kept and its slot."""
    m = cfg.moe
    t, d = x.shape
    e, k = m.n_experts, m.top_k
    logits = (x @ p["router"].to(x.dtype)).float()  # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)  # (T,k), largest first
    gates = gates / gates.sum(dim=-1, keepdim=True)
    cap = int(max(1, math.ceil(t * k / e * m.capacity_factor)))
    dev = x.device
    fe = idx.reshape(t * k)  # flat expert ids
    order = torch.argsort(fe, stable=True)
    se = fe[order]
    st = torch.arange(t, device=dev).repeat_interleave(k)[order]
    sg = gates.reshape(t * k)[order]
    starts = torch.searchsorted(se, torch.arange(e, device=dev))  # left, (E,)
    pos = torch.arange(t * k, device=dev) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)  # (T*k,) in [0, E*cap]
    return probs, idx, cap, st, sg, keep, slot


def moe_apply(p, x, cfg: ModelConfig):
    """x (T, d) -> (y (T, d), aux_loss).  Static capacity C per expert;
    overflow tokens are dropped (GShard/Switch semantics): the reference's
    dispatch on one device (R = 1).  A dropped (token, choice) is written
    to a sentinel row past the experts' slots, which is cut off (the
    reference's ``.at[...].set(mode="drop")``), and the per-token sum of
    the kept choices is an ``index_add_`` (its ``segment_sum``)."""
    m = cfg.moe
    t, d = x.shape
    e = m.n_experts
    probs, idx, cap, st, sg, keep, slot = _moe_route(p, x, cfg)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[st]
    hbuf = buf[: e * cap].reshape(e, cap, d)
    hid = F.silu(torch.einsum("ecd,edf->ecf", hbuf, p["w1"].to(x.dtype)))
    hid = hid * torch.einsum("ecd,edf->ecf", hbuf, p["w3"].to(x.dtype))
    ybuf = torch.einsum("ecf,efd->ecd", hid, p["w2"].to(x.dtype)).reshape(e * cap, d)
    contrib = ybuf[torch.clamp(slot, max=e * cap - 1)] * sg[:, None].to(x.dtype)
    contrib = torch.where(keep[:, None], contrib, 0.0)
    y = torch.zeros((t, d), dtype=contrib.dtype, device=x.device).index_add_(0, st, contrib)
    # GShard load-balancing aux loss
    me = probs.mean(dim=0)  # (E,)
    ce = F.one_hot(idx[:, 0], e).float().mean(dim=0)  # top-1 dispatch fraction
    aux = m.router_aux_weight * e * (me * ce).sum()
    return y.to(x.dtype), aux


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
