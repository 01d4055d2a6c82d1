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
score matrix, so it needs no query chunks.  A sliding window
(``cfg.attn_window``) goes to the kernel as its ``window``, the
reference's mask (key j visible to row i iff j <= i and i - j < window),
and the kernel skips the key tiles outside it.  Decode (``attn_decode``) is torch ops on both backends, as
the reference's is XLA: one query against the cache.

Under a mesh (:mod:`repro_torch.distributed.ctx`) the same functions take
DTensors placed by :mod:`repro_torch.distributed.sharding`, and DTensor
propagates the layouts, as GSPMD does for the reference.  Where an op
needs an explicit plan, it runs on each rank's shards through
``torch.distributed.tensor.experimental.local_map``: the kernel
attention (each rank's heads through :class:`FlashAttentionFn`, which
sees plain local tensors), the expert-parallel MoE
(:func:`moe_apply_shard_map`, the reference's ``shard_map``) and the
dispatch of :func:`moe_apply` on a DTensor.  A reshape that would cut a
head in half gathers first (``ctx.reshape``); the constants a layer
builds (positions, masks) join the mesh replicated (``ctx.replicate_like``).
Decode writes the new key and value into each rank's slice of a
mesh-placed cache and pins the attention operands to the cache's layout
under the ``decode_hint`` opt (``kv_seq_model`` picks that layout).
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
from repro_torch.distributed import ctx, opts
from repro_torch.distributed.sharding import mesh_axes
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
    "moe_apply_shard_map",
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
    freqs = ctx.replicate_like(positions, theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
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
    q = ctx.reshape(q, (b, t, h, hd))
    k = ctx.reshape(k, (b, t, kv, hd))
    v = ctx.reshape(v, (b, t, kv, hd))
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


def _window_mask(i, j, window=None):
    mask = j <= i
    if window is not None:
        mask = mask & (i - j < window)
    return mask


def attn_apply(p, x, cfg: ModelConfig, positions=None, backend: str = "kernel"):
    """Training/prefill attention: full-sequence causal, optionally
    sliding-window.  x (B, T, d).  The torch backend takes T > Q_CHUNK in
    chunks of Q_CHUNK queries (the score temporary is (B, H, Q_CHUNK, T)),
    as the reference's scan over query chunks does.  On DTensors either
    backend runs on each rank's heads through :func:`_mesh_attention`."""
    if backend not in BACKENDS:
        raise ValueError(f"attention backend {backend!r}; options: {BACKENDS}")
    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    if positions is None:
        positions = ctx.replicate_like(x, torch.arange(t, dtype=torch.int32, device=x.device)[None, :].expand(b, t))
    q, k, v = _qkv(p, x, cfg, positions)
    attend = _kernel_attention if backend == "kernel" else _torch_attention
    if ctx.is_dtensor(q):
        out = _mesh_attention(q, k, v, cfg.attn_window, attend)
    else:
        out = attend(q, k, v, cfg.attn_window).reshape(b, t, h * hd)
    return out @ p["wo"].to(x.dtype)


def _torch_attention(q, k, v, window=None):
    """The torch backend on plain tensors q (B,T,H,hd), k/v (B,T,K,hd):
    :func:`_sdpa` under the causal (windowed) mask, over query chunks of
    ``Q_CHUNK`` where T is longer.  Returns (B, T, K, H // K, hd)."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(b, t, kv, h // kv, hd)
    j = torch.arange(t, device=q.device)[None, :]
    mask = lambda rows: _window_mask(j.T[rows], j, window)
    if t <= Q_CHUNK:
        return _sdpa(q, k, v, mask(slice(None)))
    assert t % Q_CHUNK == 0, "pad sequence to the attention chunk"
    return torch.cat([
        _sdpa(q[:, c:c + Q_CHUNK], k, v, mask(slice(c, c + Q_CHUNK)))
        for c in range(0, t, Q_CHUNK)
    ], dim=1)


def _kernel_attention(q, k, v, window=None):
    """Causal attention, over a sliding ``window`` where one is given,
    through the hand-written kernels: under autograd (grad enabled and an
    input that requires it) :class:`FlashAttentionFn`, whose forward writes
    the logsumexp that its backward kernel takes."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return fa_ops.FlashAttentionFn.apply(q, k, v, True, window)
    return fa_ops.flash_attention(q, k, v, causal=True, window=window)


def _mesh_attention(q, k, v, window=None, attend=_kernel_attention):
    """Attention on DTensors q (B,T,H,hd), k/v (B,T,K,hd) -> (B, T, H * hd):
    ``local_map`` hands each rank its batch rows (Shard over the data axes
    when B divides) and its heads (Shard over model when both H and K
    divide the model size, else every head), and ``attend`` (the kernels,
    or the torch backend's plain ops) runs on those local tensors; the
    logsumexp the kernel's forward writes for the backward is per rank and
    so carries the same placement.  Neither backend sees a DTensor, and
    both move the same data between ranks.  Each rank merges its heads
    into the output's last dim itself, so no DTensor view splits that dim
    again in the backward (one whose shards would cut a head raises)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    sizes = ctx.mesh_sizes(mesh)
    b, h, kv = q.shape[0], q.shape[2], k.shape[2]
    data, model = mesh_axes(mesh)
    dsize = math.prod(sizes[n] for n in data)
    msize = math.prod(sizes[n] for n in model)
    pl = []
    for n in sizes:
        if n in data and b % dsize == 0:
            pl.append(Shard(0))
        elif n in model and h % msize == 0 and kv % msize == 0:
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    merged = lambda q_, k_, v_: attend(q_, k_, v_, window).reshape(q_.shape[0], q_.shape[1], -1)
    fn = local_map(merged, out_placements=pl,
                   in_placements=(pl, pl, pl), device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


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
    slot = (pos % s).long()
    _cache_write(ck, k[:, 0], slot)
    _cache_write(cv, v[:, 0], slot)
    j = ctx.replicate_like(pos, torch.arange(s, device=x.device)[None, :])  # (1,S)
    # ring semantics: before wrap only slots <= pos are live; after wrap all
    mask = (j <= pos[:, None]) | (pos[:, None] >= s)
    if opts.enabled("decode_hint"):
        # pin the attention operands to the CACHE layout, so the cache is
        # not moved between layouts per op
        tpl = ("data", "model", None, None) if opts.enabled("kv_seq_model") else ("data", None, None, "model")
        ck, cv = ctx.hint(ck, tpl), ctx.hint(cv, tpl)
    out = _sdpa(ctx.reshape(q, (b, 1, kv, h // kv, hd)), ck, cv, mask[:, None, :])  # (B,1,S) mask
    out = ctx.reshape(out, (b, 1, h * hd)) @ p["wo"].to(x.dtype)
    pos.add_(1)
    return out, cache


@torch.no_grad()
def _cache_write(c, u, slot):
    """``c[i, slot[i]] = u[i]`` for every row i: c (B, S, ...), u (B, ...),
    slot (B,) in [0, S).  On a DTensor cache each rank writes the rows it
    holds into its own slice of the sequence, where the slot falls in it
    (``u`` and ``slot`` are laid out to the cache's rows and trailing dims
    first): no rank gathers the cache."""
    if not ctx.is_dtensor(c):
        c[torch.arange(c.shape[0], device=c.device), slot] = u.to(c.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = c.device_mesh, c.placements
    u_pl = [Shard(q.dim - 1) if q.is_shard() and q.dim >= 2 else q if q.is_shard(0) else Replicate() for q in pl]
    s_pl = [q if q.is_shard(0) else Replicate() for q in pl]
    c_l = c.to_local()
    u_l = u.redistribute(mesh, u_pl).to_local()
    slot_l = slot.redistribute(mesh, s_pl).to_local()
    s_local = c_l.shape[1]
    local = slot_l - ctx.mesh_coordinate(mesh, [i for i, q in enumerate(pl) if q.is_shard(1)]) * s_local
    mine = (local >= 0) & (local < s_local)
    local = torch.where(mine, local, 0)
    rows = torch.arange(c_l.shape[0], device=c_l.device)
    keep = mine.reshape(-1, *([1] * (u_l.dim() - 1)))
    c_l[rows, local] = torch.where(keep, u_l.to(c_l.dtype), c_l[rows, local])


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
    """The dispatch of one row of tokens: top-k routing, a stable sort of
    the (token, choice) pairs by expert, each pair's place in its expert's
    run, and its slot in the (E * cap) buffer, ``E * cap`` (the sentinel
    row) where the expert's capacity is spent; ``cap`` is per row, from
    the row's T.  Returns the router's probabilities, the top-k ids,
    ``cap``, and per sorted pair its token, gate, whether it is kept and
    its slot."""
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


def _moe_experts(p, hbuf, dtype):
    """The SwiGLU experts over an (E, cap, d) buffer (E may be a slice)."""
    hid = F.silu(torch.einsum("ecd,edf->ecf", hbuf, p["w1"].to(dtype)))
    hid = hid * torch.einsum("ecd,edf->ecf", hbuf, p["w3"].to(dtype))
    return torch.einsum("ecf,efd->ecd", hid, p["w2"].to(dtype))


def _moe_combine(ybuf, st, sg, keep, slot, t: int):
    """Each token's gated sum of its kept choices' expert outputs (the
    reference's ``segment_sum``): every token has k sorted pairs, gathered
    in their sorted order into (T, k, d) and added from zero one choice at
    a time, the order in which a sequential segment sum adds them.  No
    atomics: ``index_add_``'s on the card add in a varying order, and
    serving a MoE gave different tokens from one call to the next."""
    contrib = ybuf[torch.clamp(slot, max=ybuf.shape[0] - 1)] * sg[:, None].to(ybuf.dtype)
    contrib = torch.where(keep[:, None], contrib, 0.0)
    k = st.shape[0] // t
    per_token = contrib[torch.argsort(st, stable=True)].reshape(t, k, -1)
    y = torch.zeros((t, ybuf.shape[1]), dtype=contrib.dtype, device=ybuf.device)
    for j in range(k):
        y = y + per_token[:, j]
    return y


def _moe_row(p, x, cfg: ModelConfig):
    """One row's dispatch (x (T, d), plain tensors): (y, probs, top-k ids)."""
    t, d = x.shape
    e = cfg.moe.n_experts
    probs, idx, cap, st, sg, keep, slot = _moe_route(p, x, cfg)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[st]
    ybuf = _moe_experts(p, buf[: e * cap].reshape(e, cap, d), x.dtype).reshape(e * cap, d)
    return _moe_combine(ybuf, st, sg, keep, slot, t), probs, idx


def _moe_balance(probs, idx, cfg: ModelConfig):
    """The GShard load-balancing terms: the mean router probability and
    the top-1 dispatch fraction per expert, over the tokens given."""
    e = cfg.moe.n_experts
    return probs.mean(dim=0), F.one_hot(idx[:, 0], e).float().mean(dim=0)


def moe_apply(p, x, cfg: ModelConfig):
    """x (T, d) -> (y (T, d), aux_loss).  Static capacity C per expert;
    overflow tokens are dropped (GShard/Switch semantics).

    Locality-aware dispatch, as the reference's: the tokens are R rows of
    T / R with R = ``ctx.data_size()`` (1 when meshless, or when R does
    not divide T); routing, the sort and the capacity scatter happen
    within each row, with capacity per row, so a row's drops depend only
    on its own tokens (results under a data axis > 1 differ from R = 1
    where tokens drop, as the reference's do).  A dropped (token, choice)
    is written to a sentinel row past the experts' slots, which is cut
    off (the reference's ``.at[...].set(mode="drop")``).  The aux loss is
    over all T tokens.  On a DTensor each data rank dispatches its own row
    through ``local_map`` with every expert (the weights gathered over
    model), and the balance terms are averaged over the data axes."""
    if ctx.is_dtensor(x):
        return _moe_apply_dtensor(p, x, cfg)
    t, d = x.shape
    r = ctx.data_size()
    if t % max(r, 1) != 0:
        r = 1
    rows = [_moe_row(p, xr, cfg) for xr in x.reshape(r, t // r, d).unbind(0)]
    y = torch.cat([a[0] for a in rows]) if r > 1 else rows[0][0]
    probs = torch.cat([a[1] for a in rows]) if r > 1 else rows[0][1]
    idx = torch.cat([a[2] for a in rows]) if r > 1 else rows[0][2]
    me, ce = _moe_balance(probs, idx, cfg)
    aux = cfg.moe.router_aux_weight * cfg.moe.n_experts * (me * ce).sum()
    return y.to(x.dtype), aux


def _moe_apply_dtensor(p, x, cfg: ModelConfig):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    _, data_axes, _ = ctx.mesh_and_axes()
    t = x.shape[0]
    r = ctx.data_size()
    rows = r > 1 and t % r == 0
    names = ctx.mesh_sizes(mesh)
    on_data = [rows and n in data_axes for n in names]
    x_pl = [Shard(0) if dd else Replicate() for dd in on_data]
    bal_pl = [Partial() if dd else Replicate() for dd in on_data]
    rep = [Replicate()] * mesh.ndim
    n_rows = r if rows else 1

    def body(router, w1, w3, w2, xl):
        y, probs, idx = _moe_row({"router": router, "w1": w1, "w3": w3, "w2": w2}, xl, cfg)
        me, ce = _moe_balance(probs, idx, cfg)
        return y.to(xl.dtype), me / n_rows, ce / n_rows

    # each data rank saw its own tokens: the weights' gradients are partial sums over data
    w_grad = [Partial() if dd else Replicate() for dd in on_data]
    fn = local_map(body, out_placements=(x_pl, bal_pl, bal_pl), in_placements=(rep, rep, rep, rep, x_pl),
                   in_grad_placements=(w_grad, w_grad, w_grad, w_grad, x_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    y, me, ce = fn(p["router"], p["w1"], p["w3"], p["w2"], x)
    me, ce = me.redistribute(mesh, rep), ce.redistribute(mesh, rep)
    return y, cfg.moe.router_aux_weight * cfg.moe.n_experts * (me * ce).sum()


def moe_apply_shard_map(p, x, cfg: ModelConfig):
    """Explicit-EP MoE over the (data, model) mesh set in ``ctx``: the
    reference's ``shard_map`` body run on each rank's shards through
    ``local_map``.

    Activations are replicated across the model axis between TP blocks,
    so expert parallelism needs no token exchange: every (data, model)
    rank dispatches its local tokens against its LOCAL expert slice and
    the per-token expert outputs are summed over the model axis, one
    all-reduce on ``mesh["model"]``'s group: the communication of a dense
    Megatron FFN.  Experts shard over model when they divide it (EP);
    otherwise each rank holds every expert and a slice of the FFN dim
    (expert-TP: mixtral's 8 experts on a 16-way model axis), and the sum
    adds partial FFN products.  Capacity is per data shard.  The aux loss
    is each rank's, averaged over data, then model.  With no mesh, a T
    that the data size does not divide, an FFN dim that model does not
    divide (expert-TP) or a (1, 1) mesh this is :func:`moe_apply`.
    ``x`` is a DTensor, or a plain tensor every rank holds alike (the
    result is then plain too)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, data_axes, model_axes = ctx.mesh_and_axes()
    m = cfg.moe
    t, d = x.shape
    e = m.n_experts
    msize = ctx.model_size()
    dsize = ctx.data_size()
    f = m.d_expert_ff
    # expert-dim EP when experts divide the model axis; otherwise expert-TP
    expert_ep = e % max(msize, 1) == 0
    if (
        mesh is None
        or t % max(dsize, 1) != 0
        or (not expert_ep and f % max(msize, 1) != 0)
        or (dsize == 1 and msize == 1)
    ):
        return moe_apply(p, x, cfg)

    plain = not ctx.is_dtensor(x)
    rep = [Replicate()] * mesh.ndim
    if plain:
        x = DTensor.from_local(x, mesh, rep, run_check=False)
        p = {k: DTensor.from_local(a, mesh, rep, run_check=False) for k, a in p.items()}
    e_local = e // msize if expert_ep else e
    names = list(ctx.mesh_sizes(mesh))
    mdims = [i for i, n in enumerate(names) if n in model_axes]
    r = ctx.mesh_coordinate(mesh, mdims)  # this rank's expert slice (EP)
    on = lambda axes, pl: [pl if n in axes else Replicate() for n in names]
    if expert_ep:
        w_pl = {"w1": on(model_axes, Shard(0)), "w3": on(model_axes, Shard(0)), "w2": on(model_axes, Shard(0))}
    else:  # expert-TP: column-shard w1/w3, row-shard w2
        w_pl = {"w1": on(model_axes, Shard(2)), "w3": on(model_axes, Shard(2)), "w2": on(model_axes, Shard(1))}
    x_pl = on(data_axes, Shard(0))
    y_pl = [Shard(0) if n in data_axes else Partial() if n in model_axes else Replicate() for n in names]
    # each (data, model) rank's aux share, summed over those dims: their mean
    aux_pl = on(data_axes + model_axes, Partial())
    n_ranks = dsize * msize

    def body(router, w1, w3, w2, xl):
        tl = xl.shape[0]
        probs, idx, cap, st, sg, keep, slot = _moe_route({"router": router}, xl, cfg)
        buf = torch.zeros((e * cap + 1, d), dtype=xl.dtype, device=xl.device)
        buf[slot] = xl[st]
        buf = buf[: e * cap].reshape(e, cap, d)
        local = buf[r * e_local:(r + 1) * e_local] if expert_ep else buf
        yb = _moe_experts({"w1": w1, "w3": w3, "w2": w2}, local, xl.dtype).reshape(e_local * cap, d)
        # place this rank's expert outputs into the global buffer layout:
        # the sum over model adds expert slices (EP) or partial FFN sums (TP)
        ybuf = F.pad(yb, (0, 0, r * e_local * cap, (e - (r + 1) * e_local) * cap)) if expert_ep else yb
        y = _moe_combine(ybuf, st, sg, keep, slot, tl)
        me, ce = _moe_balance(probs, idx, cfg)
        return y, m.router_aux_weight * e * (me * ce).sum() / n_ranks

    # gradients: every rank saw its own tokens (partial over data) and, on
    # the model axis, only its own experts or FFN slice (the router's and
    # the tokens' gradients are partial over model too)
    over_data = lambda pl: [Partial() if n in data_axes else q for n, q in zip(names, pl)]
    fn = local_map(body, out_placements=(y_pl, aux_pl),
                   in_placements=(rep, w_pl["w1"], w_pl["w3"], w_pl["w2"], x_pl),
                   in_grad_placements=(aux_pl, over_data(w_pl["w1"]), over_data(w_pl["w3"]),
                                       over_data(w_pl["w2"]), y_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    y, aux = fn(p["router"], p["w1"], p["w3"], p["w2"], x)
    # the reference's psum over model (an all-reduce on the model dim's
    # group), and its pmeans of aux over data, then model
    y = y.redistribute(mesh, x_pl)
    aux = aux.redistribute(mesh, rep)
    if plain:
        return y.full_tensor(), aux.full_tensor()
    return y, aux


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
