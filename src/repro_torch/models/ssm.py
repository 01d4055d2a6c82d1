"""Recurrent mixers of the port: Mamba2 (SSD), mLSTM and sLSTM (xLSTM), the
JAX package's ``repro.models.ssm`` in torch ops (the reference has no
kernel here either).

Train and prefill paths use the chunked-parallel form (matrix products
inside a chunk, the state carried from chunk to chunk); the reference's
``lax.scan`` over chunks is a Python loop over them, and its scan over
time (sLSTM) a loop over time steps.  Decode paths are O(1)-state
single-step recurrences.  As in the reference: mLSTM uses sigmoid-bounded
gates (the matrix memory and its normaliser column kept, the exp-gate
stabiliser folded away), Mamba2 a single B/C group, every exponent is
clipped to [-60, 0] before ``exp``, and the sLSTM stabiliser starts at
-1e30.  Inits draw from a :class:`torch.Generator` on its device
(``gen=None``: shapes on ``meta``, nothing drawn).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense, _full

__all__ = [
    "mamba2_init",
    "mamba2_apply",
    "mamba2_decode",
    "mamba2_cache_init",
    "mlstm_init",
    "mlstm_apply",
    "mlstm_decode",
    "mlstm_cache_init",
    "slstm_init",
    "slstm_apply",
    "slstm_decode",
    "slstm_cache_init",
]

MAMBA_HEAD_DIM = 64
SSD_CHUNK = 256


def _exp_clip(x):
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def _log_sigmoid(x):
    return -F.softplus(-x)


def _norm_out(y, scale, eps: float):
    """The mixers' closing RMS norm in float32 (no cast back)."""
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + eps) * scale


def _mamba_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    hd = min(MAMBA_HEAD_DIM, d_in)
    h = d_in // hd
    n = cfg.ssm_state
    return d_in, h, hd, n


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------
def mamba2_init(gen: Optional[torch.Generator], cfg: ModelConfig):
    d = cfg.d_model
    d_in, h, hd, n = _mamba_dims(cfg)
    d_proj = 2 * d_in + 2 * n + h  # z, x, B, C, dt
    return {
        "in_proj": _dense(gen, (d, d_proj)),
        "conv_w": _dense(gen, (cfg.conv_width, d_in + 2 * n), scale=0.5),
        "A_log": _full(gen, (h,), 0.0),
        "D": _full(gen, (h,), 1.0),
        "dt_bias": _full(gen, (h,), 0.0),
        "out_proj": _dense(gen, (d_in, d)),
        "norm": {"scale": _full(gen, (d_in,), 1.0)},
    }


def _split_proj(proj, cfg):
    d_in, h, hd, n = _mamba_dims(cfg)
    return torch.split(proj, [d_in, d_in + 2 * n, h], dim=-1)  # z, xbc, dt


def _causal_conv(xbc, w, state=None):
    """xbc (B,T,C); w (W,C) depthwise causal conv.  state (B,W-1,C)."""
    wlen = w.shape[0]
    if state is None:
        pad = torch.zeros(xbc.shape[:1] + (wlen - 1,) + xbc.shape[2:], dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)  # (B, T+W-1, C)
    t = xbc.shape[1]
    out = sum(full[:, i : i + t, :] * w[i][None, None, :].to(xbc.dtype) for i in range(wlen))
    new_state = full[:, -(wlen - 1) :, :] if wlen > 1 else pad
    return F.silu(out), new_state


def _ssd_scan(x, b, c, dt, a_neg, chunk=SSD_CHUNK):
    """Chunked SSD.  x (B,T,H,hd), b/c (B,T,N), dt (B,T,H), a_neg (H,)<0.
    Returns y (B,T,H,hd).  A loop walks the chunks (carry = the SSM state),
    so temporaries stay (B,L,L,H) per chunk."""
    bsz, t, h, hd = x.shape
    n = b.shape[-1]
    l = min(chunk, t)
    assert t % l == 0, "pad sequence to the SSD chunk size"
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    hprev = torch.zeros((bsz, h, n, hd), dtype=x.dtype, device=x.device)
    ys = []
    for c0 in range(0, t, l):
        xc, bc, cc, dtc = x[:, c0 : c0 + l], b[:, c0 : c0 + l], c[:, c0 : c0 + l], dt[:, c0 : c0 + l]
        loga = dtc * a_neg[None, None, :]  # (B,L,H)
        cum = torch.cumsum(loga, dim=1)
        # intra: scores[t,s] = (c_t.b_s) exp(cum_t - cum_s) dt_s, s<=t
        qk = torch.einsum("bln,bmn->blm", cc, bc)
        dec = _exp_clip(cum[:, :, None, :] - cum[:, None, :, :])
        w = qk[..., None] * dec * dtc[:, None, :, :]
        w = torch.where(causal[None, :, :, None], w, 0.0)
        y = torch.einsum("blmh,bmhd->blhd", w, xc)
        # inter from the carried state
        y = y + torch.einsum("bln,blh,bhnd->blhd", cc, _exp_clip(cum), hprev)
        # update the state
        dec_end = _exp_clip(cum[:, -1:, :] - cum)
        s_c = torch.einsum("bln,blh,blhd->bhnd", bc, dec_end * dtc, xc)
        total = _exp_clip(cum[:, -1, :])
        hprev = hprev * total[..., None, None] + s_c
        ys.append(y)
    return torch.cat(ys, dim=1)


def _mamba2_out(p, y, z, x, cfg: ModelConfig):
    y = y * F.silu(z)
    return _norm_out(y, p["norm"]["scale"], cfg.norm_eps).to(x.dtype) @ p["out_proj"].to(x.dtype)


def mamba2_apply(p, x, cfg: ModelConfig):
    bsz, t, d = x.shape
    d_in, h, hd, n = _mamba_dims(cfg)
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt_pre = _split_proj(proj, cfg)
    xbc, _ = _causal_conv(xbc, p["conv_w"])
    xs, b, c = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt_pre.float() + p["dt_bias"])
    a_neg = -torch.exp(p["A_log"])
    xh = xs.reshape(bsz, t, h, hd)
    y = _ssd_scan(xh.float(), b.float(), c.float(), dt, a_neg)
    y = y + p["D"][None, None, :, None] * xh.float()
    return _mamba2_out(p, y.reshape(bsz, t, d_in).to(x.dtype), z, x, cfg)


def mamba2_cache_init(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None):
    d_in, h, hd, n = _mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_in + 2 * n), dtype=dtype, device=device),
        "h": torch.zeros((batch, h, n, hd), dtype=torch.float32, device=device),
    }


def mamba2_decode(p, x, cfg: ModelConfig, cache):
    bsz, t, d = x.shape
    assert t == 1
    d_in, h, hd, n = _mamba_dims(cfg)
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt_pre = _split_proj(proj, cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], state=cache["conv"])
    xs, b, c = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt_pre.float() + p["dt_bias"])[:, 0]  # (B,H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))  # (B,H)
    xh = xs.reshape(bsz, h, hd).float()
    bv = b[:, 0].float()  # (B,N)
    cv = c[:, 0].float()
    hnew = cache["h"] * a[..., None, None] + torch.einsum("bn,bh,bhd->bhnd", bv, dt, xh)
    y = torch.einsum("bn,bhnd->bhd", cv, hnew) + p["D"][None, :, None] * xh
    out = _mamba2_out(p, y.reshape(bsz, 1, d_in).to(x.dtype), z, x, cfg)
    return out, {"conv": conv_state, "h": hnew}


# ---------------------------------------------------------------------------
# mLSTM: matrix memory C (hd x hd+1 with fused normalizer column)
# ---------------------------------------------------------------------------
def mlstm_init(gen: Optional[torch.Generator], cfg: ModelConfig):
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq": _dense(gen, (d, d)),
        "wk": _dense(gen, (d, d)),
        "wv": _dense(gen, (d, d)),
        "wgate": _dense(gen, (d, 2 * h)),  # i, f pre-activations
        "wo_gate": _dense(gen, (d, d)),
        "wout": _dense(gen, (d, d)),
        "norm": {"scale": _full(gen, (d,), 1.0)},
    }


def _mlstm_chunk(q, k, v1, logf, logi, chunk=SSD_CHUNK):
    """q/k (B,T,H,hd), v1 (B,T,H,hdv) [v with ones column], gates (B,T,H).
    The chunk loop of :func:`_ssd_scan` with the matrix memory C carried."""
    bsz, t, h, hd = q.shape
    hdv = v1.shape[-1]
    l = min(chunk, t)
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    cprev = torch.zeros((bsz, h, hd, hdv), dtype=q.dtype, device=q.device)
    ys = []
    for c0 in range(0, t, l):
        qc, kc, vc = q[:, c0 : c0 + l], k[:, c0 : c0 + l], v1[:, c0 : c0 + l]
        lf, li = logf[:, c0 : c0 + l], logi[:, c0 : c0 + l]
        cum = torch.cumsum(lf, dim=1)  # (B,L,H)
        qk = torch.einsum("blhd,bmhd->blmh", qc, kc)
        dec = _exp_clip(cum[:, :, None, :] - cum[:, None, :, :])
        gi = _exp_clip(li)
        w = qk * dec * gi[:, None, :, :]
        w = torch.where(causal[None, :, :, None], w, 0.0)
        y = torch.einsum("blmh,bmhe->blhe", w, vc)
        y = y + torch.einsum("blhd,blh,bhde->blhe", qc, _exp_clip(cum), cprev)
        dec_end = _exp_clip(cum[:, -1:, :] - cum)
        s_c = torch.einsum("blhd,blh,blhe->bhde", kc, dec_end * gi, vc)
        total = _exp_clip(cum[:, -1, :])
        cprev = cprev * total[..., None, None] + s_c
        ys.append(y)
    return torch.cat(ys, dim=1)


def _mlstm_core(p, x, cfg, cache=None):
    bsz, t, d = x.shape
    h = cfg.n_heads
    hd = d // h
    q = (x @ p["wq"].to(x.dtype)).reshape(bsz, t, h, hd) / math.sqrt(hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(bsz, t, h, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(bsz, t, h, hd)
    gates = (x @ p["wgate"].to(x.dtype)).float()
    ipre, fpre = torch.split(gates, h, dim=-1)  # (B,T,h): i first, then f
    logf = _log_sigmoid(fpre)
    logi = _log_sigmoid(ipre)
    ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    v1 = torch.cat([v, ones], dim=-1)
    if cache is None:
        y = _mlstm_chunk(q.float(), k.float(), v1.float(), logf, logi)
    else:
        f = torch.exp(logf[:, 0])  # (B,h)
        i = torch.exp(logi[:, 0])
        cnew = cache["C"] * f[..., None, None] + torch.einsum(
            "bhd,bh,bhe->bhde", k[:, 0].float(), i, v1[:, 0].float()
        )
        y = torch.einsum("bhd,bhde->bhe", q[:, 0].float(), cnew)[:, None]
        cache = {"C": cnew}
    num, den = y[..., :hd], y[..., hd]
    out = num / torch.clamp(den.abs(), min=1.0)[..., None]
    out = out.reshape(bsz, t, d).to(x.dtype)
    out = out * torch.sigmoid(x @ p["wo_gate"].to(x.dtype))
    return out @ p["wout"].to(x.dtype), cache


def mlstm_apply(p, x, cfg: ModelConfig):
    return _mlstm_core(p, x, cfg)[0]


def mlstm_cache_init(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None):
    h = cfg.n_heads
    hd = cfg.d_model // h
    return {"C": torch.zeros((batch, h, hd, hd + 1), dtype=torch.float32, device=device)}


def mlstm_decode(p, x, cfg: ModelConfig, cache):
    return _mlstm_core(p, x, cfg, cache=cache)


# ---------------------------------------------------------------------------
# sLSTM: sequential scalar memory with exp gating + stabilizer
# ---------------------------------------------------------------------------
def slstm_init(gen: Optional[torch.Generator], cfg: ModelConfig):
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    return {
        "wx": _dense(gen, (d, 4 * d)),  # i, f, z, o pre-activations
        "r": _dense(gen, (h, hd, 4 * hd), scale=1.0 / math.sqrt(hd)),
        "wout": _dense(gen, (d, d)),
        "norm": {"scale": _full(gen, (d,), 1.0)},
    }


def _slstm_step(p, cfg, state, xt):
    """state: (h, c, n, m) each (B,H,hd); xt (B, 4d) preactivations."""
    hprev, cprev, nprev, mprev = state
    bsz = xt.shape[0]
    hh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    rec = torch.einsum("bhd,hde->bhe", hprev, p["r"])  # (B,H,4hd)
    raw = xt.reshape(bsz, hh, 4 * hd) + rec
    ipre, fpre, zpre, opre = torch.split(raw, hd, dim=-1)
    mnew = torch.maximum(fpre + mprev, ipre)
    i = torch.exp(ipre - mnew)
    f = torch.exp(fpre + mprev - mnew)
    z = torch.tanh(zpre)
    o = torch.sigmoid(opre)
    cnew = f * cprev + i * z
    nnew = f * nprev + i
    hnew = o * cnew / torch.clamp(nnew, min=1.0)
    return (hnew, cnew, nnew, mnew)


def slstm_apply(p, x, cfg: ModelConfig):
    bsz, t, d = x.shape
    hh, hd = cfg.n_heads, d // cfg.n_heads
    xp = (x @ p["wx"].to(x.dtype)).float()  # (B,T,4d)
    zeros = torch.zeros((bsz, hh, hd), dtype=torch.float32, device=x.device)
    state = (zeros, zeros, zeros, torch.full((bsz, hh, hd), -1e30, dtype=torch.float32, device=x.device))
    hs = []
    # the steps' inputs split once: under autograd their gradient is then one
    # stack, where a view xp[:, i] per step would add T zero-padded copies of xp
    for xt in xp.unbind(1):
        state = _slstm_step(p, cfg, state, xt)
        hs.append(state[0])
    y = torch.stack(hs, dim=1).reshape(bsz, t, d).to(x.dtype)
    return y @ p["wout"].to(x.dtype)


def slstm_cache_init(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None):
    hh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    z = lambda: torch.zeros((batch, hh, hd), dtype=torch.float32, device=device)
    return {"h": z(), "c": z(), "n": z(), "m": torch.full((batch, hh, hd), -1e30, dtype=torch.float32, device=device)}


def slstm_decode(p, x, cfg: ModelConfig, cache):
    bsz = x.shape[0]
    xp = (x[:, 0] @ p["wx"].to(x.dtype)).float()
    state = (cache["h"], cache["c"], cache["n"], cache["m"])
    hnew, cnew, nnew, mnew = _slstm_step(p, cfg, state, xp)
    y = hnew.reshape(bsz, 1, cfg.d_model).to(x.dtype)
    out = y @ p["wout"].to(x.dtype)
    return out, {"h": hnew, "c": cnew, "n": nnew, "m": mnew}
