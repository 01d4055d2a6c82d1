"""Plain PyTorch versions of the flash_attention kernel and of its
backward (both the short and the long paths').

The CPU tests run them, the wrapper takes them for tensors on the CPU,
and ``chip_smoke.py`` holds the CUDA kernels to them on the card.  The
forward forms the whole score matrix in float32 with explicit ops, as the
JAX package's ``repro.kernels.flash_attention.ref`` does: scores, the
``NEG`` mask (key ``j`` visible to query ``i`` iff ``j <= i``, keys
``j >= S`` never exist; under a sliding ``window`` also only if
``i - j < window``, the mask of the reference's ``attn_apply``,
``src/repro/models/layers.py:151-152, 163-164``), softmax, product.  The backward is the same
math written out, not autograd: P from the scores and the row logsumexp,
D = rowsum(dO * O), dV = P^T dO, dP = dO V^T, dS = P (dP - D),
dQ = scale dS K, dK = scale dS^T Q.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "flash_attention_bwd_ref", "NEG"]

NEG = -1e30


def _scores(q, k, causal, window=None):
    """float32 (BH, T, S) scores q k^T / sqrt(hd), masked keys at NEG, and
    the mask (None when full)."""
    t, hd = q.shape[1], q.shape[2]
    s = k.shape[1]
    scores = torch.einsum("bth,bsh->bts", q.float(), k.float()) / math.sqrt(hd)
    if not causal:
        return scores, None
    j, i = torch.arange(s, device=q.device)[None, :], torch.arange(t, device=q.device)[:, None]
    mask = j <= i
    if window is not None:
        mask = mask & (i - j < window)
    return torch.where(mask[None], scores, NEG), mask


def flash_attention_ref(q, k, v, causal: bool = True, return_lse: bool = False, window=None):
    """q (BH, T, hd), k/v (BH, S, hd) -> (BH, T, hd) in q's dtype, and with
    ``return_lse`` the rows' float32 logsumexp (BH, T) beside it."""
    scores, _ = _scores(q, k, causal, window)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bts,bsh->bth", w, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def flash_attention_bwd_ref(q, k, v, o, do, lse=None, causal: bool = True, window=None):
    """The gradients of :func:`flash_attention_ref` per head: q, o, do
    (BH, T, hd), k, v (BH, S, hd), the forward's float32 row logsumexp
    ``lse`` (BH, T) (recomputed when None) -> dq (BH, T, hd), dk and dv
    (BH, S, hd), in q's dtype, all sums in float32."""
    hd = q.shape[2]
    scale = 1.0 / math.sqrt(hd)
    scores, mask = _scores(q, k, causal, window)
    if lse is None:
        lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse.float()[..., None])
    if mask is not None:
        p = torch.where(mask[None], p, 0.0)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    d = (dof * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bts,bth->bsh", p, dof)
    dp = torch.einsum("bth,bsh->bts", dof, vf)
    ds = p * (dp - d)
    dq = torch.einsum("bts,bsh->bth", ds, kf) * scale
    dk = torch.einsum("bts,bth->bsh", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
