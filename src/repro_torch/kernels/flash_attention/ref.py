"""Plain PyTorch version of the flash_attention kernel.

The CPU tests run it, the wrapper takes it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel to it on the card.  It forms the
whole score matrix in float32 with explicit ops, as the JAX package's
``repro.kernels.flash_attention.ref`` does: scores, the ``NEG`` mask
(key ``j`` visible to query ``i`` iff ``j <= i``, keys ``j >= S`` never
exist), softmax, product.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "NEG"]

NEG = -1e30


def flash_attention_ref(q, k, v, causal: bool = True):
    """q (BH, T, hd), k/v (BH, S, hd) -> (BH, T, hd) in q's dtype."""
    t, hd = q.shape[1], q.shape[2]
    s = k.shape[1]
    scores = torch.einsum("bth,bsh->bts", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.arange(s, device=q.device)[None, :] <= torch.arange(t, device=q.device)[:, None]
        scores = torch.where(mask[None], scores, NEG)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bts,bsh->bth", w, v.float()).to(q.dtype)
