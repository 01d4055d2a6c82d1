"""Dispatching wrapper of the flash_attention kernel.

``flash_attention`` launches the hand-written CUDA kernel
(``src/repro_torch/csrc/flash_attention.cu``, built and loaded through
:mod:`repro_torch.kernels.build`) for CUDA tensors, and takes the plain
PyTorch version (:mod:`.ref`) for tensors on the CPU; there is no other
route and no fallback.  What the kernel cannot take (dtype, head size,
shape, contiguity, alignment, device) raises on either device.

It keeps the contract of the JAX package's wrapper
(``repro.kernels.flash_attention.ops.flash_attention``): q (B, T, H, hd),
k and v (B, S, K, hd) with H % K == 0 (GQA), out (B, T, H, hd) in q's
dtype.  Unlike that wrapper it pads and repeats nothing: the kernel reads
kv head h // (H / K) in place and masks keys at positions >= S, so causal
rows i >= S see exactly the S keys, as the plain version does.  The
block arguments only decide what the JAX wrapper refuses (full attention
over an S that is not a multiple of ``min(block_k, S)``); the kernel
picks its own tiles, and the result does not depend on them.

``launches`` counts kernel launches in this process (one per call that
reached the card); comparisons that call the plain version do not count.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "launches", "HEAD_DIMS", "DTYPES"]

launches = 0

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's template instances
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the launch's dtype code

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, causal, block_q, block_k):
    if not all(isinstance(x, torch.Tensor) for x in (q, k, v)):
        raise TypeError("flash_attention takes torch tensors")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention takes q (B, T, H, hd) and k, v (B, S, K, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, t, h, hd = q.shape
    kb, s, kvh, khd = k.shape
    if kb != b or khd != hd or kvh == 0 or h % kvh:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
            f"(same batch and head size, H % K == 0)"
        )
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head sizes {HEAD_DIMS}, got {hd}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention inputs must share one device")
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive, got {block_q}, {block_k}")
    if not causal and s and s % min(block_k, s):
        raise ValueError("pad S to a block multiple for non-causal attention")


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128, block_k: int = 128):
    """q (B, T, H, hd); k/v (B, S, K, hd) with H % K == 0 (GQA) ->
    (B, T, H, hd): softmax(q k^T / sqrt(hd)) v per head, over keys j <= i
    when ``causal`` (top-left aligned) and over all S keys otherwise."""
    global launches
    _check(q, k, v, causal, block_q, block_k)
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        g = h // kvh
        kk = k.repeat_interleave(g, dim=2) if g > 1 else k
        vv = v.repeat_interleave(g, dim=2) if g > 1 else v
        flat = lambda x, n: x.transpose(1, 2).reshape(b * h, n, hd)
        out = flash_attention_ref(flat(q, t), flat(kk, s), flat(vv, s), causal=causal)
        return out.reshape(b, h, t, hd).transpose(1, 2).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention reads 16-byte vectors; an input is misaligned")
    out = torch.empty_like(q)
    if out.numel() == 0 or s == 0:
        return out.zero_()
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            DTYPES[q.dtype],
            b,
            t,
            s,
            h,
            kvh,
            hd,
            int(bool(causal)),
            1.0 / math.sqrt(hd),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
