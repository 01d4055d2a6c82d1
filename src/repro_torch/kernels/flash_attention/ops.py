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

Each call is one launch, on the path that :func:`plan` names for its
shape (the ``.cu`` entry makes the same choice, and
``flash_attention_plan`` there reports it): ``"short"`` (T and S at most
32, one batch element's slabs bulk-copied into a ring in shared memory;
FraudGT's shape), ``"wgmma"`` (bf16 at hd 64 or 128: TMA tiles and the
tensor cores) or ``"simt"`` (the rest, on the CUDA cores).  A launch the
card refuses raises; no path stands in for another.

``launches`` counts kernel launches in this process (one per call that
reached the card); comparisons that call the plain version do not count.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "plan", "kernel_plan", "launches", "HEAD_DIMS", "DTYPES", "PATHS"]

launches = 0

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's template instances
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the launch's dtype code
_SCALE = {hd: 1.0 / math.sqrt(hd) for hd in HEAD_DIMS}
PATHS = ("short", "wgmma", "simt")  # in the order of the .cu entry's path codes
# the short path's limits, as in csrc/flash_short.cuh
SHORT_MAX_LEN = 32
SHORT_HEADER = 128  # bytes of barriers before the slabs
SMEM_MAX = 232448  # shared memory a block can use on sm_90 (227 KB)
ERR_TENSOR_MAP = 10001  # the wgmma path's refusal to encode a tensor map (csrc/flash_wgmma.cuh)

_fn = None


def plan(b: int, t: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype, causal: bool) -> str:
    """The path a CUDA launch at this shape takes: ``"short"`` when T and S
    are at most 32 and two stages of one batch element's q, k and v slabs
    fit in a block's shared memory, else ``"wgmma"`` for bf16 at hd 64 or
    128, else ``"simt"``.  A pure function of the shape; the batch size and
    the mask do not change the choice."""
    size = 2 if dtype == torch.bfloat16 else 4
    stage = (t * h + 2 * s * kvh) * hd * size
    if t <= SHORT_MAX_LEN and s <= SHORT_MAX_LEN and SHORT_HEADER + 2 * stage <= SMEM_MAX:
        return "short"
    if dtype == torch.bfloat16 and hd in (64, 128):
        return "wgmma"
    return "simt"


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_plan.argtypes = [ctypes.c_int] * 8
        lib.flash_attention_plan.restype = ctypes.c_int
        _fn = fn
    return _fn


def kernel_plan(b: int, t: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype, causal: bool) -> str:
    """The path the built ``.cu`` entry picks for this shape (needs the
    library, so the card's toolkit): it must equal :func:`plan`."""
    _launcher()
    code = build.load("flash_attention").flash_attention_plan(b, t, s, h, kvh, hd, DTYPES[dtype], int(causal))
    if code < 0:
        raise ValueError(f"flash_attention refuses the shape {(b, t, s, h, kvh, hd, dtype)}")
    return PATHS[code]


def _check(q, k, v, causal, block_q, block_k):
    """Raise on what the kernel does not take; return (b, t, h, hd, s, kvh).
    Written for speed: it runs on each of FraudGT's 3,012 calls a predict."""
    if not (isinstance(q, torch.Tensor) and isinstance(k, torch.Tensor) and isinstance(v, torch.Tensor)):
        raise TypeError("flash_attention takes torch tensors")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or v.shape != ks:
        raise ValueError(
            f"flash_attention takes q (B, T, H, hd) and k, v (B, S, K, hd), got "
            f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}"
        )
    b, t, h, hd = qs
    kb, s, kvh, khd = ks
    if kb != b or khd != hd or kvh == 0 or h % kvh:
        raise ValueError(
            f"flash_attention: k/v {tuple(ks)} do not fit q {tuple(qs)} "
            f"(same batch and head size, H % K == 0)"
        )
    dt = q.dtype
    if dt not in DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head sizes {HEAD_DIMS}, got {hd}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention inputs must share one device")
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive, got {block_q}, {block_k}")
    if not causal and s and s % min(block_k, s):
        raise ValueError("pad S to a block multiple for non-causal attention")
    return b, t, h, hd, s, kvh


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128, block_k: int = 128):
    """q (B, T, H, hd); k/v (B, S, K, hd) with H % K == 0 (GQA) ->
    (B, T, H, hd): softmax(q k^T / sqrt(hd)) v per head, over keys j <= i
    when ``causal`` (top-left aligned) and over all S keys otherwise."""
    global launches
    b, t, h, hd, s, kvh = _check(q, k, v, causal, block_q, block_k)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
        g = h // kvh
        kk = k.repeat_interleave(g, dim=2) if g > 1 else k
        vv = v.repeat_interleave(g, dim=2) if g > 1 else v
        flat = lambda x, n: x.transpose(1, 2).reshape(b * h, n, hd)
        out = flash_attention_ref(flat(q, t), flat(kk, s), flat(vv, s), causal=causal)
        return out.reshape(b, h, t, hd).transpose(1, 2).contiguous()
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("flash_attention reads 16-byte vectors; an input is misaligned")
    out = torch.empty_like(q)
    if out.numel() == 0 or s == 0:
        return out.zero_()
    fn = _launcher()
    dev = q.get_device()
    args = (qp, kp, vp, out.data_ptr(), DTYPES[q.dtype], b, t, s, h, kvh, hd, 1 if causal else 0,
            _SCALE[hd])
    # the raw handle of the current stream, without building a Stream object
    # (this call sits on FraudGT's path 3,012 times a predict)
    if dev == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        path = plan(b, t, s, h, kvh, hd, q.dtype, causal)
        what = "a tensor map could not be encoded" if err == ERR_TENSOR_MAP else f"CUDA error {err}"
        raise RuntimeError(f"flash_attention launch failed on the {path!r} path: {what}")
    launches += 1
    return out
