"""Dispatching wrapper of the window_degree kernel.

``window_degree`` launches the hand-written CUDA kernel
(``src/repro_torch/csrc/window_degree.cu``, built and loaded through
:mod:`repro_torch.kernels.build`) for CUDA tensors, and takes the plain
PyTorch version (:mod:`.ref`) for tensors on the CPU; there is no other
route and no fallback.  What the kernel cannot take (dtype, contiguity,
shape, device) raises.

A standalone op, as in the JAX package: no mining path calls it (the
compiler's windowed degree, ``core.ops.count_window``, is a binary search
on CSR rows).  Nothing is padded, and zero rows launch nothing.

``launches`` counts kernel launches in this process (one per call that
reached the card); comparisons that call the plain version do not count.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.window_degree.ref import window_degree_ref

__all__ = ["window_degree", "PAD_T", "launches"]

# padding slots of a time tile; fails t > lo for every int32 window
PAD_T = -(2**31)

launches = 0
# the sharded executor's dispatch threads launch concurrently: the
# read-modify-write of a count is guarded
_count_lock = threading.Lock()

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("window_degree").window_degree_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def window_degree(t, lo, hi):
    """t (B, D) int32 padded with PAD_T; lo/hi (B,) int32 -> (B,) int32:
    per row, the entries with lo < t <= hi."""
    global launches
    for x in (t, lo, hi):
        if not isinstance(x, torch.Tensor):
            raise TypeError("window_degree takes torch tensors")
        if x.dtype != torch.int32:
            raise TypeError(f"window_degree takes int32 tensors, got {x.dtype}")
        if x.device != t.device:
            raise ValueError("window_degree inputs must share one device")
    if t.dim() != 2:
        raise ValueError(f"t must be (B, D), got {tuple(t.shape)}")
    b, d = t.shape
    if lo.shape != (b,) or hi.shape != (b,):
        raise ValueError(f"lo/hi must be ({b},)")
    if t.device.type == "cpu":
        return window_degree_ref(t, lo, hi)
    if t.device.type != "cuda":
        raise ValueError(f"window_degree runs on cuda or cpu, not {t.device}")
    if not all(x.is_contiguous() for x in (t, lo, hi)):
        raise ValueError("window_degree takes contiguous tensors")
    out = torch.empty(b, dtype=torch.int32, device=t.device)
    if b == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(t.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), b, d, stream)
    if err != 0:
        raise RuntimeError(f"window_degree launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out
