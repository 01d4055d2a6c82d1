"""Dispatching wrapper of the intersect_count kernel.

``intersect_count`` launches the hand-written CUDA kernel
(``src/repro_torch/csrc/intersect_count.cu``, built and loaded through
:mod:`repro_torch.kernels.build`) for CUDA tensors, and takes the plain
PyTorch version (:mod:`.ref`) for tensors on the CPU; there is no other
route and no fallback.  What the kernel cannot take (dtype, contiguity,
shape, device) raises.

Unlike the Pallas wrapper it replaces, nothing is padded: the kernel walks
the ragged batch edge itself, and a batch of zero rows launches nothing.

``launches`` counts kernel launches in this process (one per call that
reached the card); comparisons that call the plain version do not count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.intersect_count.ref import intersect_count_ref

__all__ = ["intersect_count", "launches", "MAX_TILE_SUM"]

launches = 0
# the kernel stages both tiles of a row in <= 48 KB of shared memory
MAX_TILE_SUM = 6144

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("intersect_count").intersect_count_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(a_ids, a_t, b_ids, b_t, a_lo, a_hi, b_lo, b_hi):
    args = (a_ids, a_t, b_ids, b_t, a_lo, a_hi, b_lo, b_hi)
    for x in args:
        if not isinstance(x, torch.Tensor):
            raise TypeError("intersect_count takes torch tensors")
        if x.dtype != torch.int32:
            raise TypeError(f"intersect_count takes int32 tensors, got {x.dtype}")
        if x.device != a_ids.device:
            raise ValueError("intersect_count inputs must share one device")
    if a_ids.dim() != 2 or b_ids.dim() != 2:
        raise ValueError("a_ids/b_ids must be (B, Da) / (B, Db)")
    b, da = a_ids.shape
    db = b_ids.shape[1]
    if a_t.shape != a_ids.shape or b_t.shape != b_ids.shape or b_ids.shape[0] != b:
        raise ValueError("tile shapes disagree")
    for x in (a_lo, a_hi, b_lo, b_hi):
        if x.shape != (b,):
            raise ValueError(f"window bounds must be ({b},), got {tuple(x.shape)}")
    return b, da, db


def intersect_count(
    a_ids, a_t, b_ids, b_t, a_lo, a_hi, b_lo, b_hi, *, ordered: bool = False
):
    """Per row, # pairs (i, j) with a_ids[i] == b_ids[j] >= 0, both
    windows holding (lo < t <= hi) and, if ``ordered``, b_t[j] > a_t[i].
    int32 (B,) in, int32 (B,) out."""
    global launches
    b, da, db = _check(a_ids, a_t, b_ids, b_t, a_lo, a_hi, b_lo, b_hi)
    if a_ids.device.type == "cpu":
        return intersect_count_ref(
            a_ids, a_t, b_ids, b_t, a_lo, a_hi, b_lo, b_hi, ordered=ordered
        )
    if a_ids.device.type != "cuda":
        raise ValueError(f"intersect_count runs on cuda or cpu, not {a_ids.device}")
    args = (a_ids, a_t, b_ids, b_t, a_lo, a_hi, b_lo, b_hi)
    if not all(x.is_contiguous() for x in args):
        raise ValueError("intersect_count takes contiguous tensors")
    if da < 1 or db < 1 or da + db > MAX_TILE_SUM:
        raise ValueError(f"tile widths Da={da}, Db={db} outside 1..{MAX_TILE_SUM} in sum")
    out = torch.empty(b, dtype=torch.int32, device=a_ids.device)
    if b == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(a_ids.device):
        stream = torch.cuda.current_stream(a_ids.device).cuda_stream
        err = fn(
            *(x.data_ptr() for x in args),
            out.data_ptr(),
            b,
            da,
            db,
            int(bool(ordered)),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"intersect_count launch failed: CUDA error {err}")
    launches += 1
    return out
