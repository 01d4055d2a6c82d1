"""Dispatching wrapper of the intersect_count kernel.

``intersect_count`` launches the hand-written CUDA kernel
(``src/repro_torch/csrc/intersect_count.cu``, built and loaded through
:mod:`repro_torch.kernels.build`) for CUDA tensors, and takes the plain
PyTorch version (:mod:`.ref`) for tensors on the CPU; there is no other
route and no fallback.  What the kernel cannot take (dtype, contiguity,
shape, device) raises.

Beyond the Pallas wrapper's operands, it takes the forms in which the
mining compiler holds them, so that nothing is copied per query row:

- ``b_ids`` / ``b_t`` may have ``B_fixed`` rows where ``B`` (the rows of
  ``a_ids``) is a multiple of ``B_fixed``: row r reads fixed row
  ``r // (B // B_fixed)``, the C-order flattening of a query shape
  ``(B_fixed, W1, ..., Wk)``;
- a window bound may be a Python int (passed by value), a ``(B,)`` tensor
  or a ``(B_fixed,)`` tensor read at the fixed side's rate;
- ``a_t`` may be ``None`` when ``ordered`` is false and the a window is
  ``(INT32_MIN, INT32_MAX]``: every a slot then passes its window.

On the CPU these forms are expanded and the plain version runs on the
materialised operands.  Nothing is padded: the kernel walks the ragged
batch edge itself, and a batch of zero rows launches nothing.

Each call is one launch, on the path :func:`plan` names (the ``.cu``
entry makes the same choice; :func:`kernel_plan` asks it): ``"rows"`` for
narrow tiles (persistent blocks walk tiles of consecutive rows, a lane
group a row) and ``"block"`` for wide ones (a block a row, the fixed
row's keys staged once in shared memory).

``launches`` counts kernel launches in this process (one per call that
reached the card); comparisons that call the plain version do not count.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.intersect_count.ref import intersect_count_ref

__all__ = ["intersect_count", "plan", "kernel_plan", "launches", "MAX_TILE_SUM", "PATHS"]

launches = 0
# the sharded executor's dispatch threads launch concurrently: the
# read-modify-write of a count is guarded
_count_lock = threading.Lock()
# the widest tiles the kernel takes: the block path stages a fixed row's
# keys (8 bytes a slot, padded to a power of two) in shared memory
MAX_TILE_SUM = 6144
PATHS = ("rows", "block")  # in the order of the .cu entry's path codes
# as in csrc/intersect_count.cu: a row gets a block from CROSS_PAIRS pairs
# on, or where one row's operands (8 * (Da + Db) + 16 bytes) pass
# TILE_BYTES, the rows path's budget of operands for a tile
CROSS_PAIRS = 4096
TILE_BYTES = 32 * 1024
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
_I32 = torch.int32

_fn = None


def plan(b: int, da: int, db: int) -> str:
    """The path a CUDA launch at (B, Da, Db) takes: ``"block"`` when a row
    has at least ``CROSS_PAIRS`` pairs or its operands (8 * (Da + Db) + 16
    bytes) pass a rows-path tile's budget, else ``"rows"``.  A pure function
    of the shape; the forms of the operands do not change the choice."""
    if da * db >= CROSS_PAIRS or 8 * (da + db) + 16 > TILE_BYTES:
        return "block"
    return "rows"


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load("intersect_count")
        fn = lib.intersect_count_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.intersect_count_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.intersect_count_plan.restype = ctypes.c_int
        _fn = fn
    return _fn


def kernel_plan(b: int, da: int, db: int) -> str:
    """The path the built ``.cu`` entry picks for this shape (needs the
    library, so the card's toolkit): it must equal :func:`plan`."""
    _launcher()
    return PATHS[build.load("intersect_count").intersect_count_plan(b, da, db)]


def _check(a_ids, a_t, b_ids, b_t, bounds, ordered):
    """Raise on what neither version takes; return (B, Da, B_fixed, Db).
    Written for speed: the mining path calls it 773 times a mine."""
    if not all(isinstance(x, torch.Tensor) for x in (a_ids, b_ids, b_t)) or not (
            a_t is None or isinstance(a_t, torch.Tensor)):
        raise TypeError("intersect_count takes torch tensors")
    cuda, dev = a_ids.is_cuda, a_ids.get_device()
    for x in (a_ids, a_t, b_ids, b_t) + bounds:
        if x is None or type(x) is int:
            continue
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"window bounds must be int32 tensors or ints in int32, got {x!r}")
        if x.dtype is not _I32:
            raise TypeError(f"intersect_count takes int32 tensors, got {x.dtype}")
        if x.is_cuda is not cuda or x.get_device() != dev:
            raise ValueError("intersect_count inputs must share one device")
    if a_ids.dim() != 2 or b_ids.dim() != 2:
        raise ValueError("a_ids/b_ids must be (B, Da) / (B_fixed, Db)")
    b, da = a_ids.shape
    bf, db = b_ids.shape
    if b_t.shape != b_ids.shape or (a_t is not None and a_t.shape != a_ids.shape):
        raise ValueError("tile shapes disagree")
    if (b % bf if bf else b):
        raise ValueError(f"a_ids has {b} rows, not a multiple of the fixed side's {bf}")
    for w in bounds:
        if type(w) is int:
            if not I32_MIN <= w <= I32_MAX:
                raise TypeError(f"window bounds must be int32 tensors or ints in int32, got {w!r}")
        elif w.dim() != 1 or w.shape[0] not in (b, bf):
            raise ValueError(f"window bounds must be ints, ({b},) or ({bf},), got {tuple(w.shape)}")
    if a_t is None and (ordered or type(bounds[0]) is not int or type(bounds[1]) is not int
                        or bounds[0] != I32_MIN or bounds[1] != I32_MAX):
        raise ValueError("a_t may be None only unordered, with the a window (INT32_MIN, INT32_MAX]")
    return b, da, bf, db


def _expanded(a_ids, a_t, b_ids, b_t, bounds, b, bf):
    """The broadcast forms materialised: the plain version's operands."""
    rep = b // bf if bf else 1

    def rows(w):
        if not isinstance(w, torch.Tensor):
            return torch.full((b,), w, dtype=torch.int32, device=a_ids.device)
        return w if w.shape[0] == b else w.repeat_interleave(rep)

    return (a_ids, torch.zeros_like(a_ids) if a_t is None else a_t,
            b_ids.repeat_interleave(rep, 0) if rep > 1 else b_ids,
            b_t.repeat_interleave(rep, 0) if rep > 1 else b_t, *map(rows, bounds))


def intersect_count(
    a_ids, a_t, b_ids, b_t, a_lo, a_hi, b_lo, b_hi, *, ordered: bool = False
):
    """Per row, # pairs (i, j) with a_ids[i] == b_ids[j] >= 0, both
    windows holding (lo < t <= hi) and, if ``ordered``, b_t[j] > a_t[i].
    int32 in, int32 (B,) out; the fixed side, the windows and ``a_t`` may
    take the broadcast forms of the module docstring."""
    global launches
    bounds = (a_lo, a_hi, b_lo, b_hi)
    b, da, bf, db = _check(a_ids, a_t, b_ids, b_t, bounds, ordered)
    if not a_ids.is_cuda:
        if a_ids.device.type != "cpu":
            raise ValueError(f"intersect_count runs on cuda or cpu, not {a_ids.device}")
        return intersect_count_ref(*_expanded(a_ids, a_t, b_ids, b_t, bounds, b, bf), ordered=ordered)
    ptrs, scalars, fixed = [], [], 0
    for k, w in enumerate(bounds):
        if type(w) is int:
            ptrs.append(None)
            scalars.append(w)
        else:
            if not w.is_contiguous():
                raise ValueError("intersect_count takes contiguous tensors")
            ptrs.append(w.data_ptr())
            scalars.append(0)
            if w.shape[0] != b:
                fixed |= 1 << k
    if not (a_ids.is_contiguous() and b_ids.is_contiguous() and b_t.is_contiguous()
            and (a_t is None or a_t.is_contiguous())):
        raise ValueError("intersect_count takes contiguous tensors")
    if da < 1 or db < 1 or da + db > MAX_TILE_SUM:
        raise ValueError(f"tile widths Da={da}, Db={db} outside 1..{MAX_TILE_SUM} in sum")
    out = torch.empty(b, dtype=_I32, device=a_ids.device)
    if b == 0:
        return out
    fn = _launcher()
    args = (a_ids.data_ptr(), None if a_t is None else a_t.data_ptr(), b_ids.data_ptr(), b_t.data_ptr(),
            *ptrs, *scalars, fixed, out.data_ptr(), b, b // bf, da, db, 1 if ordered else 0)
    # the raw handle of the current stream, without building a Stream object
    dev = a_ids.get_device()
    if dev == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"intersect_count launch failed on the {plan(b, da, db)!r} path: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out
