"""The lead operands and CSRs of the step entries, shared by the wrappers
of ``window_search`` and ``intersect_count``.

A step launch reads each lead operand (a node, a window bound, a skip
node) in place through its strides over the broadcast lead shape, or by
value where it is a Python int; the ``.cu`` files lay both out alike
(``WsOperand`` / ``IcOperand``, ``WsCsr`` / ``IcCsr``).  This module holds
those layouts, their checks, and the shape and stride work that turns a
call's operands into a launch's iteration space (:func:`describe`), in
plain Python: ``torch.broadcast_shapes``'s symbolic guards cost more host
time than a small launch.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

__all__ = ["MAX_RANK", "MAX_SKIP", "I32_MIN", "I32_MAX", "Strides", "Operand", "Csr", "describe", "broadcast",
           "strides_over", "shape_of", "operand", "csr", "check_flat", "check_operand", "check_csr"]

MAX_RANK = 8  # WS_MAX_RANK / IC_MAX_RANK of the .cu files: axes of a launch after describe()
MAX_SKIP = 8  # WS_MAX_SKIP / IC_MAX_SKIP: skip operands of a step
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
_I32 = torch.int32
Strides = ctypes.c_longlong * MAX_RANK


class Operand(ctypes.Structure):
    """A tensor read at ``ptr + sum(coord[d] * stride[d])``, or (``ptr``
    NULL) the int ``value`` everywhere."""

    _fields_ = [("ptr", ctypes.c_void_p), ("stride", Strides), ("value", ctypes.c_int), ("pad_", ctypes.c_int)]


class Csr(ctypes.Structure):
    """One CSR's flat (id, t)-sorted rows and its indptr."""

    _fields_ = [
        ("ids", ctypes.c_void_p),
        ("t", ctypes.c_void_p),
        ("indptr", ctypes.c_void_p),
        ("n_flat", ctypes.c_longlong),
        ("n_indptr", ctypes.c_longlong),
    ]


def describe(
    shape: Sequence[int], strides: Sequence[Sequence[int]]
) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]:
    """The iteration space of a launch, a pure function of shapes.

    ``shape`` is the broadcast output shape; ``strides`` holds each
    operand's strides over it (0 on the axes it is broadcast along; all 0
    for a Python int).  Returns ``(sizes, strides)`` with the size-1 axes
    dropped and each pair of neighbouring axes merged where every operand
    walks them as one (outer stride == inner stride * inner size).  Element
    ``i`` of the output, in C order, is read at ``sum(c[d] * strides[k][d])``
    for the coordinates ``c`` of ``i`` over ``sizes``."""
    keep = [d for d, n in enumerate(shape) if n != 1]
    sizes: list = []
    out: list = [[] for _ in strides]
    for d in keep:
        n = int(shape[d])
        if sizes and all(st[-1] == s[d] * n for st, s in zip(out, strides)):
            sizes[-1] *= n
            for st, s in zip(out, strides):
                st[-1] = int(s[d])
        else:
            sizes.append(n)
            for st, s in zip(out, strides):
                st.append(int(s[d]))
    return tuple(sizes), tuple(tuple(st) for st in out)


def shape_of(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def broadcast(shapes) -> Tuple[int, ...]:
    """``torch.broadcast_shapes`` of tuples of ints, without its symbolic
    shape guards, which cost more host time than a small launch."""
    rank = max(map(len, shapes), default=0)
    out = [1] * rank
    for sh in shapes:
        for d, n in enumerate(sh, rank - len(sh)):
            if n != 1:
                if out[d] not in (1, n):
                    raise ValueError(f"operand shapes {list(shapes)} do not broadcast")
                out[d] = n
    return tuple(out)


def strides_over(x, shape) -> Tuple[int, ...]:
    """x's strides over the broadcast ``shape``: 0 along the axes it is
    broadcast along (and, as describe() drops them, along size-1 axes)."""
    if not isinstance(x, torch.Tensor):
        return (0,) * len(shape)
    return (0,) * (len(shape) - x.dim()) + tuple(st if n != 1 else 0 for n, st in zip(x.shape, x.stride()))


def operand(x, strides) -> Operand:
    if type(x) is int:
        return Operand(None, Strides(), x, 0)
    return Operand(x.data_ptr(), Strides(*strides), 0, 0)


def csr(c) -> Csr:
    indptr, ids, t = c
    return Csr(ids.data_ptr(), t.data_ptr(), indptr.data_ptr(), ids.shape[0], indptr.shape[0])


def check_flat(name: str, x, device, who: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{who}: {name} must be a torch tensor")
    if x.dtype is not _I32 or x.dim() != 1 or not x.is_contiguous():
        raise TypeError(f"{who}: {name} must be a contiguous 1-D int32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{who}: {name} is on {x.device}, not {device}")


def check_operand(name: str, x, device, who: str) -> None:
    if type(x) is int:
        if not I32_MIN <= x <= I32_MAX:
            raise TypeError(f"{who}: {name} = {x} is outside int32")
        return
    if not isinstance(x, torch.Tensor) or x.dtype is not _I32:
        raise TypeError(f"{who}: {name} must be an int in int32 or an int32 tensor, got {x!r:.80}")
    if x.device != device:
        raise ValueError(f"{who}: {name} is on {x.device}, not {device}")


def check_csr(name: str, c, device, who: str) -> None:
    if not isinstance(c, tuple) or len(c) != 3:
        raise TypeError(f"{who}: {name} must be an (indptr, ids, t) tuple")
    indptr, ids, t = c
    for part, x in (("indptr", indptr), ("ids", ids), ("t", t)):
        check_flat(f"{name}'s {part}", x, device, who)
    if ids.shape[0] == 0 or indptr.shape[0] == 0 or ids.shape[0] != t.shape[0]:
        raise ValueError(f"{who}: {name} has empty flat arrays, or ids and t of different lengths")
