"""Dispatching wrapper of the window_search kernel.

The four windowed searches of :mod:`repro_torch.core.ops`, with the same
signatures: ``count_window`` and ``count_window_pos`` (one level: the
window ranked on the time-sorted row copy) and ``count_id_in_window`` and
``count_id_in_window_pos`` (two levels: the id run in the id-sorted row,
then the window inside it); the ``_pos`` forms also return the flat rank
of the first element in the window.  And ``intersect_step``: a whole bs1
or bs2 intersect step of the compiled plans, the expansion of one side,
its window and ``skip_eq`` masks, the ordered clip, the two-level search
of each kept entry in the other side's row and the sum, with the intersect
dim's sweep offsets looped inside.  For CUDA tensors each call is one
launch of the hand-written kernel (``src/repro_torch/csrc/window_search.cu``,
built and loaded through :mod:`repro_torch.kernels.build`); for tensors on
the CPU it is the plain version (:mod:`.ref`: the eager searches of
``core.ops``, and the compiler's eager intersect sequence); there is no
other route and no fallback.  What neither takes (dtype, rank, device)
raises.

The query operands ``node``, ``x``, ``after`` and ``until`` are taken in
the forms the mining compiler holds them: a Python int (passed by value)
or an int32 tensor that broadcasts to the query shape, a lifted or
broadcast view included.  The kernel reads each through its strides over
the output shape (:func:`describe`), so nothing is copied per element.
The outputs are int32 tensors of the plain version's shapes: the count of
the broadcast shape of every operand, the position of the broadcast shape
of ``node``, ``x`` and ``after``.  Nothing is padded, and an empty query
launches nothing.

The kernel launches on the current stream, allocates nothing beyond the
outputs and makes no host sync.

``launches`` counts kernel launches in this process (one per call that
reached the card), of both entries; ``step_launches`` those of
``intersect_step`` alone.  Comparisons that call the plain version do not
count.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.window_search import ref

__all__ = [
    "count_window",
    "count_window_pos",
    "count_id_in_window",
    "count_id_in_window_pos",
    "intersect_step",
    "describe",
    "launches",
    "step_launches",
    "MAX_RANK",
    "MAX_SKIP",
]

launches = 0
step_launches = 0
# the sharded executor's dispatch threads launch concurrently: the
# read-modify-write of a count is guarded
_count_lock = threading.Lock()
MAX_RANK = 8  # WS_MAX_RANK of the .cu: axes of a launch after describe()
MAX_SKIP = 8  # WS_MAX_SKIP of the .cu: skip operands of an intersect step
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
_I32 = torch.int32
_Strides = ctypes.c_longlong * MAX_RANK


class _Operand(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("stride", _Strides), ("value", ctypes.c_int), ("pad_", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = [
        ("ids", ctypes.c_void_p),
        ("t", ctypes.c_void_p),
        ("n_flat", ctypes.c_longlong),
        ("indptr", ctypes.c_void_p),
        ("n_indptr", ctypes.c_longlong),
        ("node", _Operand),
        ("x", _Operand),
        ("after", _Operand),
        ("until", _Operand),
        ("out", ctypes.c_void_p),
        ("pos", ctypes.c_void_p),
        ("pos_stride", _Strides),
        ("size", _Strides),
        ("numel", ctypes.c_longlong),
        ("rank", ctypes.c_int),
        ("n_iters", ctypes.c_int),
        ("two_level", ctypes.c_int),
        ("pad_", ctypes.c_int),
    ]


class _Csr(ctypes.Structure):
    _fields_ = [
        ("ids", ctypes.c_void_p),
        ("t", ctypes.c_void_p),
        ("indptr", ctypes.c_void_p),
        ("n_flat", ctypes.c_longlong),
        ("n_indptr", ctypes.c_longlong),
    ]


class _StepArgs(ctypes.Structure):
    _fields_ = [
        ("x", _Csr),
        ("s", _Csr),
        ("node_x", _Operand),
        ("node_s", _Operand),
        ("lo_x", _Operand),
        ("hi_x", _Operand),
        ("lo_s", _Operand),
        ("hi_s", _Operand),
        ("skip", _Operand * MAX_SKIP),
        ("out", ctypes.c_void_p),
        ("size", _Strides),
        ("numel", ctypes.c_longlong),
        ("offset", ctypes.c_int),
        ("width", ctypes.c_int),
        ("rank", ctypes.c_int),
        ("n_iters", ctypes.c_int),
        ("n_skip", ctypes.c_int),
        ("ordered", ctypes.c_int),
        ("clip_upper", ctypes.c_int),
        ("group", ctypes.c_int),
    ]


_fns = None


def _launcher(step: bool = False):
    """The .cu's launch function of one entry (``step``: intersect_step)."""
    global _fns
    if _fns is None:
        lib = build.load("window_search")
        for name in ("window_search_args_bytes", "window_search_step_args_bytes", "window_search_max_rank",
                     "window_search_max_skip"):
            getattr(lib, name).restype = ctypes.c_int
        if (lib.window_search_args_bytes() != ctypes.sizeof(_Args)
                or lib.window_search_step_args_bytes() != ctypes.sizeof(_StepArgs)
                or lib.window_search_max_rank() != MAX_RANK or lib.window_search_max_skip() != MAX_SKIP):
            raise RuntimeError("window_search: the .cu's argument layout differs from the wrapper's")
        fns = []
        for name, args in (("window_search_launch", _Args), ("window_search_step_launch", _StepArgs)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns.append(fn)
        _fns = tuple(fns)
    return _fns[1 if step else 0]


def _launch(fn, args, dev, what: str) -> None:
    """Launch on ``dev``'s current stream; a refused launch raises."""
    d = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(d):
        err = fn(ctypes.byref(args), torch._C._cuda_getCurrentRawStream(d))
    if err != 0:
        raise RuntimeError(f"window_search {what} launch failed: CUDA error {err}")


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


def _check_flat(name: str, x, device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"window_search: {name} must be a torch tensor")
    if x.dtype is not _I32 or x.dim() != 1 or not x.is_contiguous():
        raise TypeError(f"window_search: {name} must be a contiguous 1-D int32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"window_search: {name} is on {x.device}, not {device}")


def _check_operand(name: str, x, device) -> None:
    if type(x) is int:
        if not I32_MIN <= x <= I32_MAX:
            raise TypeError(f"window_search: {name} = {x} is outside int32")
        return
    if not isinstance(x, torch.Tensor) or x.dtype is not _I32:
        raise TypeError(f"window_search: {name} must be an int in int32 or an int32 tensor, got {x!r:.80}")
    if x.device != device:
        raise ValueError(f"window_search: {name} is on {x.device}, not {device}")


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def _operand(x, strides) -> _Operand:
    if type(x) is int:
        return _Operand(None, _Strides(), x, 0)
    return _Operand(x.data_ptr(), _Strides(*strides), 0, 0)


def _search(ids, t, indptr, node, x, after, until, n_iters, want_pos: bool):
    """Check, then launch the kernel (CUDA) or run the plain version (CPU)."""
    global launches
    two = ids is not None
    if not isinstance(t, torch.Tensor):
        raise TypeError("window_search: t must be a torch tensor")
    dev = t.device
    if two:
        _check_flat("ids", ids, dev)
    _check_flat("t", t, dev)
    _check_flat("indptr", indptr, dev)
    operands = {"node": node, "after": after, "until": until}
    if two:
        operands["x"] = x
    for name, v in operands.items():
        _check_operand(name, v, dev)
    if type(n_iters) is not int or n_iters < 0:
        raise TypeError(f"window_search: n_iters must be an int >= 0, got {n_iters!r}")
    if t.shape[0] == 0 or indptr.shape[0] == 0 or (two and ids.shape[0] != t.shape[0]):
        raise ValueError("window_search: empty flat arrays, or ids and t of different lengths")
    if dev.type == "cpu":
        if two:
            fn = ref.count_id_in_window_pos_ref if want_pos else ref.count_id_in_window_ref
            return fn(ids, t, indptr, node, x, after, until, n_iters)
        fn = ref.count_window_pos_ref if want_pos else ref.count_window_ref
        return fn(t, indptr, node, after, until, n_iters)
    if dev.type != "cuda":
        raise ValueError(f"window_search runs on cuda or cpu, not {dev}")
    shape = torch.broadcast_shapes(*map(_shape, operands.values()))
    pos_shape = torch.broadcast_shapes(*map(_shape, (node, x if two else 0, after)))
    out = torch.empty(shape, dtype=_I32, device=dev)
    pos = torch.empty(pos_shape, dtype=_I32, device=dev) if want_pos else None
    if out.numel() == 0:
        return (out, pos) if want_pos else out
    order = [node, x if two else 0, after, until]
    strides = [v.expand(shape).stride() if isinstance(v, torch.Tensor) else (0,) * len(shape) for v in order]
    strides.append(pos.expand(shape).stride() if want_pos else (0,) * len(shape))
    sizes, merged = describe(shape, strides)
    if len(sizes) > MAX_RANK:
        raise ValueError(f"window_search: a query of {len(sizes)} axes past merging; the kernel takes {MAX_RANK}")
    ops_ = [_operand(v, st) for v, st in zip(order, merged)]
    args = _Args(
        ids.data_ptr() if two else None, t.data_ptr(), t.shape[0], indptr.data_ptr(), indptr.shape[0],
        *ops_, out.data_ptr(), pos.data_ptr() if want_pos else None, _Strides(*merged[-1]), _Strides(*sizes),
        out.numel(), len(sizes), n_iters, 1 if two else 0, 0,
    )
    _launch(_launcher(), args, dev, "search")
    with _count_lock:
        launches += 1
    return (out, pos) if want_pos else out


STRATEGIES = ("bs1", "bs2")


def _check_csr(name: str, csr, device) -> None:
    if not isinstance(csr, tuple) or len(csr) != 3:
        raise TypeError(f"window_search: {name} must be an (indptr, ids, t) tuple")
    indptr, ids, t = csr
    for part, x in (("indptr", indptr), ("ids", ids), ("t", t)):
        _check_flat(f"{name}'s {part}", x, device)
    if ids.shape[0] == 0 or indptr.shape[0] == 0 or ids.shape[0] != t.shape[0]:
        raise ValueError(f"window_search: {name} has empty flat arrays, or ids and t of different lengths")


def _csr(csr) -> _Csr:
    indptr, ids, t = csr
    return _Csr(ids.data_ptr(), t.data_ptr(), indptr.data_ptr(), ids.shape[0], indptr.shape[0])


def intersect_step(
    strategy: str,
    csr_a,
    csr_b,
    frontier,
    fixed,
    window1,
    window2,
    skip=(),
    *,
    ordered: bool,
    d: int,
    n_sweep: int = 1,
    offset: int = 0,
    n_iters: int,
):
    """One bs1 or bs2 intersect step of the compiled plans, summed over the
    intersect dim's sweep offsets ``offset + i * d``, ``i < n_sweep``.

    ``csr_a`` / ``csr_b`` are the frontier side's and the fixed side's CSR
    as ``(indptr, ids, t)``, rows sorted by (id, t).  ``frontier`` (the
    frontier node of each lead element), ``fixed`` (the fixed seed
    endpoint), the bounds of ``window1`` = (after, until) (the frontier
    side's edge times) and ``window2`` (the fixed side's) and each ``skip``
    node are ints or int32 tensors that broadcast to the lead shape
    ``(B, W1, ..., Wk)``, read in place.  bs1 expands the frontier row in
    ``csr_a`` and searches each kept entry's id in the fixed row of
    ``csr_b``; bs2 expands the fixed row and searches the frontier row.
    An entry is kept where its time lies in its side's window and its id
    differs from every skip node; ``ordered`` then clips the searched
    window to after the entry's time (bs1) or before it (bs2).  Returns the
    int32 counts of the lead shape: the compiler's eager sequence
    (:func:`.ref.intersect_step_ref`) bit for bit."""
    global launches, step_launches
    if strategy not in STRATEGIES:
        raise ValueError(f"window_search: strategy must be one of {STRATEGIES}, not {strategy!r}")
    if not isinstance(csr_a, tuple) or not csr_a or not isinstance(csr_a[0], torch.Tensor):
        raise TypeError("window_search: csr_a must be an (indptr, ids, t) tuple of tensors")
    dev = csr_a[0].device
    _check_csr("csr_a", csr_a, dev)
    _check_csr("csr_b", csr_b, dev)
    skip = tuple(skip)
    if len(skip) > MAX_SKIP:
        raise ValueError(f"window_search: {len(skip)} skip nodes; the kernel takes {MAX_SKIP}")
    (a1, u1), (a2, u2) = window1, window2
    operands = {"frontier": frontier, "fixed": fixed, "window1 after": a1, "window1 until": u1,
                "window2 after": a2, "window2 until": u2, **{f"skip {i}": r for i, r in enumerate(skip)}}
    for name, v in operands.items():
        _check_operand(name, v, dev)
    for name, v in (("d", d), ("n_sweep", n_sweep), ("n_iters", n_iters), ("offset", offset)):
        if type(v) is not int or v < (1 if name in ("d", "n_sweep") else 0):
            raise TypeError(f"window_search: {name} must be an int >= {1 if name in ('d', 'n_sweep') else 0}, "
                            f"got {v!r}")
    if offset + d * n_sweep > I32_MAX:
        raise ValueError(f"window_search: {n_sweep} sweep steps of {d} from {offset} pass int32")
    if dev.type == "cpu":
        return ref.intersect_step_ref(strategy, csr_a, csr_b, frontier, fixed, window1, window2, skip,
                                      ordered=ordered, d=d, n_sweep=n_sweep, offset=offset, n_iters=n_iters)
    if dev.type != "cuda":
        raise ValueError(f"window_search runs on cuda or cpu, not {dev}")
    shape = torch.broadcast_shapes(*map(_shape, operands.values()))
    out = torch.empty(shape, dtype=_I32, device=dev)
    if out.numel() == 0:
        return out
    bs1 = strategy == "bs1"
    # the expanded side (x) and the searched side (s)
    order = [frontier if bs1 else fixed, fixed if bs1 else frontier, *(window1 if bs1 else window2),
             *(window2 if bs1 else window1), *skip]
    strides = [v.expand(shape).stride() if isinstance(v, torch.Tensor) else (0,) * len(shape) for v in order]
    sizes, merged = describe(shape, strides)
    if len(sizes) > MAX_RANK:
        raise ValueError(f"window_search: a lead shape of {len(sizes)} axes past merging; the kernel takes {MAX_RANK}")
    ops_ = [_operand(v, st) for v, st in zip(order, merged)]
    skips = ops_[6:] + [_Operand(None, _Strides(), 0, 0)] * (MAX_SKIP - len(skip))
    width = d * n_sweep
    args = _StepArgs(
        _csr(csr_a if bs1 else csr_b), _csr(csr_b if bs1 else csr_a), *ops_[:6], (_Operand * MAX_SKIP)(*skips),
        out.data_ptr(), _Strides(*sizes), out.numel(), offset, width, len(sizes), n_iters, len(skip),
        1 if ordered else 0, 0 if bs1 else 1, step_group(width),
    )
    _launch(_launcher(step=True), args, dev, "intersect_step")
    with _count_lock:
        launches += 1
        step_launches += 1
    return out


def step_group(width: int) -> int:
    """Threads of a lead element in an intersect_step launch: a warp up to
    32 expansions, then 64, 128 or 256 (the .cu's `group`)."""
    return next((g for g in (32, 64, 128) if width <= g), 256)


def count_window(t_sorted_flat, indptr, node, after, until, n_iters: int):
    """Windowed degree of ``node`` on the time-sorted row copy: the
    entries of its row with after < t <= until; 0 where node < 0."""
    return _search(None, t_sorted_flat, indptr, node, None, after, until, n_iters, False)


def count_window_pos(t_sorted_flat, indptr, node, after, until, n_iters: int):
    """(count, flat rank of the first in-window entry) of :func:`count_window`."""
    return _search(None, t_sorted_flat, indptr, node, None, after, until, n_iters, True)


def count_id_in_window(nbr_flat, t_flat, indptr, node, x, after, until, n_iters: int):
    """Multiplicity of edges node -> x (id-sorted row) with after < t <=
    until; 0 where node < 0 or x < 0."""
    return _search(nbr_flat, t_flat, indptr, node, x, after, until, n_iters, False)


def count_id_in_window_pos(nbr_flat, t_flat, indptr, node, x, after, until, n_iters: int):
    """(count, flat rank of the first matched edge) of :func:`count_id_in_window`."""
    return _search(nbr_flat, t_flat, indptr, node, x, after, until, n_iters, True)
