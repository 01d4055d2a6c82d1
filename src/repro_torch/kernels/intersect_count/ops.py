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

The second entry, :func:`pair_step`, runs a whole pairwise (``pw``) step
of the compiled plans in one launch: both sides' expansions with their
masks, the compare cube, its sum and the two sides' sweep offsets, in the
operand forms the compiler holds (lead-shaped views read through their
strides, ints by value); its plain version is :func:`.ref.pair_step_ref`.

``launches`` counts kernel launches in this process (one per call that
reached the card) of both entries, ``step_launches`` those of
:func:`pair_step` alone; comparisons that call the plain version do not
count.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.intersect_count import ref
from repro_torch.kernels.intersect_count.ref import FORMS, intersect_count_ref
from repro_torch.kernels.operands import (
    I32_MAX,
    I32_MIN,
    MAX_RANK,
    MAX_SKIP,
    Csr,
    Operand,
    Strides,
    broadcast,
    check_csr,
    check_operand,
    csr,
    describe,
    operand,
    shape_of,
    strides_over,
)

__all__ = ["intersect_count", "pair_step", "plan", "kernel_plan", "step_plan", "launches", "step_launches",
           "MAX_TILE_SUM", "PATHS", "FORMS"]

launches = 0
step_launches = 0
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


# ---- the pw step entry --------------------------------------------------------

STEP_THREADS = 256  # kStepThreads of the .cu
STEP_SMEM = 47 * 1024  # kStepSmem of the .cu: the dynamic shared memory a step launch may take


class _StepArgs(ctypes.Structure):
    _fields_ = [
        ("a", Csr),
        ("b", Csr),
        ("node_a", Operand),
        ("node_b", Operand),
        ("lo_a", Operand),
        ("hi_a", Operand),
        ("lo_b", Operand),
        ("hi_b", Operand),
        ("skip", Operand * MAX_SKIP),
        ("out", ctypes.c_void_p),
        ("size", Strides),
        ("numel", ctypes.c_longlong),
        ("run", ctypes.c_longlong),
        ("rank", ctypes.c_int),
        ("n_skip", ctypes.c_int),
        ("ordered", ctypes.c_int),
        ("edges", ctypes.c_int),
        ("b_at_stage", ctypes.c_int),
        ("offset_a", ctypes.c_int),
        ("width_a", ctypes.c_int),
        ("offset_b", ctypes.c_int),
        ("width_b", ctypes.c_int),
        ("group", ctypes.c_int),
        ("group_a", ctypes.c_int),
        ("chunk", ctypes.c_int),
        ("max_slices", ctypes.c_int),
    ]


_step_fn = None


def _step_launcher():
    global _step_fn
    if _step_fn is None:
        lib = build.load("intersect_count")
        for name in ("intersect_count_step_args_bytes", "intersect_count_max_rank", "intersect_count_max_skip",
                     "intersect_count_step_smem_max"):
            getattr(lib, name).restype = ctypes.c_int
        if (lib.intersect_count_step_args_bytes() != ctypes.sizeof(_StepArgs)
                or lib.intersect_count_max_rank() != MAX_RANK or lib.intersect_count_max_skip() != MAX_SKIP
                or lib.intersect_count_step_smem_max() != STEP_SMEM):
            raise RuntimeError("intersect_count: the .cu's step argument layout differs from the wrapper's")
        fn = lib.intersect_count_step_launch
        fn.argtypes = [ctypes.POINTER(_StepArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _step_fn = fn
    return _step_fn


def step_plan(width_a: int, width_b: int, run: int):
    """How a step launch splits its work: ``(group, group_a, chunk,
    max_slices)``.  A lead element gets ``group`` lanes (a power of two up
    to 32, each lane at least 8 of its width_a * width_b pairs), of them
    ``group_a`` over its a entries and the rest over the staged b entries;
    a block of STEP_THREADS takes ``STEP_THREADS // group`` consecutive lead
    elements, which span at most ``max_slices`` runs of ``run`` elements
    that share the fixed node, and stages each run's b row ``chunk``
    entries at a time, all slices within STEP_SMEM (8 bytes an entry, 24 a
    slice).  A pure function of the widths and the run."""
    pairs = width_a * width_b
    group = 1
    while group < 32 and 16 * group <= pairs:
        group *= 2
    group_a = 1
    while group_a < group and group_a < width_a:
        group_a *= 2
    rows = STEP_THREADS // group
    max_slices = min(rows, (rows + run - 2) // run + 1)
    chunk = max(1, min(width_b, (STEP_SMEM // max_slices - 24) // 8))
    return group, group_a, chunk, max_slices


def pair_step(
    form: str,
    csr_a,
    csr_b,
    frontier,
    fixed,
    window1,
    window2,
    skip=(),
    *,
    ordered: bool,
    d_a: int = 1,
    d_b: int,
    offset_a: int = 0,
    offset_b: int = 0,
    n_sweep_a: int = 1,
    n_sweep_b: int = 1,
):
    """One pairwise step of the compiled plans, summed over both sides'
    sweep offsets: ``offset_a + i * d_a`` (``i < n_sweep_a``) on the
    frontier side and ``offset_b + j * d_b`` (``j < n_sweep_b``) on the
    fixed side.

    ``form="intersect"``: ``csr_a`` / ``csr_b`` are the frontier side's and
    the fixed side's CSR as ``(indptr, ids, t)``, rows sorted by (id, t).
    ``frontier`` (the frontier node of each lead element), ``fixed`` (the
    fixed seed endpoint), the bounds of ``window1`` = (after, until) (the
    frontier side's edge times) and ``window2`` (the fixed side's) and each
    ``skip`` node are ints or int32 tensors that broadcast to the lead
    shape ``(B, W1, ..., Wk)``, read in place.  Both rows are expanded; an
    entry is kept where it lies inside its row and its time inside its
    side's window, a frontier entry also where its id differs from every
    skip node.  Counts the kept pairs with equal ids (and, ``ordered``, the
    fixed entry's time after the frontier entry's).

    ``form="edges"`` (the pairwise ``count_edges``): ``csr_a`` and
    ``window1`` are None, ``d_a`` and ``n_sweep_a`` 1, no skip nodes, not
    ordered; ``frontier`` holds the frontier ids themselves, each counted
    against the kept entries of the fixed row.

    Returns the int32 counts of the lead shape: the compiler's eager
    sequence (:func:`.ref.pair_step_ref`) bit for bit, one launch for CUDA
    tensors and the plain version for tensors on the CPU."""
    global launches, step_launches
    if form not in FORMS:
        raise ValueError(f"pair_step: form must be one of {FORMS}, not {form!r}")
    if not isinstance(csr_b, tuple) or not csr_b or not isinstance(csr_b[0], torch.Tensor):
        raise TypeError("pair_step: csr_b must be an (indptr, ids, t) tuple of tensors")
    dev = csr_b[0].device
    edges = form == "edges"
    check_csr("csr_b", csr_b, dev, "pair_step")
    skip = tuple(skip)
    if edges:
        if csr_a is not None or window1 is not None or skip or ordered or d_a != 1 or n_sweep_a != 1 or offset_a:
            raise ValueError("pair_step: the edges form takes no csr_a, window1 or skip nodes, d_a = n_sweep_a = 1, "
                             "offset_a = 0, and is not ordered")
        window1 = (I32_MIN, I32_MAX)
    else:
        check_csr("csr_a", csr_a, dev, "pair_step")
    if len(skip) > MAX_SKIP:
        raise ValueError(f"pair_step: {len(skip)} skip nodes; the kernel takes {MAX_SKIP}")
    (a1, u1), (a2, u2) = window1, window2
    operands = {"frontier": frontier, "fixed": fixed, "window1 after": a1, "window1 until": u1,
                "window2 after": a2, "window2 until": u2, **{f"skip {i}": r for i, r in enumerate(skip)}}
    for name, v in operands.items():
        check_operand(name, v, dev, "pair_step")
    for name, v, least in (("d_a", d_a, 1), ("d_b", d_b, 1), ("n_sweep_a", n_sweep_a, 1),
                           ("n_sweep_b", n_sweep_b, 1), ("offset_a", offset_a, 0), ("offset_b", offset_b, 0)):
        if type(v) is not int or v < least:
            raise TypeError(f"pair_step: {name} must be an int >= {least}, got {v!r}")
    if offset_a + d_a * n_sweep_a > I32_MAX or offset_b + d_b * n_sweep_b > I32_MAX:
        raise ValueError("pair_step: the sweep steps pass int32")
    kw = dict(ordered=ordered, d_a=d_a, d_b=d_b, offset_a=offset_a, offset_b=offset_b, n_sweep_a=n_sweep_a,
              n_sweep_b=n_sweep_b)
    if dev.type == "cpu":
        return ref.pair_step_ref(form, csr_a, csr_b, frontier, fixed, None if edges else window1, window2, skip,
                                 **kw)
    if dev.type != "cuda":
        raise ValueError(f"pair_step runs on cuda or cpu, not {dev}")
    shape = broadcast([shape_of(v) for v in operands.values()])
    out = torch.empty(shape, dtype=_I32, device=dev)
    if out.numel() == 0:
        return out
    order = list(operands.values())
    full = [strides_over(v, shape) for v in order]
    # the run: the trailing axes along which the fixed node does not vary;
    # window 2 is applied at staging where it does not vary along them either
    run, axis = 1, len(shape)
    while axis > 0 and (shape[axis - 1] == 1 or full[1][axis - 1] == 0):
        axis -= 1
        run *= shape[axis]
    b_at_stage = all(shape[d] == 1 or full[k][d] == 0 for k in (4, 5) for d in range(axis, len(shape)))
    sizes, merged = describe(shape, full)
    if len(sizes) > MAX_RANK:
        raise ValueError(f"pair_step: a lead shape of {len(sizes)} axes past merging; the kernel takes {MAX_RANK}")
    ops_ = [operand(v, st) for v, st in zip(order, merged)]
    skips = ops_[6:] + [Operand(None, Strides(), 0, 0)] * (MAX_SKIP - len(skip))
    width_a, width_b = d_a * n_sweep_a, d_b * n_sweep_b
    group, group_a, chunk, max_slices = step_plan(width_a, width_b, run)
    args = _StepArgs(
        Csr() if edges else csr(csr_a), csr(csr_b), *ops_[:6], (Operand * MAX_SKIP)(*skips), out.data_ptr(),
        Strides(*sizes), out.numel(), run, len(sizes), len(skip), 1 if ordered else 0, 1 if edges else 0,
        1 if b_at_stage else 0, offset_a, width_a, offset_b, width_b, group, group_a, chunk, max_slices,
    )
    fn = _step_launcher()
    cur = torch.cuda.current_device()
    d = cur if dev.index is None else dev.index
    if d == cur:  # no device switch on the common path: it costs host time a launch
        err = fn(ctypes.byref(args), torch._C._cuda_getCurrentRawStream(d))
    else:
        with torch.cuda.device(d):
            err = fn(ctypes.byref(args), torch._C._cuda_getCurrentRawStream(d))
    if err != 0:
        raise RuntimeError(f"intersect_count pair_step launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
        step_launches += 1
    return out

