"""Plain PyTorch version of the window_search kernel.

The four windowed searches are the eager searches of
:mod:`repro_torch.core.ops`, where they stay (``tests/test_torch_ops.py``
holds them to the JAX package's ``repro.core.ops``).  ``intersect_step_ref``
is the compiled plans' eager bs1 / bs2 intersect sequence
(``core/compiler.py``, the ``backend="torch"`` branches): ``ops.expand``
of one side, its window and ``skip_eq`` masks, the ordered clip, the
two-level search in the other side's row and the sum over the expansion,
looped over the intersect dim's sweep offsets.

The CPU tests run them, the wrapper takes them for tensors on the CPU, the
compiled and fused plans' ``"torch"`` backend calls the searches, and
``chip_smoke.py`` holds the CUDA kernel to them bit for bit on the card."""
from __future__ import annotations

import torch

from repro_torch.core import ops
from repro_torch.core.ops import count_id_in_window as count_id_in_window_ref
from repro_torch.core.ops import count_id_in_window_pos as count_id_in_window_pos_ref
from repro_torch.core.ops import count_window as count_window_ref
from repro_torch.core.ops import count_window_pos as count_window_pos_ref

__all__ = [
    "count_window_ref",
    "count_window_pos_ref",
    "count_id_in_window_ref",
    "count_id_in_window_pos_ref",
    "intersect_step_ref",
]


def _along(v):
    """A lead-shaped operand placed against the expansion axis."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def _max(a, b):
    return torch.maximum(a, b) if isinstance(a, torch.Tensor) else b.clamp_min(a)


def _min(a, b):
    return torch.minimum(a, b) if isinstance(a, torch.Tensor) else b.clamp_max(a)


def intersect_step_ref(
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
    """The eager bs1 / bs2 intersect step of the compiled plans over the
    sweep offsets ``offset + i * d``, ``i < n_sweep``, summed in int32;
    arguments as :func:`..ops.intersect_step`."""
    indptr_a, nbr_a, t_a = csr_a
    indptr_b, nbr_b, t_b = csr_b
    a1, u1 = map(_along, window1)
    a2, u2 = map(_along, window2)
    refs = [_along(r) for r in skip]
    total = None
    for i in range(n_sweep):
        off = offset + i * d
        if strategy == "bs1":  # expand frontier rows, search the fixed row
            m, x_ids, x_t = ops.expand(indptr_a, (nbr_a, t_a), frontier, d, offset=off)
            m = m & (x_t > a1) & (x_t <= u1)
            for r in refs:
                m = m & (x_ids != r)
            lo = _max(a2, x_t) if ordered else a2
            cnt = ops.count_id_in_window(nbr_b, t_b, indptr_b, _along(fixed), torch.where(m, x_ids, -1), lo, u2, n_iters)
        elif strategy == "bs2":  # expand the fixed row, search frontier rows
            m, y_ids, y_t = ops.expand(indptr_b, (nbr_b, t_b), fixed, d, offset=off)
            m = m & (y_t > a2) & (y_t <= u2)
            for r in refs:
                m = m & (y_ids != r)
            hi = _min(u1, y_t - 1) if ordered else u1
            cnt = ops.count_id_in_window(nbr_a, t_a, indptr_a, _along(frontier), torch.where(m, y_ids, -1), a1, hi,
                                         n_iters)
        else:
            raise ValueError(f"intersect_step_ref: strategy must be bs1 or bs2, not {strategy!r}")
        branch = torch.where(m, cnt, 0).sum(-1, dtype=torch.int32)
        total = branch if total is None else total + branch
    return total
