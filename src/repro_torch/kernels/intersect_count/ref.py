"""Plain PyTorch version of the intersect_count kernel.

``intersect_count_ref`` is the compare cube of the kernel's first entry.
``pair_step_ref`` is its second entry's: the compiled plans' eager
pairwise (``pw``) step (``core/compiler.py``, the ``backend="torch"``
branches), ``ops.expand`` of both sides, the window and ``skip_eq`` masks,
the broadcast compare cube and its int32 sum, looped over the two sides'
sweep offsets; and, in its ``"edges"`` form, the pairwise ``count_edges``
(the frontier id itself against the fixed row).

The CPU tests run them, the wrapper takes them for tensors on the CPU, the
compiled plans' ``"torch"`` backend calls ``pair_step_ref``, and
``chip_smoke.py`` holds the CUDA kernel to them bit for bit on the card."""
from __future__ import annotations

import torch

from repro_torch.core import ops

__all__ = ["intersect_count_ref", "pair_step_ref", "FORMS"]

FORMS = ("intersect", "edges")


def intersect_count_ref(
    a_ids, a_t, b_ids, b_t, a_lo, a_hi, b_lo, b_hi, *, ordered: bool = False
):
    a_ok = (a_ids >= 0) & (a_t > a_lo[:, None]) & (a_t <= a_hi[:, None])
    b_ok = (b_ids >= 0) & (b_t > b_lo[:, None]) & (b_t <= b_hi[:, None])
    pair = (
        (a_ids[:, :, None] == b_ids[:, None, :])
        & a_ok[:, :, None]
        & b_ok[:, None, :]
    )
    if ordered:
        pair = pair & (b_t[:, None, :] > a_t[:, :, None])
    return pair.sum(dim=(1, 2), dtype=torch.int32)


def _along(v):
    """A lead-shaped operand placed against the expansion axis."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def pair_step_ref(
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
    """The eager pw step of the compiled plans over the sweep offsets
    ``offset_a + i * d_a`` and ``offset_b + j * d_b`` (``i < n_sweep_a``,
    ``j < n_sweep_b``), summed in int32; arguments as
    :func:`..ops.pair_step`."""
    indptr_b, nbr_b, t_b = csr_b
    a2, u2 = map(_along, window2)
    refs = [_along(r) for r in skip]
    if form == "intersect":
        indptr_a, nbr_a, t_a = csr_a
        a1, u1 = map(_along, window1)
    elif form != "edges":
        raise ValueError(f"pair_step_ref: form must be one of {FORMS}, not {form!r}")
    total = None
    for i in range(n_sweep_a):
        if form == "intersect":  # the frontier's expansion, its window and skip masks
            m_x, x_ids, x_t = ops.expand(indptr_a, (nbr_a, t_a), frontier, d_a, offset=offset_a + i * d_a)
            m_x = m_x & (x_t > a1) & (x_t <= u1)
            for r in refs:
                m_x = m_x & (x_ids != r)
        for j in range(n_sweep_b):
            m_y, y_ids, y_t = ops.expand(indptr_b, (nbr_b, t_b), fixed, d_b, offset=offset_b + j * d_b)
            m_y = m_y & (y_t > a2) & (y_t <= u2)
            if form == "edges":  # the frontier id itself against the fixed row
                branch = (m_y & (_along(frontier) == y_ids)).sum(-1, dtype=torch.int32)
            else:  # the broadcast compare cube
                pair = m_x[..., :, None] & m_y[..., None, :] & (x_ids[..., :, None] == y_ids[..., None, :])
                if ordered:
                    pair = pair & (y_t[..., None, :] > x_t[..., :, None])
                branch = pair.sum(dim=(-1, -2), dtype=torch.int32)
            total = branch if total is None else total + branch
    return total
