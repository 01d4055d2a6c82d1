"""Plain PyTorch versions of the hist_update kernel's two entries (a
segment-sum histogram), and a replay of its fixed-point arithmetic.

The CPU tests run them, the wrapper takes them for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel to them on the card.  The plain
versions sum in ``gh``'s dtype; on the CPU ``index_add_`` adds the rows of
a key in row order, as the JAX package's ``segment_sum`` does there."""
from __future__ import annotations

import math

import torch

__all__ = ["hist_update_ref", "hist_update_rows_ref", "row_keys", "scale_exponent", "fixed_point_ref"]


def hist_update_ref(keys, gh, n_segments: int):
    """keys (N,) int, gh (N, 2) -> (n_segments, 2): the sum of the gh rows
    of each key; keys outside [0, n_segments) are dropped (summed into a
    spare row that is cut off)."""
    safe = torch.where((keys >= 0) & (keys < n_segments), keys, n_segments)
    out = torch.zeros((n_segments + 1, 2), dtype=gh.dtype, device=gh.device)
    out.index_add_(0, safe, gh)
    return out[:n_segments]


def row_keys(xb, node, n_bins: int):
    """(N, F) bins and (N,) node ids -> the (N*F,) int32 fused keys
    ``node * F * n_bins + f * n_bins + bin``, row by row, as the JAX
    package's ``gbdt._histograms`` builds them."""
    f = xb.shape[1]
    keys = (
        node[:, None].to(torch.int32) * (f * n_bins)
        + torch.arange(f, dtype=torch.int32, device=xb.device)[None, :] * n_bins
        + xb.to(torch.int32)
    )
    return keys.reshape(-1)


def hist_update_rows_ref(xb, node, gh, n_nodes: int, n_bins: int):
    """(N, F) uint8 bins, (N,) int32 node, (N, 2) gh ->
    (n_nodes, F, n_bins, 2): the fused keys, the gh rows repeated once per
    feature and one segment sum, as the JAX package's ``gbdt._histograms``
    computes it (``gbdt.py:54-67``)."""
    n, f = xb.shape
    flat = hist_update_ref(
        row_keys(xb, node, n_bins),
        gh[:, None, :].expand(n, f, 2).reshape(-1, 2),
        n_nodes * f * n_bins,
    )
    return flat.reshape(n_nodes, f, n_bins, 2)


def scale_exponent(max_abs: float, n: int) -> int:
    """The kernel's fixed-point exponent k of a column: values are summed
    as rint(x * 2^k), with k = 61 - L - e for n <= 2^L rows and
    max |x| < 2^e, so that the sum of |rint(x * 2^k)| stays below 2^62."""
    if not max_abs > 0:
        return 0
    e = math.frexp(max_abs)[1]
    return 61 - max(0, (n - 1).bit_length()) - e


def fixed_point_ref(keys, gh, n_segments: int, n_rows: int):
    """The kernel's arithmetic, replayed plainly: per column,
    q = rint(x * 2^k) with k = ``scale_exponent(max |x|, n_rows)``, summed
    per key as int64 (``index_add_``; integer sums commute, so any order
    gives the same sum), then Q * 2^-k rounded to float32 once.  Equal to
    the kernel bit for bit.  ``n_rows`` is the count that sets k: the
    number of keys for the ``keys`` entry, of training rows for the
    ``rows`` entry.  Reads max |x| back to the host."""
    safe = torch.where((keys >= 0) & (keys < n_segments), keys, n_segments).long()
    out = torch.empty((n_segments, 2), dtype=torch.float32, device=gh.device)
    for c in range(2):
        x = gh[:, c].double()
        k = scale_exponent(float(x.abs().max()) if len(x) else 0.0, n_rows)
        q = torch.round(x * 2.0**k).long()  # round half to even, as rint
        acc = torch.zeros(n_segments + 1, dtype=torch.int64, device=gh.device)
        acc.index_add_(0, safe, q)
        out[:, c] = (acc[:n_segments].double() * 2.0**-k).float()
    return out
