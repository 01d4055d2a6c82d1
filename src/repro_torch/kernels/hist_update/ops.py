"""Dispatching wrappers of the hist_update kernel's two entries.

``hist_update(keys, gh, S)`` (the TPU kernel's contract) and
``hist_update_rows(xb, node, gh, n_nodes, n_bins)`` (the GBDT's
per-level histogram, read straight from the training rows) launch the
hand-written CUDA kernel (``src/repro_torch/csrc/hist_update.cu``, built
and loaded through :mod:`repro_torch.kernels.build`) for CUDA tensors, and
take their plain PyTorch versions (:mod:`.ref`) for tensors on the CPU;
there is no other route and no fallback.  What the kernel cannot take
(dtype, contiguity, shape, device) raises, and so does a launch the card
refuses.

The kernel sums in fixed point, so it gives the same bits on every launch
for the same input (``ref.fixed_point_ref`` replays it exactly);
:func:`error_bound` and :func:`error_bound_rows` state how far each entry
may lie from the exact sum.  Unlike the Pallas wrapper it replaces,
nothing is padded, and an input of zero rows launches nothing and returns
zeros.

``launches`` counts kernel launches of both entries in this process (one
per call that reached the card), ``rows_launches`` those of the ``rows``
entry alone; comparisons that call the plain versions do not count.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hist_update.ref import (
    hist_update_ref,
    hist_update_rows_ref,
    row_keys,
    scale_exponent,
)

__all__ = ["hist_update", "hist_update_rows", "error_bound", "error_bound_rows", "launches", "rows_launches"]

launches = 0
# the sharded executor's dispatch threads launch concurrently: the
# read-modify-write of a count is guarded
_count_lock = threading.Lock()
rows_launches = 0

_fns = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# keys, gh, n, S, max_bits, acc, out, stream
_KEYS_ARGS = [_P, _P, _L, _I, _P, _P, _P, _P]
# xb, node, gh, n, F, B, S, max_bits, acc, out, stream
_ROWS_ARGS = [_P, _P, _P, _L, _I, _I, _I, _P, _P, _P, _P]


def _launcher(name, argtypes):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("hist_update"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_gh(gh, n, who):
    if not isinstance(gh, torch.Tensor):
        raise TypeError(f"{who} takes torch tensors")
    if gh.dtype != torch.float32:
        raise TypeError(f"{who} takes float32 gh, got {gh.dtype}")
    if gh.shape != (n, 2):
        raise ValueError(f"{who} takes gh ({n}, 2), got {tuple(gh.shape)}")


def _check(keys, gh, n_segments):
    if not isinstance(keys, torch.Tensor):
        raise TypeError("hist_update takes torch tensors")
    if keys.dtype != torch.int32:
        raise TypeError(f"hist_update takes int32 keys, got {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError(f"hist_update takes keys (N,), got {tuple(keys.shape)}")
    _check_gh(gh, keys.shape[0], "hist_update")
    if keys.device != gh.device:
        raise ValueError("hist_update inputs must share one device")
    if not 0 <= n_segments < 2**30:
        raise ValueError(f"n_segments={n_segments} outside [0, 2^30)")


def _check_rows(xb, node, gh, n_nodes, n_bins):
    if not isinstance(xb, torch.Tensor) or not isinstance(node, torch.Tensor):
        raise TypeError("hist_update_rows takes torch tensors")
    if xb.dtype != torch.uint8 or node.dtype != torch.int32:
        raise TypeError(f"hist_update_rows takes uint8 xb and int32 node, got {xb.dtype} and {node.dtype}")
    if xb.dim() != 2 or node.shape != (xb.shape[0],):
        raise ValueError(f"hist_update_rows takes xb (N, F) and node (N,), got "
                         f"{tuple(xb.shape)} and {tuple(node.shape)}")
    _check_gh(gh, xb.shape[0], "hist_update_rows")
    if not xb.device == node.device == gh.device:
        raise ValueError("hist_update_rows inputs must share one device")
    if n_nodes < 0 or n_bins < 0 or not n_nodes * xb.shape[1] * n_bins < 2**30:
        raise ValueError(f"n_nodes={n_nodes}, n_bins={n_bins} at F={xb.shape[1]}: "
                         "the histogram must have fewer than 2^30 keys")


def _launch(name, argtypes, tensors, scalars, n_segments, device):
    """Run one entry of the kernel on ``device``: the scratch and the
    (n_segments, 2) float32 result are allocated here."""
    global launches
    if device.type != "cuda":
        raise ValueError(f"hist_update runs on cuda or cpu, not {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hist_update takes contiguous tensors")
    if tensors[-1].data_ptr() % 8:
        raise ValueError("hist_update reads gh rows as 8-byte pairs; gh is misaligned")
    out = torch.empty((n_segments, 2), dtype=torch.float32, device=device)
    acc = torch.empty((n_segments, 2), dtype=torch.int64, device=device)
    max_bits = torch.empty(2, dtype=torch.int32, device=device)
    fn = _launcher(name, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *scalars, n_segments,
                 max_bits.data_ptr(), acc.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hist_update launch ({name}) failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out


def hist_update(keys, gh, n_segments: int):
    """keys (N,) int32, gh (N, 2) float32 -> (n_segments, 2) float32: the
    sum of the gh rows of each key in [0, n_segments); other keys are
    dropped."""
    n_segments = int(n_segments)
    _check(keys, gh, n_segments)
    if keys.device.type == "cpu":
        return hist_update_ref(keys, gh, n_segments)
    n = keys.shape[0]
    if n == 0 or n_segments == 0:
        return torch.zeros((n_segments, 2), dtype=torch.float32, device=keys.device)
    return _launch("hist_update_launch", _KEYS_ARGS, (keys, gh), (n,), n_segments, keys.device)


def hist_update_rows(xb, node, gh, n_nodes: int, n_bins: int):
    """xb (N, F) uint8 bins, node (N,) int32, gh (N, 2) float32 ->
    (n_nodes, F, n_bins, 2) float32: for every row i and feature f, gh[i]
    summed into key ``node[i] * F * n_bins + f * n_bins + xb[i, f]`` of
    the flat histogram; keys outside it are dropped.  The same function
    as ``hist_update`` on ``ref.row_keys`` and gh repeated F times, without
    building either.  Bins must lie below ``n_bins``, as binning makes
    them: the kernel's fixed-point scale counts on a key taking at most
    one item of a row."""
    global rows_launches
    n_nodes, n_bins = int(n_nodes), int(n_bins)
    _check_rows(xb, node, gh, n_nodes, n_bins)
    if xb.device.type == "cpu":
        return hist_update_rows_ref(xb, node, gh, n_nodes, n_bins)
    n, f = xb.shape
    s = n_nodes * f * n_bins
    if n == 0 or s == 0:
        return torch.zeros((n_nodes, f, n_bins, 2), dtype=torch.float32, device=xb.device)
    out = _launch("hist_update_rows_launch", _ROWS_ARGS, (xb, node, gh), (n, f, n_bins), s, xb.device)
    with _count_lock:
        rows_launches += 1
    return out.reshape(n_nodes, f, n_bins, 2)


def _bound(keys, gh, n_segments: int, n_rows: int) -> torch.Tensor:
    """Half a quantum per item plus the roundings of the result, per
    entry, with the quantum set by ``n_rows`` (see ``error_bound``)."""
    if keys.shape[0] == 0:
        return torch.zeros((n_segments, 2), dtype=torch.float64, device=keys.device)
    g64 = gh.double()
    max_abs = g64.abs().amax(dim=0).tolist()
    quantum = torch.tensor(
        [2.0 ** -scale_exponent(m, n_rows) for m in max_abs], dtype=torch.float64, device=keys.device
    )
    valid = (keys >= 0) & (keys < n_segments)
    n_k = torch.bincount(torch.where(valid, keys, n_segments).long(), minlength=n_segments + 1)
    half = n_k[:n_segments, None].double() * quantum[None, :] / 2
    abs_sum = hist_update_ref(keys, g64.abs(), n_segments)
    return half + 2.0**-23 * (abs_sum + half)


def error_bound(keys, gh, n_segments: int) -> torch.Tensor:
    """(n_segments, 2) float64: how far ``hist_update``'s result may lie
    from the exact sum, per entry with n_k rows of its key: half a quantum
    per row plus the roundings of the result,
    ``n_k * 2^-k / 2 + 2^-23 * (sum |x| + n_k * 2^-k / 2)``, k set by the
    N keys.  It also covers the rounding of a float64 plain sum of up to
    2^28 rows, so the kernel can be held to one.  Reads values back (it
    syncs)."""
    return _bound(keys, gh, n_segments, keys.shape[0])


def error_bound_rows(xb, node, gh, n_nodes: int, n_bins: int) -> torch.Tensor:
    """(n_nodes, F, n_bins, 2) float64: ``error_bound``'s form for
    ``hist_update_rows``, whose quantum is set by the N training rows (a
    key sums at most N of them), not by the N*F items, so it is about F
    times finer.  Reads values back (it syncs)."""
    n, f = xb.shape
    gh_rep = gh[:, None, :].expand(n, f, 2).reshape(-1, 2)
    bound = _bound(row_keys(xb, node, n_bins), gh_rep, n_nodes * f * n_bins, n)
    return bound.reshape(n_nodes, f, n_bins, 2)
