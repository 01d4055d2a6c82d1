"""Dispatching wrapper of the hist_update kernel.

``hist_update`` launches the hand-written CUDA kernel
(``src/repro_torch/csrc/hist_update.cu``, built and loaded through
:mod:`repro_torch.kernels.build`) for CUDA tensors, and takes the plain
PyTorch version (:mod:`.ref`) for tensors on the CPU; there is no other
route and no fallback.  What the kernel cannot take (dtype, contiguity,
shape, device) raises.

The kernel sums in fixed point, so it gives the same bits on every launch
for the same input; :func:`error_bound` states how far it may lie from the
exact sum.  Unlike the Pallas wrapper it replaces, nothing is padded, and
an input of zero rows launches nothing and returns zeros.

``launches`` counts kernel launches in this process (one per call that
reached the card); comparisons that call the plain version do not count.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hist_update.ref import hist_update_ref

__all__ = ["hist_update", "error_bound", "launches"]

launches = 0

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("hist_update").hist_update_launch
        fn.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(keys, gh, n_segments):
    if not isinstance(keys, torch.Tensor) or not isinstance(gh, torch.Tensor):
        raise TypeError("hist_update takes torch tensors")
    if keys.dtype != torch.int32:
        raise TypeError(f"hist_update takes int32 keys, got {keys.dtype}")
    if gh.dtype != torch.float32:
        raise TypeError(f"hist_update takes float32 gh, got {gh.dtype}")
    if keys.device != gh.device:
        raise ValueError("hist_update inputs must share one device")
    if keys.dim() != 1 or gh.shape != (keys.shape[0], 2):
        raise ValueError(
            f"hist_update takes keys (N,) and gh (N, 2), got "
            f"{tuple(keys.shape)} and {tuple(gh.shape)}"
        )
    if not 0 <= n_segments < 2**30:
        raise ValueError(f"n_segments={n_segments} outside [0, 2^30)")


def hist_update(keys, gh, n_segments: int):
    """keys (N,) int32, gh (N, 2) float32 -> (n_segments, 2) float32: the
    sum of the gh rows of each key in [0, n_segments); other keys are
    dropped."""
    global launches
    n_segments = int(n_segments)
    _check(keys, gh, n_segments)
    if keys.device.type == "cpu":
        return hist_update_ref(keys, gh, n_segments)
    if keys.device.type != "cuda":
        raise ValueError(f"hist_update runs on cuda or cpu, not {keys.device}")
    if not (keys.is_contiguous() and gh.is_contiguous()):
        raise ValueError("hist_update takes contiguous tensors")
    if gh.data_ptr() % 8:
        raise ValueError("hist_update reads gh rows as 8-byte pairs; gh is misaligned")
    n = keys.shape[0]
    if n == 0 or n_segments == 0:
        return torch.zeros((n_segments, 2), dtype=torch.float32, device=keys.device)
    out = torch.empty((n_segments, 2), dtype=torch.float32, device=keys.device)
    acc = torch.empty((n_segments, 2), dtype=torch.int64, device=keys.device)
    max_bits = torch.empty(2, dtype=torch.int32, device=keys.device)
    fn = _launcher()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = fn(
            keys.data_ptr(),
            gh.data_ptr(),
            n,
            n_segments,
            max_bits.data_ptr(),
            acc.data_ptr(),
            out.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"hist_update launch failed: CUDA error {err}")
    launches += 1
    return out


def scale_exponent(max_abs: float, n: int) -> int:
    """The kernel's fixed-point exponent k of a column: values are summed
    as rint(x * 2^k), with k = 61 - L - e for n <= 2^L rows and
    max |x| < 2^e, so that the sum of |rint(x * 2^k)| stays below 2^62."""
    if not max_abs > 0:
        return 0
    e = math.frexp(max_abs)[1]
    return 61 - max(0, (n - 1).bit_length()) - e


def error_bound(keys, gh, n_segments: int) -> torch.Tensor:
    """(n_segments, 2) float64: how far the kernel's result may lie from
    the exact sum, per entry with n_k rows of its key: half a quantum per
    row plus the roundings of the result,
    ``n_k * 2^-k / 2 + 2^-23 * (sum |x| + n_k * 2^-k / 2)``.
    It also covers the rounding of a float64 plain sum of up to 2^28 rows,
    so the kernel can be held to one.  Reads values back (it syncs)."""
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((n_segments, 2), dtype=torch.float64, device=keys.device)
    g64 = gh.double()
    max_abs = g64.abs().amax(dim=0).tolist()
    quantum = torch.tensor(
        [2.0 ** -scale_exponent(m, n) for m in max_abs], dtype=torch.float64, device=keys.device
    )
    valid = (keys >= 0) & (keys < n_segments)
    n_k = torch.bincount(torch.where(valid, keys, n_segments).long(), minlength=n_segments + 1)
    half = n_k[:n_segments, None].double() * quantum[None, :] / 2
    abs_sum = hist_update_ref(keys, g64.abs(), n_segments)
    return half + 2.0**-23 * (abs_sum + half)
