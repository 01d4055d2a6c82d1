"""Dispatching wrapper of the flash_attention kernel.

``flash_attention`` launches the hand-written CUDA kernel
(``src/repro_torch/csrc/flash_attention.cu``, built and loaded through
:mod:`repro_torch.kernels.build`) for CUDA tensors, and takes the plain
PyTorch version (:mod:`.ref`) for tensors on the CPU; there is no other
route and no fallback.  What the kernel cannot take (dtype, head size,
shape, contiguity, alignment, device) raises on either device.

It keeps the contract of the JAX package's wrapper
(``repro.kernels.flash_attention.ops.flash_attention``): q (B, T, H, hd),
k and v (B, S, K, hd) with H % K == 0 (GQA), out (B, T, H, hd) in q's
dtype.  Beyond that wrapper, it takes the sliding window of the JAX LM's
attention (``window``: key j visible to row i only if i - j < window, as
``src/repro/models/layers.py:151-152, 163-164`` mask it; causal only,
and every row must see a key, so T <= S + window - 1) and head size 80
(zamba2-2.7b's), on every path and route that :func:`plan` and
:func:`bwd_plan` send them to.  Unlike that wrapper it pads and repeats nothing: the kernel reads
kv head h // (H / K) in place and masks keys at positions >= S, so causal
rows i >= S see exactly the S keys, as the plain version does.  The
block arguments only decide what the JAX wrapper refuses (full attention
over an S that is not a multiple of ``min(block_k, S)``); the kernel
picks its own tiles, and the result does not depend on them.

Each call is one launch, on the path that :func:`plan` names for its
shape (the ``.cu`` entry makes the same choice, and
``flash_attention_plan`` there reports it): ``"short"`` (T and S at most
32 at hd 16, 32, 64 or 128, one batch element's slabs bulk-copied into a
ring in shared memory; FraudGT's shape), ``"wgmma"`` (bf16 at hd 64, 80
or 128: TMA tiles and the tensor cores; hd 80 on the hd-128 tiles, the
dims past 80 zeros) or ``"simt"`` (the rest, on the CUDA cores).  Under a
window the wgmma and simt paths visit only the key tiles that hold a
visible pair (:func:`fwd_tiles`).  A launch the
card refuses raises; no path stands in for another.

Training: ``flash_attention(..., return_lse=True)`` also returns each
row's float32 logsumexp (B, H, T) of the scaled, masked scores, on every
path, and :func:`flash_attention_bwd` launches the hand-written backward
on it, at every shape the forward takes; :class:`FlashAttentionFn` joins
the two for autograd.  The backward's path is :func:`bwd_plan`'s (the
``.cu`` entry makes the same choice, ``flash_attention_bwd_plan``
reports it): ``"short"`` for the forward's short-path shapes
(``csrc/flash_short_bwd.cuh``: on its ``"ring"`` route, persistent
blocks over a ring of bulk-copied batch elements, where two stages fit,
else on its ``"chunked"`` route; :func:`short_bwd_route`), else the
long backward (``csrc/flash_long_bwd.cuh``: a row-dot pass, a dQ pass and a dK/dV pass,
no atomics) on its ``"wgmma"`` route (bf16 at hd 64, 80 or 128: TMA tiles, a
producer warpgroup and two consumer warpgroups on ``wgmma``; its tile
loops are :func:`bwd_tiles`) or its ``"simt"`` route (the rest, CUDA
cores).  On the CPU both take the plain version.

``launches`` counts forward launches in this process (one per call that
reached the card), ``lse_launches`` those of them that wrote the
logsumexp, ``bwd_launches`` the backward's launches (one a call, on
either path) and ``long_bwd_launches`` those of them on the long
backward; comparisons that call the plain versions do not count.
"""
from __future__ import annotations

import ctypes
import threading
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = [
    "flash_attention",
    "flash_attention_bwd",
    "FlashAttentionFn",
    "plan",
    "kernel_plan",
    "bwd_plan",
    "kernel_bwd_plan",
    "bwd_chunk_heads",
    "short_bwd_route",
    "kernel_short_bwd_route",
    "kernel_short_bwd_grid",
    "bwd_tiles",
    "kernel_bwd_tiles",
    "fwd_tiles",
    "kernel_fwd_tiles",
    "launches",
    "lse_launches",
    "bwd_launches",
    "long_bwd_launches",
    "HEAD_DIMS",
    "WGMMA_HEAD_DIMS",
    "DTYPES",
    "PATHS",
    "BWD_PATHS",
    "SHORT_BWD_ROUTES",
]

launches = 0
lse_launches = 0
bwd_launches = 0
long_bwd_launches = 0
# the sharded executor's dispatch threads launch concurrently: the
# read-modify-write of a count is guarded
_count_lock = threading.Lock()

HEAD_DIMS = (16, 32, 64, 80, 128)  # the kernel's template instances
WGMMA_HEAD_DIMS = (64, 80, 128)  # those of the tensor-core path and route, in bf16
SHORT_HEAD_DIMS = (16, 32, 64, 128)  # those of the short path (hd 80 goes to wgmma or simt at every T)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the launch's dtype code
_SCALE = {hd: 1.0 / math.sqrt(hd) for hd in HEAD_DIMS}
PATHS = ("short", "wgmma", "simt")  # in the order of the .cu entry's path codes
BWD_PATHS = ("short", "wgmma", "simt")  # the backward's, in the order of its path codes
SHORT_BWD_ROUTES = ("ring", "chunked")  # the short backward's, in the order of its route codes
# the short path's limits, as in csrc/flash_short.cuh
SHORT_MAX_LEN = 32
SHORT_HEADER = 128  # bytes of barriers before the slabs
SMEM_MAX = 232448  # shared memory a block can use on sm_90 (227 KB)
# the short backward's ring route, as in csrc/flash_short_bwd.cuh
BWD_RING_STAGES = 2  # ring depth where it fits
BWD_RING_HEADER = 128  # bytes of barriers before the p/dS buffer
NEG_LSE = -float("inf")  # the logsumexp of a row with no key (S = 0)
ERR_TENSOR_MAP = 10001  # the wgmma paths' refusal to encode a tensor map (csrc/flash_hopper.cuh)
# the long backward's wgmma route (csrc/flash_long_bwd.cuh): a dK/dV block
# holds BWD_KEY_TILE keys and takes query rows BWD_ROW_STAGE at a time; a
# dQ block holds BWD_ROW_TILE rows and takes keys BWD_KEY_STAGE at a time
BWD_KEY_TILE, BWD_ROW_STAGE, BWD_ROW_TILE, BWD_KEY_STAGE = 128, 64, 128, 128
# the forward's wgmma path (csrc/flash_wgmma.cuh): a block holds FWD_ROW_TILE
# rows and takes keys FWD_KEY_TILE at a time
FWD_ROW_TILE, FWD_KEY_TILE = 128, 128

_fn = None
_bwd_fn = None


def plan(b: int, t: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype, causal: bool,
         window=None) -> str:
    """The path a CUDA launch at this shape takes: ``"short"`` when T and S
    are at most 32, hd is not 80 and two stages of one batch element's q, k
    and v slabs fit in a block's shared memory, else ``"wgmma"`` for bf16
    at hd 64, 80 or 128, else ``"simt"``: hd 80 (zamba2-2.7b's) runs on
    wgmma in bf16 and on simt in float32 at every T.  A pure function of
    the shape; the batch size, the mask and the window do not change the
    choice."""
    size = 2 if dtype == torch.bfloat16 else 4
    stage = (t * h + 2 * s * kvh) * hd * size
    if (hd in SHORT_HEAD_DIMS and t <= SHORT_MAX_LEN and s <= SHORT_MAX_LEN
            and SHORT_HEADER + 2 * stage <= SMEM_MAX):
        return "short"
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def bwd_plan(b: int, t: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype, causal: bool,
             window=None) -> str:
    """The path a CUDA backward launch at this shape takes: ``"short"``
    where the forward's :func:`plan` is ``"short"``, else the long
    backward's ``"wgmma"`` route for bf16 at hd 64, 80 or 128, else its
    ``"simt"`` route.  A pure function of the shape; the window does not
    change it."""
    if plan(b, t, s, h, kvh, hd, dtype, causal) == "short":
        return "short"
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "simt"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def short_bwd_route(b: int, t: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype, causal: bool):
    """The route a CUDA backward launch takes inside :func:`bwd_plan`'s
    ``"short"``: ``("ring", stages)`` where at least two stages of one batch
    element's slabs (q, dO, o, k, v in the inputs' type and its float32
    lse, 128-byte aligned) fit in a block's shared memory beside the
    element's p/dS buffer (a float2 for every (head, row, key), rows
    ``S | 1`` apart), with ``stages`` BWD_RING_STAGES or as many as fit;
    else ``("chunked", 0)``.  A pure function of the shape; the batch size
    and the mask do not change it.  Raises for a shape whose backward is
    not the short one."""
    if bwd_plan(b, t, s, h, kvh, hd, dtype, causal) != "short":
        raise ValueError(f"the backward at {(b, t, s, h, kvh, hd, dtype)} is not the short one")
    size = 2 if dtype == torch.bfloat16 else 4
    stage = _cdiv((3 * t * h + 2 * s * kvh) * hd * size + 4 * h * t, 128) * 128
    pds = _cdiv(8 * h * t * (s | 1), 128) * 128
    n = (SMEM_MAX - BWD_RING_HEADER - pds) // stage
    return ("ring", min(n, BWD_RING_STAGES)) if n >= 2 else ("chunked", 0)


def _key_tile_range(r0: int, rows: int, t: int, s: int, causal: bool, window, tile: int):
    """The ``tile``-key tiles [first, end) that rows [r0, r0 + rows) below T
    see (``key_tile_range`` in ``csrc/flash_common.cuh``)."""
    r1 = min(r0 + rows, t)
    k_end = min(r1, s) if causal else s
    first = max(0, r0 - window + 1) // tile if window else 0
    return first, max(first, _cdiv(k_end, tile))


def _row_tile_range(j0: int, keys: int, t: int, s: int, causal: bool, window, tile: int):
    """The ``tile``-row tiles [first, end) whose rows see a key of keys [j0,
    j0 + keys) below S (``row_tile_range`` in ``csrc/flash_common.cuh``);
    both ceil(T / tile) when no row does."""
    n = _cdiv(t, tile)
    if not causal:
        return 0, n
    if j0 >= t:
        return n, n
    first = j0 // tile
    end = min(n, _cdiv(min(j0 + keys, s) - 1 + window, tile)) if window else n
    return first, max(first, end)


def fwd_tiles(t: int, s: int, causal: bool, window=None):
    """The forward's tile loop on its ``"wgmma"`` path, a pure function of
    T, S, the mask and the window: for each FWD_ROW_TILE-row block, the
    FWD_KEY_TILE-key tiles ``(first, end)`` it visits, exactly those that
    hold a visible (row, key) pair: causal blocks stop at their last row's
    last key, and under a window start at the tile of their first row's
    first key.  The ``.cu`` entry ``flash_attention_fwd_tiles`` gives the
    same numbers, and the simt path loops the same way over its own
    tiles."""
    return tuple(_key_tile_range(mt * FWD_ROW_TILE, FWD_ROW_TILE, t, s, causal, window, FWD_KEY_TILE)
                 for mt in range(_cdiv(t, FWD_ROW_TILE)))


def bwd_tiles(t: int, s: int, causal: bool, window=None):
    """The long backward's tile loops on its ``"wgmma"`` route, a pure
    function of T, S, the mask and the window: ``(q_ranges, k_ranges)``,
    where ``q_ranges[kt]`` is the range ``(first, end)`` of BWD_ROW_STAGE-row
    query tiles the dK/dV block of key tile ``kt`` (BWD_KEY_TILE keys)
    visits (both ``ceil(T / BWD_ROW_STAGE)`` when none), and
    ``k_ranges[mt]`` the range of BWD_KEY_STAGE-key tiles the dQ block of
    row tile ``mt`` (BWD_ROW_TILE rows) visits.  A tile is visited iff it
    holds a visible (row, key) pair: key j < S visible to row i < T, with
    j <= i when causal and i - j < window under a window.  The ``.cu``
    entry ``flash_attention_bwd_tiles`` gives the same numbers."""
    q_ranges = tuple(_row_tile_range(kt * BWD_KEY_TILE, BWD_KEY_TILE, t, s, causal, window, BWD_ROW_STAGE)
                     for kt in range(_cdiv(s, BWD_KEY_TILE)))
    k_ranges = tuple(_key_tile_range(mt * BWD_ROW_TILE, BWD_ROW_TILE, t, s, causal, window, BWD_KEY_STAGE)
                     for mt in range(_cdiv(t, BWD_ROW_TILE)))
    return q_ranges, k_ranges


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_plan.argtypes = [ctypes.c_int] * 8
        lib.flash_attention_plan.restype = ctypes.c_int
        lib.flash_attention_fwd_tiles.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        lib.flash_attention_fwd_tiles.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd_chunk.argtypes = [ctypes.c_int] * 7
        lib.flash_attention_bwd_chunk.restype = ctypes.c_int
        lib.flash_attention_bwd_plan.argtypes = [ctypes.c_int] * 8
        lib.flash_attention_bwd_plan.restype = ctypes.c_int
        lib.flash_attention_bwd_tiles.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        lib.flash_attention_bwd_tiles.restype = ctypes.c_int
        lib.flash_attention_bwd_route.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.flash_attention_bwd_route.restype = ctypes.c_int
        lib.flash_attention_bwd_grid.argtypes = [ctypes.c_int] * 7
        lib.flash_attention_bwd_grid.restype = ctypes.c_longlong
        _bwd_fn = fn
    return _bwd_fn


def bwd_chunk_heads(b: int, t: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype) -> int:
    """The query heads a backward block of the built ``.cu`` takes at a
    time at this shape (all H where one batch element's rows fit in shared
    memory), 0 where the shape has no backward; needs the card's toolkit."""
    _bwd_launcher()
    return build.load("flash_attention").flash_attention_bwd_chunk(b, t, s, h, kvh, hd, DTYPES[dtype])


def kernel_plan(b: int, t: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype, causal: bool) -> str:
    """The path the built ``.cu`` entry picks for this shape (needs the
    library, so the card's toolkit): it must equal :func:`plan`."""
    _launcher()
    code = build.load("flash_attention").flash_attention_plan(b, t, s, h, kvh, hd, DTYPES[dtype], int(causal))
    if code < 0:
        raise ValueError(f"flash_attention refuses the shape {(b, t, s, h, kvh, hd, dtype)}")
    return PATHS[code]


def _ranges(first, end, n: int):
    return tuple((first[i], end[i]) for i in range(n))


def kernel_bwd_tiles(t: int, s: int, causal: bool, window=None):
    """The tile loops of the built ``.cu`` (``flash_attention_bwd_tiles``;
    needs the card's toolkit): they must equal :func:`bwd_tiles`."""
    _bwd_launcher()
    n_k, n_m = _cdiv(s, BWD_KEY_TILE), _cdiv(t, BWD_ROW_TILE)
    arrays = [(ctypes.c_int * max(1, n))() for n in (n_k, n_k, n_m, n_m)]
    if build.load("flash_attention").flash_attention_bwd_tiles(t, s, int(causal), window or 0, *arrays) != 0:
        raise ValueError(f"flash_attention_bwd_tiles refuses T = {t}, S = {s}, window {window}")
    return _ranges(*arrays[:2], n_k), _ranges(*arrays[2:], n_m)


def kernel_fwd_tiles(t: int, s: int, causal: bool, window=None):
    """The wgmma forward's tile loop as the built ``.cu`` computes it
    (``flash_attention_fwd_tiles``; needs the card's toolkit): it must
    equal :func:`fwd_tiles`."""
    _launcher()
    n = _cdiv(t, FWD_ROW_TILE)
    first, end = (ctypes.c_int * max(1, n))(), (ctypes.c_int * max(1, n))()
    if build.load("flash_attention").flash_attention_fwd_tiles(t, s, int(causal), window or 0, first, end) != 0:
        raise ValueError(f"flash_attention_fwd_tiles refuses T = {t}, S = {s}, window {window}")
    return _ranges(first, end, n)


def kernel_bwd_plan(b: int, t: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype, causal: bool) -> str:
    """The backward path the built ``.cu`` entry picks for this shape
    (needs the card's toolkit): it must equal :func:`bwd_plan`."""
    _bwd_launcher()
    code = build.load("flash_attention").flash_attention_bwd_plan(b, t, s, h, kvh, hd, DTYPES[dtype], int(causal))
    if code < 0:
        raise ValueError(f"flash_attention_bwd refuses the shape {(b, t, s, h, kvh, hd, dtype)}")
    return BWD_PATHS[code]


def kernel_short_bwd_route(b: int, t: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype, causal: bool):
    """The short backward's route and stage count as the built ``.cu``
    decides them (``flash_attention_bwd_route``; needs the card's
    toolkit): they must equal :func:`short_bwd_route`."""
    _bwd_launcher()
    stages = ctypes.c_int(0)
    code = build.load("flash_attention").flash_attention_bwd_route(
        b, t, s, h, kvh, hd, DTYPES[dtype], int(causal), ctypes.byref(stages))
    if code < 0:
        raise ValueError(f"the backward at {(b, t, s, h, kvh, hd, dtype)} is not the short one")
    return SHORT_BWD_ROUTES[code], stages.value


def kernel_short_bwd_grid(b: int, t: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype) -> int:
    """The blocks a short-backward launch at this shape runs on this card
    (``flash_attention_bwd_grid``): on the ring route the persistent grid,
    min(B, the blocks resident on the card), which is also the stride a
    block takes over the batch; B on the chunked route."""
    _bwd_launcher()
    grid = build.load("flash_attention").flash_attention_bwd_grid(b, t, s, h, kvh, hd, DTYPES[dtype])
    if grid < 0:
        raise ValueError(f"no short-backward grid at {(b, t, s, h, kvh, hd, dtype)} on this card")
    return grid


def _check(q, k, v, causal, block_q, block_k, window=None):
    """Raise on what the kernel does not take; return (b, t, h, hd, s, kvh).
    Written for speed: it runs on each of FraudGT's 3,012 calls a predict."""
    if not (isinstance(q, torch.Tensor) and isinstance(k, torch.Tensor) and isinstance(v, torch.Tensor)):
        raise TypeError("flash_attention takes torch tensors")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or v.shape != ks:
        raise ValueError(
            f"flash_attention takes q (B, T, H, hd) and k, v (B, S, K, hd), got "
            f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}"
        )
    b, t, h, hd = qs
    kb, s, kvh, khd = ks
    if kb != b or khd != hd or kvh == 0 or h % kvh:
        raise ValueError(
            f"flash_attention: k/v {tuple(ks)} do not fit q {tuple(qs)} "
            f"(same batch and head size, H % K == 0)"
        )
    dt = q.dtype
    if dt not in DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head sizes {HEAD_DIMS}, got {hd}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention inputs must share one device")
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive, got {block_q}, {block_k}")
    if not causal and s and s % min(block_k, s):
        raise ValueError("pad S to a block multiple for non-causal attention")
    if window is not None:
        if not causal:
            raise ValueError("a sliding window comes with the causal mask: the reference builds no other")
        if isinstance(window, bool) or not isinstance(window, int) or window < 1:
            raise ValueError(f"the window must be a positive int, got {window!r}")
        if t > s + window - 1:
            raise ValueError(f"under a window of {window} over S = {s} keys, rows from {s + window - 1} on "
                             f"(T = {t}) see no key")
    return b, t, h, hd, s, kvh


def _heads_flat(x, n):
    """(B, n, H, hd) -> (B * H, n, hd), the plain versions' layout."""
    b, _, h, hd = x.shape
    return x.transpose(1, 2).reshape(b * h, n, hd)


def _heads_back(x, b, h, n):
    """(B * H, n, hd) -> (B, n, H, hd), contiguous."""
    return x.reshape(b, h, n, x.shape[-1]).transpose(1, 2).contiguous()


def flash_attention(
    q, k, v, *, causal: bool = True, block_q: int = 128, block_k: int = 128, return_lse: bool = False,
    window=None,
):
    """q (B, T, H, hd); k/v (B, S, K, hd) with H % K == 0 (GQA) ->
    (B, T, H, hd): softmax(q k^T / sqrt(hd)) v per head, over keys j <= i
    when ``causal`` (top-left aligned) and over all S keys otherwise;
    ``window`` (causal only) keeps the keys with i - j < window.

    ``return_lse`` returns ``(out, lse)`` with the rows' float32
    logsumexp (B, H, T) of the scaled, masked scores, which
    :func:`flash_attention_bwd` takes; every path writes it."""
    global launches, lse_launches
    b, t, h, hd, s, kvh = _check(q, k, v, causal, block_q, block_k, window)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
        g = h // kvh
        kk = k.repeat_interleave(g, dim=2) if g > 1 else k
        vv = v.repeat_interleave(g, dim=2) if g > 1 else v
        res = flash_attention_ref(
            _heads_flat(q, t), _heads_flat(kk, s), _heads_flat(vv, s), causal=causal, return_lse=return_lse,
            window=window,
        )
        if return_lse:
            return _heads_back(res[0], b, h, t), res[1].reshape(b, h, t)
        return _heads_back(res, b, h, t)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("flash_attention reads 16-byte vectors; an input is misaligned")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0 or s == 0:
        out.zero_()
        return (out, lse.fill_(NEG_LSE)) if return_lse else out
    fn = _launcher()
    dev = q.get_device()
    args = (qp, kp, vp, out.data_ptr(), None if lse is None else lse.data_ptr(), DTYPES[q.dtype],
            b, t, s, h, kvh, hd, 1 if causal else 0, window or 0, _SCALE[hd])
    # the raw handle of the current stream, without building a Stream object
    # (this call sits on FraudGT's path 3,012 times a predict)
    if dev == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        path = plan(b, t, s, h, kvh, hd, q.dtype, causal)
        what = "a tensor map could not be encoded" if err == ERR_TENSOR_MAP else f"CUDA error {err}"
        raise RuntimeError(f"flash_attention launch failed on the {path!r} path: {what}")
    with _count_lock:
        launches += 1
        if return_lse:
            lse_launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True, window=None):
    """The gradients of :func:`flash_attention` at any shape it takes: from
    q (B, T, H, hd), k and v (B, S, K, hd), the forward's output o and
    logsumexp lse (B, H, T), and the output gradient do (B, T, H, hd) ->
    (dq, dk, dv) in q's dtype, dk and dv summed over each GQA group, under
    the forward's mask and ``window``.  On
    the card one call of the hand-written backward on :func:`bwd_plan`'s
    path (the long path allocates its float32 row scratch here); on the
    CPU its plain version."""
    global bwd_launches, long_bwd_launches
    # no block arguments: the JAX wrapper's refusal of a full-attention S
    # off its blocks is the forward's (a block_k >= S takes every S)
    b, t, h, hd, s, kvh = _check(q, k, v, causal, 128, 1 << 30, window)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and do must be q's shape {tuple(q.shape)} and dtype {q.dtype}")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 ({b}, {h}, {t}), got {lse.dtype} {tuple(lse.shape)}")
    if any(x.device != q.device for x in (o, do, lse)):
        raise ValueError("flash_attention_bwd inputs must share one device")
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
        g = h // kvh
        kk = k.repeat_interleave(g, dim=2) if g > 1 else k
        vv = v.repeat_interleave(g, dim=2) if g > 1 else v
        dq, dk, dv = flash_attention_bwd_ref(
            _heads_flat(q, t), _heads_flat(kk, s), _heads_flat(vv, s), _heads_flat(o, t), _heads_flat(do, t),
            lse.reshape(b * h, t), causal=causal, window=window,
        )
        # per query head -> per kv head: the sum over each group
        fold = lambda x: x.reshape(b, kvh, g, s, hd).sum(dim=2).transpose(1, 2).contiguous().to(q.dtype)
        return _heads_back(dq, b, h, t), fold(dk.float()), fold(dv.float())
    tensors = (q, k, v, o, do, lse)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_attention_bwd takes contiguous tensors")
    if any(x.data_ptr() % 16 for x in tensors[:5]):
        raise ValueError("flash_attention_bwd reads 16-byte vectors; an input is misaligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or s == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    fn = _bwd_launcher()
    dev = q.get_device()
    path = bwd_plan(b, t, s, h, kvh, hd, q.dtype, causal)
    # the long paths' float32 row scratch: (B, H, T) on the simt route,
    # (B, H, ceil(T / 64), 2, 64) on the wgmma route; one size for both
    dsum = None if path == "short" else torch.empty(
        2 * b * h * _cdiv(t, BWD_ROW_STAGE) * BWD_ROW_STAGE, dtype=torch.float32, device=q.device)
    args = (*(x.data_ptr() for x in tensors), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if dsum is None else dsum.data_ptr(), DTYPES[q.dtype],
            b, t, s, h, kvh, hd, 1 if causal else 0, window or 0, _SCALE[hd])
    if dev == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed on the {path!r} path: CUDA error {err}")
    with _count_lock:
        bwd_launches += 1
        if path != "short":
            long_bwd_launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Causal (optionally windowed) or full attention through the kernels
    both ways: the forward launch writes the row logsumexp, the backward is
    :func:`flash_attention_bwd`, at every shape the forward takes.
    ``FlashAttentionFn.apply(q, k, v, causal, window=None)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window=None):
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), lse, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
