"""AdamW over a dict of tensors, and int8 error-feedback gradient
compression (the port of the JAX package's
``repro.distributed.optimizer``).

The state mirrors the params: ``{"m": ..., "v": ..., "step": int32}``,
``m`` and ``v`` float32 trees of the params' shapes.  A tree is a dict of
tensors, possibly nested; leaves are walked in sorted-key order, as a
pytree flatten orders a dict.  The update keeps the reference's rule
exactly: the global-norm clip ``min(1, grad_clip / (gn + 1e-9))``, bias
correction ``1 - b ** step`` in float32, and the weight decay inside
``delta``.  ``torch.optim.AdamW`` is not it: it has no global clip, and
its state differs.

Every step stays on the device: the clip and the bias corrections are
0-d device tensors (no ``.item()``), and each elementwise stage runs over
all leaves at once through ``torch._foreach_*`` (one multi-tensor launch
a stage on the card, in place of one a leaf).  Functions return new
trees; the caller may copy them into its parameters in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "adamw_apply",
    "ef_init",
    "compress_int8",
    "decompress_int8",
    "ef_compress_grads",
]

Tree = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress: bool = False  # int8 error-feedback gradient compression


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken in order from ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def _map(fn: Callable, tree):
    return _rebuild(tree, iter([fn(x) for x in _leaves(tree)]))


def adamw_init(params: Tree) -> Tree:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = _leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {
        "m": _map(zeros, params),
        "v": _map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def ef_init(params: Tree) -> Tree:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_grads(grads: Tree, residual: Tree) -> Tuple[Tree, Tree]:
    """Error feedback: transmit quantize(g + r); keep the error locally."""
    deq, new_r = [], []
    for g, r in zip(_leaves(grads), _leaves(residual)):
        x = g.to(torch.float32) + r
        q, s = compress_int8(x)
        d = decompress_int8(q, s)
        deq.append(d)
        new_r.append(x - d)
    return _rebuild(grads, iter(deq)), _rebuild(grads, iter(new_r))


def _global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, from the per-leaf norms
    (one multi-tensor launch on the card)."""
    norms = torch._foreach_norm([x.to(torch.float32) for x in leaves])
    return torch.sqrt(torch.sum(torch.square(torch.stack(norms))))


def adamw_update(params: Tree, grads: Tree, opt_state: Tree, cfg: AdamWConfig):
    """One AdamW step; returns ``(new_params, new_state, grad_norm)``, the
    norm a 0-d device tensor taken before the clip."""
    p_l, g_l = _leaves(params), _leaves(grads)
    gn = _global_norm(g_l)
    new_p, m_new, v_new, step = adamw_apply(
        p_l, g_l, _leaves(opt_state["m"]), _leaves(opt_state["v"]), opt_state["step"], gn, cfg)
    return (
        _rebuild(params, iter(new_p)),
        {"m": _rebuild(params, iter(m_new)), "v": _rebuild(params, iter(v_new)), "step": step},
        gn,
    )


def adamw_apply(p_l, g_l, m_l, v_l, step, gn, cfg: AdamWConfig):
    """The update of :func:`adamw_update` on lists of leaves, given the
    global gradient norm ``gn`` (a 0-d tensor): ``(new_p, new_m, new_v,
    step + 1)``.  The sharded step calls it on each rank's shards with the
    norm reduced over the mesh."""
    step = step + 1
    clip = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    # the bases are filled on the device: a tensor built from a host value
    # would be a pageable (synchronous) copy
    base = lambda b: torch.full((), b, dtype=torch.float32, device=stepf.device)
    bc1 = 1.0 - torch.pow(base(b1), stepf)
    bc2 = 1.0 - torch.pow(base(b2), stepf)

    g32 = torch._foreach_mul([g.to(torch.float32) for g in g_l], clip)
    m_new = torch._foreach_add(torch._foreach_mul(m_l, b1), torch._foreach_mul(g32, 1 - b1))
    v_new = torch._foreach_add(torch._foreach_mul(v_l, b2), torch._foreach_mul(torch._foreach_mul(g32, g32), 1 - b2))
    mh = torch._foreach_div(m_new, bc1)
    vh = torch._foreach_div(v_new, bc2)
    p32 = [p.to(torch.float32) for p in p_l]
    delta = torch._foreach_add(
        torch._foreach_div(mh, torch._foreach_add(torch._foreach_sqrt(vh), cfg.eps)),
        torch._foreach_mul(p32, cfg.weight_decay),
    )
    new_p = torch._foreach_sub(p32, torch._foreach_mul(delta, cfg.lr))
    new_p = [x.to(p.dtype) for x, p in zip(new_p, p_l)]
    return new_p, m_new, v_new, step
