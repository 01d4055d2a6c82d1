"""GPipe-style pipeline parallelism over a mesh dim (the port of the JAX
package's ``repro.distributed.pipeline``).

The layer stack is split into S stages laid out along a ``pipe`` mesh
dim; microbatches stream through the stages, each rank sending its
activations to the next stage with ``torch.distributed.batch_isend_irecv``
on that dim's process group (the reference's ``ppermute``).  The classic
schedule runs M + S - 1 ticks for M microbatches (bubble fraction
(S-1)/(M+S-1)).  Forward only (serving / evaluating), as the reference's.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import ctx

__all__ = ["pipeline_forward", "pipeline_spec"]


def pipeline_spec(n_stages: int, n_micro: int):
    assert n_micro >= n_stages, "GPipe wants microbatches >= stages"
    return {"n_stages": n_stages, "n_micro": n_micro}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_forward(
    mesh,
    stage_fn: Callable,  # (stage_params, x) -> x
    stage_params,  # tree with leading dim = n_stages
    x: torch.Tensor,  # (n_micro, micro_batch, ...) activations, the same on every rank
    axis: str = "pipe",
) -> torch.Tensor:
    """Run x through all stages; returns activations after the last stage,
    on every rank.

    ``stage_params`` leaves are DTensors sharded over ``axis`` on their
    leading dim (each rank holds ONE stage's params) or plain tensors with
    every stage (each rank takes its own).  Tick t: the rank at stage s
    processes microbatch (t - s) if 0 <= t - s < M, then every rank sends
    its output to stage s + 1 (a ring; the last stage's send to stage 0 is
    ignored) and receives stage s - 1's.  After M + S - 1 ticks every
    microbatch passed every stage; the last stage's outputs reach every
    rank through one all-reduce of the buffer, zeros on the other stages
    (the reference's masked ``psum``)."""
    names = list(mesh.mesh_dim_names)
    n_stages = mesh.size(names.index(axis))
    s = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    params = _tree_map(lambda a: a.to_local()[0] if ctx.is_dtensor(a) else a[s], stage_params)
    m = x.shape[0]
    nxt = dist.get_global_rank(group, (s + 1) % n_stages)
    prev = dist.get_global_rank(group, (s - 1) % n_stages)
    buf = torch.zeros_like(x)  # outputs of the LAST stage per microbatch
    carry = torch.zeros_like(x[0])  # activation arriving at this stage
    for t in range(m + n_stages - 1):
        mb = t - s  # microbatch this stage works on at tick t
        active = 0 <= mb < m
        # stage 0 ingests fresh microbatches; others take the carry
        inp = x[min(t, m - 1)] if s == 0 else carry
        out = stage_fn(params, inp) if active else carry
        if s == n_stages - 1 and active:
            buf[mb] = out
        if n_stages > 1:
            recv = torch.empty_like(carry)
            ops = [dist.P2POp(dist.isend, out.contiguous(), nxt, group),
                   dist.P2POp(dist.irecv, recv, prev, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            carry = recv
    if s != n_stages - 1:
        buf.zero_()
    dist.all_reduce(buf, group=group)
    return buf
