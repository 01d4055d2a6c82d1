"""Composable decoder-only LM over the block zoo: the JAX package's
``repro.models.model``.

Parameters keep the reference's tree, with the per-unit leaves stacked
on a leading ``n_units`` axis as the reference's ``vmap``ped init stacks
them, so carrying weights across is a copy (:mod:`repro_torch.convert`).
The stack is a Python loop over the units (the reference's
``unroll_stack`` branch; its ``lax.scan`` has no counterpart that the
port needs).  Zamba2's shared block lives outside ``units`` and is used
by every unit.  Weights are float32 masters; activations run in
``cfg.dtype`` and every weight is cast to it where it is used, as the
reference's ``.astype(x.dtype)`` (the embedding rows are gathered before
their cast, which gives the same values as casting the table first).

Heads:
* token LMs: tied or untied (V, d) embed + (d, V) head,
* musicgen: the EnCodec frontend is a STUB — inputs are precomputed frame
  embeddings (B, T, d); output heads are per-codebook (K, d, V),
* chameleon: early fusion means VQ image tokens are ordinary vocab ids —
  the VQ tokenizer is the stub frontend.

Out-of-range ids are clipped as the reference's gathers clip them: a
negative token id counts from the end of the table, then ids are clamped
into it; a label outside [0, V) has gold logit 0 in ``_ce``.

``forward``, ``loss_fn`` and :class:`LM` take ``attn_backend`` ("kernel":
the CUDA ``flash_attention``, the plain version on the CPU; "torch": the
reference's ``_sdpa`` in torch ops).  ``decode_step`` runs torch ops on
either, and updates the cache in place.  Entry points run on the CUDA
card unless given ``device="cpu"``.

On a mesh the same functions take DTensors placed by
:mod:`repro_torch.distributed.sharding` (:mod:`repro_torch.models.layers`
says how the layers run on them): a vocab-sharded embedding is gathered,
and the gold logit read from vocab-sharded logits, on each rank's slice
through ``local_map`` with one all-reduce, never gathering the table.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import ctx, opts
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

__all__ = [
    "LM",
    "build_model",
    "init_params",
    "param_specs",
    "n_params",
    "forward",
    "loss_fn",
    "cache_init",
    "cache_specs",
    "decode_step",
    "batch_specs",
]

CE_CHUNK = 512


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of ``rest``, same layout)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _unit(tree, i: int):
    """Unit ``i`` of a stacked tree: views, no copy."""
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _init(cfg: ModelConfig, gen: Optional[torch.Generator]) -> Dict[str, Any]:
    """The reference's tree drawn from ``gen`` on its device, or built on
    ``meta`` with nothing drawn when ``gen`` is None.  Each unit is drawn
    alone and copied into its slot of the stacked leaves."""
    d, v = cfg.d_model, cfg.vocab
    params: Dict[str, Any] = {}
    if not cfg.precomputed_embeddings:
        params["embed"] = L._dense(gen, (v, d), scale=0.02)
    units = None
    for i in range(cfg.n_units):
        unit = {f"b{j}": B.block_init(gen, bt, cfg) for j, bt in enumerate(cfg.unit) if bt != "shared_attn"}
        if units is None:
            units = tree_map(lambda a: torch.empty((cfg.n_units,) + a.shape, dtype=a.dtype, device=a.device), unit)
        if gen is not None:
            tree_map(lambda dst, src: dst[i].copy_(src), units, unit)
    params["units"] = units
    if "shared_attn" in cfg.unit:
        params["shared"] = B.block_init(gen, "shared_attn", cfg)
    params["final_norm"] = L.rms_norm_init(d, L._device(gen))
    if cfg.n_codebooks > 0:
        params["heads"] = L._dense(gen, (cfg.n_codebooks, d, v), scale=1.0 / math.sqrt(d))
    elif not cfg.tie_embeddings:
        params["lm_head"] = L._dense(gen, (d, v), scale=1.0 / math.sqrt(d))
    return params


def init_params(cfg: ModelConfig, gen: Union[int, torch.Generator], device: DeviceLike = None) -> Dict[str, Any]:
    """Float32 weights in the reference's tree on ``device`` (the CUDA card
    by default), drawn from ``gen``: a seed, or a :class:`torch.Generator`
    on that device.  The draws are not the reference's (``jax.random``);
    carry the reference's weights with ``convert.lm_params_from_reference``."""
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    elif gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the weights go to {dev}")
    return _init(cfg, gen)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree on ``meta``: shapes and dtypes, no allocation."""
    return _init(cfg, None)


def n_params(cfg: ModelConfig) -> int:
    return sum(a.numel() for a in tree_leaves(param_specs(cfg)))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _take_rows(table, ids):
    """``table[ids]`` with the reference's gather semantics: a negative id
    counts from the end, then ids are clamped into the table."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    if _vocab_dims(table, 0):
        return _take_rows_sharded(table, ids)
    # index_select, not indexing or F.embedding: its gradient is an
    # index_add_, which does not sync the host on the card
    return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[1])


def _vocab_dims(t, dim: int):
    """The mesh dims that shard dim ``dim`` of a DTensor (none for a plain
    tensor): a vocab-sharded embedding's rows, a head's logits."""
    if not ctx.is_dtensor(t):
        return []
    dim = dim % t.ndim
    return [i for i, pl in enumerate(t.placements) if pl.is_shard(dim)]


def _vocab_local(table, dim: int, ids, body):
    """``body(local table, local ids, first vocab entry held)`` on each
    rank through ``local_map``, for a DTensor ``table`` whose dim ``dim``
    is sharded: the table keeps its placements, the ids are replicated
    over the vocab-sharding mesh dims and keep their other placements,
    and the output (of the ids' leading shape) is Partial, a sum, over
    those dims: each rank contributes what it holds, zeros elsewhere.  The
    table's gradient is Partial over the mesh dims that shard the ids but
    not the table (each rank saw its own ids).  Returns the mapped
    function and the output's reduced placements."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    vdims = _vocab_dims(table, dim)
    lo = ctx.mesh_coordinate(mesh, vdims) * table.to_local().shape[dim % table.ndim]
    ids_pl = [Replicate() if i in vdims else pl for i, pl in enumerate(ids.placements)]
    out_pl = [Partial() if i in vdims else pl for i, pl in enumerate(ids_pl)]
    grad_pl = [Partial() if pl.is_replicate() and q.is_shard() else pl for pl, q in zip(table.placements, ids_pl)]
    fn = local_map(lambda t, i: body(t, i, lo), out_placements=out_pl, in_placements=(table.placements, ids_pl),
                   in_grad_placements=(grad_pl, ids_pl), device_mesh=mesh, redistribute_inputs=True)
    return fn, ids_pl


def _take_rows_sharded(table, ids):
    """The gather from a vocab-sharded table (a DTensor, rows sharded over
    the model axis): each rank takes the ids that fall in its rows, the
    rest are zero rows, and one all-reduce over those mesh dims sums the
    ranks' rows (a rank never gathers the table)."""
    def body(t, i, lo):
        local = i - lo
        mine = (local >= 0) & (local < t.shape[0])
        rows = t.index_select(0, torch.where(mine, local, 0).reshape(-1)).reshape(*i.shape, t.shape[1])
        return rows * mine[..., None].to(rows.dtype)

    fn, ids_pl = _vocab_local(table, 0, ids, body)
    return fn(table, ids).redistribute(table.device_mesh, ids_pl)


def _embed(params, batch, cfg: ModelConfig):
    dt = _dtype(cfg)
    if cfg.precomputed_embeddings:
        return batch["embeds"].to(dt)
    return _take_rows(params["embed"], batch["tokens"]).to(dt)


def _stack_apply(params, x, cfg: ModelConfig, remat: bool = False, attn_backend: str = "kernel"):
    shared = params.get("shared")

    def unit_fn(h, aux, unit_p):
        for j, bt in enumerate(cfg.unit):
            p = shared if bt == "shared_attn" else unit_p[f"b{j}"]
            h, a = B.block_apply(p, bt, h, cfg, attn_backend)
            aux = aux + a
        return h, aux

    aux = ctx.replicate_like(x, torch.zeros((), dtype=torch.float32, device=x.device))
    # each stacked leaf split once: under autograd its gradient is then one
    # stack of the units' gradients, where a view a[i] per unit would add
    # n_units zero-padded copies of the whole stacked leaf
    units = tree_map(lambda a: a.unbind(0), params["units"])
    for i in range(cfg.n_units):
        unit_p = tree_map(lambda parts: parts[i], units)
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(unit_fn, x, aux, unit_p, use_reentrant=False)
        else:
            x, aux = unit_fn(x, aux, unit_p)
    return x, aux


def _head(params, x, cfg: ModelConfig):
    # on a mesh the residual stream may be a partial sum over model (DTensor
    # keeps a sum partial through linear ops): reduce it here, so that the
    # product with a vocab-sharded head gives vocab-sharded logits
    h = ctx.hint(x, ("data",)).float()
    var = h.square().mean(dim=-1, keepdim=True)
    h = (h * torch.rsqrt(var + cfg.norm_eps) * params["final_norm"]["scale"]).to(x.dtype)
    if cfg.n_codebooks > 0:
        return torch.einsum("btd,kdv->btkv", h, params["heads"].to(x.dtype))
    w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"]).to(x.dtype)
    return h @ w


def forward(params, batch, cfg: ModelConfig, remat: bool = False, attn_backend: str = "kernel"):
    """batch: {"tokens": (B,T) int} or {"embeds": (B,T,d)} (audio stub).
    Returns (logits, aux)."""
    x, aux = _stack_apply(params, _embed(params, batch, cfg), cfg, remat, attn_backend)
    return _head(params, x, cfg), aux


def _ce(logits, labels):
    """Summed cross-entropy in float32; a label outside [0, V) has gold
    logit 0, as the reference's one-hot reduction gives it."""
    v = logits.shape[-1]
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    labels = labels.long()
    if _vocab_dims(logits, -1):
        return (logz - _gold_sharded(logits, labels)).sum()
    gold = logits.gather(-1, labels.clamp(0, v - 1)[..., None])[..., 0]
    gold = torch.where((labels >= 0) & (labels < v), gold, 0.0)
    return (logz - gold).sum()


def _gold_sharded(logits, labels):
    """The gold logit from vocab-sharded logits (a DTensor): each rank
    reads the labels that fall in its vocab slice, and an all-reduce over
    the vocab-sharding mesh dims sums them (a label outside [0, V) is in
    no rank's slice: gold 0, as in :func:`_ce`)."""
    def body(lg, lab, lo):
        local = lab - lo
        mine = (local >= 0) & (local < lg.shape[-1])
        gold = lg.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
        return torch.where(mine, gold, 0.0)

    fn, lab_pl = _vocab_local(logits, -1, labels, body)
    return fn(logits, labels).redistribute(logits.device_mesh, lab_pl)


def loss_fn(params, batch, cfg: ModelConfig, remat: bool = True, attn_backend: str = "kernel"):
    """Mean token cross-entropy plus the MoE aux loss.  Under the
    ``chunked_ce`` opt (on by default) with (B, T) labels the logits are
    made CE_CHUNK time steps at a time and never whole; ``remat`` with
    autograd on recomputes each unit (and each chunk) in the backward."""
    labels = batch["labels"]
    if opts.enabled("chunked_ce") and labels.dim() == 2:
        h, aux = _stack_apply(params, _embed(params, batch, cfg), cfg, remat, attn_backend)
        b, t, d = h.shape
        tc = min(CE_CHUNK, t)
        nt = t // tc
        hc = h.reshape(b, nt, tc, d)
        lc = labels.reshape(b, nt, tc)

        def chunk(h_c, l_c):
            return _ce(_head(params, h_c, cfg), l_c)

        tot = ctx.replicate_like(h, torch.zeros((), dtype=torch.float32, device=h.device))
        for c in range(nt):
            if remat and torch.is_grad_enabled():
                tot = tot + checkpoint(chunk, hc[:, c], lc[:, c], use_reentrant=False)
            else:
                tot = tot + chunk(hc[:, c], lc[:, c])
        return tot / (b * t) + aux
    logits, aux = forward(params, batch, cfg, remat, attn_backend)
    return _ce(logits, labels) / labels.numel() + aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _cache_init(cfg: ModelConfig, batch: int, cache_len: int, device) -> Dict[str, Any]:
    dt = _dtype(cfg)
    stack = lambda a: a.unsqueeze(0).repeat((cfg.n_units,) + (1,) * a.dim())
    return {
        f"b{j}": tree_map(stack, B.block_cache_init(bt, cfg, batch, cache_len, dt, device))
        for j, bt in enumerate(cfg.unit)
    }


def cache_init(cfg: ModelConfig, batch: int, cache_len: int, device: DeviceLike = None) -> Dict[str, Any]:
    """Per-block caches stacked over the units (the shared block keeps one
    per unit), on ``device`` (the CUDA card by default)."""
    return _cache_init(cfg, batch, cache_len, resolve_device(device))


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, Any]:
    """The cache tree on ``meta``: shapes and dtypes, no allocation."""
    return _cache_init(cfg, batch, cache_len, torch.device("meta"))


def decode_step(params, cache, batch, cfg: ModelConfig):
    """One token for every sequence. batch: {"tokens": (B,1)} or
    {"embeds": (B,1,d)}.  Returns (logits, cache): unlike the reference,
    which returns a new cache, the cache's tensors are updated in place
    and the same tree is returned."""
    x = _embed(params, batch, cfg)
    shared = params.get("shared")
    for i in range(cfg.n_units):
        unit_p = _unit(params["units"], i)
        for j, bt in enumerate(cfg.unit):
            p = shared if bt == "shared_attn" else unit_p[f"b{j}"]
            c = _unit(cache[f"b{j}"], i)
            x, new = B.block_decode(p, bt, x, cfg, c)
            for k, a in new.items():
                if a is not c[k]:
                    c[k].copy_(a)
    return _head(params, x, cfg), cache


# ---------------------------------------------------------------------------
# batch specs (the modality frontend stubs live here)
# ---------------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int, kind: str):
    """The inputs of a train, prefill or decode step as ``meta`` tensors."""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    i32, dt = torch.int32, _dtype(cfg)
    if kind in ("train", "prefill"):
        if cfg.precomputed_embeddings:  # musicgen: EnCodec frame stub
            return {"embeds": meta((global_batch, seq_len, cfg.d_model), dt),
                    "labels": meta((global_batch, seq_len, cfg.n_codebooks), i32)}
        return {"tokens": meta((global_batch, seq_len), i32), "labels": meta((global_batch, seq_len), i32)}
    # decode: one new token against a cache of length seq_len
    if cfg.precomputed_embeddings:
        return {"embeds": meta((global_batch, 1, cfg.d_model), dt)}
    return {"tokens": meta((global_batch, 1), i32)}


# ---------------------------------------------------------------------------
# the model as a module
# ---------------------------------------------------------------------------
class _Tree(nn.Module):
    """A nested parameter dict as nested modules (names are the tree's)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._keys = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, v if isinstance(v, nn.Parameter) else nn.Parameter(v))

    def tree(self) -> Dict[str, Any]:
        """The nested dict, keys in the order of the tree it was made from."""
        return {k: self._modules[k].tree() if k in self._modules else self._parameters[k] for k in self._keys}


class LM(nn.Module):
    """The LM over the functional core, its tree held as parameters on
    ``device`` (the CUDA card by default): drawn from ``seed`` with
    :func:`init_params`, or ``params`` (moved to ``device``)."""

    def __init__(self, cfg: ModelConfig, params: Optional[Dict[str, Any]] = None, *, seed: int = 0,
                 device: DeviceLike = None, attn_backend: str = "kernel"):
        super().__init__()
        if attn_backend not in L.BACKENDS:
            raise ValueError(f"attention backend {attn_backend!r}; options: {L.BACKENDS}")
        dev = resolve_device(device)
        params = init_params(cfg, seed, device=dev) if params is None else tree_map(lambda a: a.to(dev), params)
        self.cfg, self.attn_backend, self.device = cfg, attn_backend, dev
        self.params = _Tree(params)

    def tree(self) -> Dict[str, Any]:
        return self.params.tree()

    def forward(self, batch, remat: bool = False):
        return forward(self.tree(), batch, self.cfg, remat, self.attn_backend)

    def loss(self, batch):
        return loss_fn(self.tree(), batch, self.cfg, attn_backend=self.attn_backend)

    def decode(self, cache, batch):
        return decode_step(self.tree(), cache, batch, self.cfg)

    def cache(self, batch: int, cache_len: int):
        return cache_init(self.cfg, batch, cache_len, device=self.device)


def build_model(cfg: ModelConfig, **kw) -> LM:
    return LM(cfg, **kw)
