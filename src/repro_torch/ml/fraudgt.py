"""FraudGT-style graph-transformer baseline (paper §8.5, Table 4/Fig 12),
on the card.

Each transaction edge is classified by a small transformer over its
*local temporal context*: the edge itself plus the nearest-in-time
transactions of its two endpoints, embedded by bucketized (amount, Δt,
role) features.  This is the port of the JAX package's
``repro.ml.fraudgt``: :meth:`FraudGT.tokenize` gives the reference's
tokens bit for bit, :meth:`FraudGT.fit` trains it by the reference's
rules (weighted BCE, AdamW, seeded permutations) and
:meth:`FraudGT.predict_proba` scores with it.  The transformer
(:mod:`repro_torch.models.layers`) runs on the card, every block's
attention through the hand-written CUDA ``flash_attention``, and in
training through its hand-written short-path backward as well.

Weights come from the seeded init (:meth:`FraudGT.init_params`), from
:meth:`FraudGT.fit`, or from a JAX model
(:func:`repro_torch.convert.fraudgt_from_reference`).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.registry import get_config
from repro_torch.device import DeviceLike, h2d, resolve_device, to_host
from repro_torch.distributed.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.graph.csr import TemporalGraph
from repro_torch.models import layers as L

__all__ = ["FraudGT", "FraudGTParams"]

N_AMOUNT = 16
N_DT = 16
N_ROLE = 5  # self, src-out, src-in, dst-out, dst-in
CHUNK = 1024  # edges scored per forward, as the reference's predict_proba
TOKENIZE_EDGES = 1 << 16  # edges tokenized per host pass
CANDIDATE_CAP = 1 << 22  # context candidates sorted per host pass


@dataclasses.dataclass(frozen=True)
class FraudGTParams:
    d_model: int = 128
    n_layers: int = 3
    n_heads: int = 8
    ctx: int = 17  # 1 self + 8 src-context + 8 dst-context
    lr: float = 3e-4
    batch: int = 256
    epochs: int = 3
    pos_weight: Optional[float] = None


class _Block(nn.Module):
    def __init__(self, p, cfg, backend, device):
        super().__init__()
        self.norm1 = L.RMSNorm(p["norm1"], device=device)
        self.attn = L.Attention(p["attn"], cfg, backend, device)
        self.norm2 = L.RMSNorm(p["norm2"], device=device)
        self.mlp = L.MLP(p["mlp"], device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _Net(nn.Module):
    """Embeddings, blocks, mean pool, head: the reference's ``_logits``."""

    def __init__(self, p, cfg, backend, device):
        super().__init__()
        self.emb_amount = L._param(p["emb_amount"], device)
        self.emb_dt = L._param(p["emb_dt"], device)
        self.emb_role = L._param(p["emb_role"], device)
        self.blocks = nn.ModuleList(_Block(b, cfg, backend, device) for b in p["blocks"])
        self.head = L._param(p["head"], device)
        self.bias = L._param(p["bias"], device)

    def forward(self, am, dt, ro):
        # index_select, not F.embedding: its gradient is an index_add_,
        # where embedding's backward on the card syncs the host
        emb = lambda w, i: w.index_select(0, i.reshape(-1)).reshape(*i.shape, w.shape[1])
        x = emb(self.emb_amount, am) + emb(self.emb_dt, dt) + emb(self.emb_role, ro)
        for blk in self.blocks:
            x = blk(x)
        return x.mean(dim=1) @ self.head + self.bias


def _search(key: np.ndarray, needles: np.ndarray, side: str) -> np.ndarray:
    """``np.searchsorted`` with the needles sorted first (several times
    faster on a large key array), answers in the needles' order."""
    order = np.argsort(needles)
    out = np.empty(len(needles), dtype=np.int64)
    out[order] = np.searchsorted(key, needles[order], side=side)
    return out


class _ContextIndex:
    """Per-graph arrays of the tokenizer, for the out-rows (side 0) and the
    in-rows (side 1): each time-sorted row as one ascending int64 key
    ``node * key_scale + t`` (searchsorted finds a time inside a row), and
    each edge's position in the id-sorted row, the reference's tie order."""

    def __init__(self, g: TemporalGraph):
        self.g = g
        self.sides = []
        rows = np.repeat(np.arange(g.n_nodes, dtype=np.int64), np.diff(g.out_indptr))
        in_rows = np.repeat(np.arange(g.n_nodes, dtype=np.int64), np.diff(g.in_indptr))
        for indptr, row, t_sorted, eid_t, eid_id in (
            (g.out_indptr, rows, g.out_t_sorted, g.out_eid_t, g.out_eid),
            (g.in_indptr, in_rows, g.in_t_sorted, g.in_eid_t, g.in_eid),
        ):
            key = row * g.key_scale + t_sorted
            id_pos = np.empty(g.n_edges, dtype=np.int64)
            id_pos[eid_id] = np.arange(g.n_edges, dtype=np.int64)
            self.sides.append((np.asarray(indptr, np.int64), key, np.asarray(t_sorted, np.int64),
                               np.asarray(eid_t, np.int64), id_pos))

    def ranges(self, side: int, nodes: np.ndarray, t: np.ndarray, k: int):
        """[lo, hi) of each query's candidates in the time-sorted row of
        ``nodes``: every entry whose |Δt| is at most the k-th smallest
        |Δt| of the row (the whole row when it has at most k entries), so
        ties at the k-th distance are all in."""
        indptr, key, t_sorted, _, _ = self.sides[side]
        s, e = indptr[nodes], indptr[nodes + 1]
        base = nodes.astype(np.int64) * self.g.key_scale
        p = _search(key, base + t, "left")  # first entry at t or later
        # the k nearest lie among the k entries on either side of p
        w = p[:, None] + np.arange(-k, k, dtype=np.int64)[None, :]
        inside = (w >= s[:, None]) & (w < e[:, None])
        dist = np.abs(t_sorted[np.clip(w, 0, len(key) - 1)] - t[:, None])
        dist = np.where(inside, dist, np.iinfo(np.int64).max)
        whole = e - s <= k
        kth = np.where(whole, 0, np.partition(dist, k - 1, axis=1)[:, k - 1])
        lo = np.maximum(_search(key, base + t - kth, "left"), s)
        hi = np.minimum(_search(key, base + t + kth, "right"), e)
        return np.where(whole, s, lo), np.where(whole, e, hi)


def _expand(lo: np.ndarray, hi: np.ndarray):
    """(query, position) of every position in the ranges [lo, hi)."""
    lens = hi - lo
    q = np.repeat(np.arange(len(lo), dtype=np.int64), lens)
    first = np.repeat(np.cumsum(lens) - lens, lens)
    return q, np.repeat(lo, lens) + (np.arange(len(q), dtype=np.int64) - first)


def _sort_order(q, dist, tie):
    """The order of the candidates by (query, |Δt|, tie), each triple
    distinct: one int64 sort where the three fit in 63 bits, else a
    three-key lexsort."""
    bq, bd, bt = (int(x.max()).bit_length() if len(x) else 0 for x in (q, dist, tie))
    if bq + bd + bt <= 63:
        return np.argsort((q << (bd + bt)) | (dist << bt) | tie)
    return np.lexsort((tie, dist, q))


class FraudGT:
    """The reference's FraudGT for inference, on ``device`` (the CUDA card
    unless named).  ``attn_backend`` is ``"kernel"`` (the CUDA
    ``flash_attention``) or ``"torch"`` (explicit-op attention)."""

    def __init__(
        self,
        p: FraudGTParams = FraudGTParams(),
        seed: int = 0,
        device: DeviceLike = None,
        attn_backend: str = "kernel",
    ):
        if attn_backend not in L.BACKENDS:
            raise ValueError(f"attn_backend {attn_backend!r}; options: {L.BACKENDS}")
        self.p = p
        self.seed = seed
        self.device = resolve_device(device)
        self.attn_backend = attn_backend
        self.cfg = dataclasses.replace(
            get_config("fraudgt-small"),
            d_model=p.d_model,
            n_layers=p.n_layers,
            n_heads=p.n_heads,
            n_kv_heads=p.n_heads,
            d_ff=4 * p.d_model,
            dtype="float32",
        )
        self.net: Optional[_Net] = None
        self.amount_edges: Optional[np.ndarray] = None
        self._index: Optional[_ContextIndex] = None
        self.seconds: dict = {}  # of the last predict_proba: tokenize, forward
        self.fit_seconds: dict = {}  # of the last fit: tokenize, train; its steps
        self.losses: Optional[torch.Tensor] = None  # each step's loss, on the device

    # ------------------------------------------------------------------
    def init_params(self) -> "FraudGT":
        """Seeded weights with the shapes and scales of the reference's
        ``_init``, drawn on the CPU so that every device gets the same."""
        d = self.p.d_model
        gen = torch.Generator().manual_seed(self.seed)
        blocks = [
            {
                "norm1": L.rms_norm_init(d),
                "attn": L.attn_init(gen, self.cfg),
                "norm2": L.rms_norm_init(d),
                "mlp": L.mlp_init(gen, d, self.cfg.d_ff),
            }
            for _ in range(self.p.n_layers)
        ]
        return self.load_params(
            {
                "emb_amount": torch.randn((N_AMOUNT, d), generator=gen) * 0.02,
                "emb_dt": torch.randn((N_DT, d), generator=gen) * 0.02,
                "emb_role": torch.randn((N_ROLE, d), generator=gen) * 0.02,
                "blocks": blocks,
                "head": torch.randn((d,), generator=gen) / math.sqrt(d),
                "bias": torch.zeros(()),
            }
        )

    def load_params(self, params) -> "FraudGT":
        """Weights from a dict of the reference's layout (arrays or
        tensors), uploaded without a host sync."""
        self.net = _Net(params, self.cfg, self.attn_backend, self.device)
        return self

    # ------------------------------------------------------------------
    def tokenize(self, g: TemporalGraph, eids: np.ndarray) -> Tuple[np.ndarray, ...]:
        """(B, ctx) int32 feature ids: amount-bucket, Δt-bucket, role.

        Token 0 is the edge itself; tokens 1..k (k = (ctx - 1) // 2) are
        the k entries of the source's out- and in-rows nearest to the
        edge's time, tokens k+1..2k those of the destination's, in the
        reference's order: by |Δt|, then out-row before in-row, then the
        id-sorted row's order (neighbour, time, edge id).  Unfilled slots
        stay (0, 0, 0).  Vectorized on the host; each edge costs its
        candidates (the k nearest plus ties), not its endpoints' degrees."""
        if self.amount_edges is None:
            qs = np.quantile(g.amount, np.linspace(0, 1, N_AMOUNT + 1)[1:-1])
            self.amount_edges = qs
        ctx = self.p.ctx
        k = (ctx - 1) // 2
        eids = np.asarray(eids, dtype=np.int64)
        b = len(eids)
        am = np.zeros((b, ctx), dtype=np.int32)
        dt = np.zeros((b, ctx), dtype=np.int32)
        ro = np.zeros((b, ctx), dtype=np.int32)
        if b:
            am[:, 0] = self._bucket_amount(g.amount[eids])
        if k == 0 or b == 0:
            return am, dt, ro
        if self._index is None or self._index.g is not g:
            self._index = _ContextIndex(g)
        for c0 in range(0, b, TOKENIZE_EDGES):
            e = eids[c0 : c0 + TOKENIZE_EDGES]
            t = g.t[e].astype(np.int64)
            for nodes, roles, col0 in ((g.src[e], (1, 2), 1), (g.dst[e], (3, 4), 1 + k)):
                self._fill(g, c0, nodes.astype(np.int64), t, roles, col0, k, am, dt, ro)
        return am, dt, ro

    def _bucket_amount(self, a):
        return np.searchsorted(self.amount_edges, a).astype(np.int32)

    def _fill(self, g, row0, nodes, t, roles, col0, k, am, dt, ro):
        """Write the k context tokens of one endpoint for each query."""
        ranges = [self._index.ranges(side, nodes, t, k) for side in (0, 1)]
        per_query = sum(hi - lo for lo, hi in ranges)
        # cut the queries into groups of at most CANDIDATE_CAP candidates
        ends = np.cumsum(per_query)
        starts = [0]
        while starts[-1] < len(nodes):
            done = ends[starts[-1] - 1] if starts[-1] else 0
            nxt = int(np.searchsorted(ends, done + CANDIDATE_CAP, side="right"))
            starts.append(max(nxt, starts[-1] + 1))
        for q0, q1 in zip(starts[:-1], starts[1:]):
            parts = []
            for side, (lo, hi) in enumerate(ranges):
                _, _, t_sorted, eid_t, id_pos = self._index.sides[side]
                q, pos = _expand(lo[q0:q1], hi[q0:q1])
                eid = eid_t[pos]
                parts.append((q, eid, np.abs(t_sorted[pos] - t[q0 + q]), side * g.n_edges + id_pos[eid], side))
            q = np.concatenate([x[0] for x in parts])
            eid = np.concatenate([x[1] for x in parts])
            dist = np.concatenate([x[2] for x in parts])
            tie = np.concatenate([x[3] for x in parts])
            side = np.concatenate([np.full(len(x[0]), x[4], dtype=np.int8) for x in parts])
            order = _sort_order(q, dist, tie)
            q, eid, dist, side = q[order], eid[order], dist[order], side[order]
            n = np.arange(len(q))
            first = np.maximum.accumulate(np.where(np.r_[True, q[1:] != q[:-1]], n, 0))
            rank = n - first
            keep = rank < k
            rows = row0 + q0 + q[keep]
            cols = col0 + rank[keep]
            am[rows, cols] = self._bucket_amount(g.amount[eid[keep]])
            dt[rows, cols] = np.clip(np.log2(dist[keep].astype(np.float64) + 1.0), 0, N_DT - 1).astype(np.int32)
            ro[rows, cols] = np.asarray(roles, dtype=np.int32)[side[keep]]

    # ------------------------------------------------------------------
    def logits(self, am, dt, ro) -> torch.Tensor:
        """(B,) float32 logits on the device, scored CHUNK edges at a time."""
        if self.net is None:
            self.init_params()
        toks = [h2d(np.asarray(a, dtype=np.int32), self.device) for a in (am, dt, ro)]
        n = toks[0].shape[0]
        with torch.inference_mode():
            out = torch.empty(n, dtype=torch.float32, device=self.device)
            for s in range(0, n, CHUNK):
                out[s : s + CHUNK] = self.net(*(x[s : s + CHUNK] for x in toks))
        return out

    def fit(self, g: TemporalGraph, labels: np.ndarray, train_ids: np.ndarray) -> "FraudGT":
        """Train on the edges ``train_ids`` by the reference's rules: the
        positive class weighted by ``p.pos_weight`` or by negatives over
        positives, the weighted BCE ``softplus(logit) - y * logit``
        averaged over a batch, ``p.epochs`` passes in the orders of
        ``np.random.default_rng(0)`` permutations with the trailing
        partial batch dropped, and AdamW (``lr=p.lr``,
        ``weight_decay=0.01``) over every weight.

        The tokens and labels go to the device once, and each batch is
        indexed there; a step makes no host sync (each step's loss stays
        on the device, in ``self.losses``).  The weights are updated in
        place."""
        if self.net is None:
            self.init_params()
        p = self.p
        t0 = time.perf_counter()
        pos = float(labels[train_ids].sum())
        pw = p.pos_weight or (len(train_ids) - pos) / max(pos, 1.0)
        am, dt, ro = self.tokenize(g, train_ids)
        y = labels[train_ids].astype(np.float32)
        t1 = time.perf_counter()
        dev = self.device
        toks = [h2d(np.asarray(a, dtype=np.int32), dev) for a in (am, dt, ro)]
        y_dev = h2d(y, dev)
        params = dict(self.net.named_parameters())
        names = list(params)
        weights = [params[k] for k in names]
        opt = adamw_init(params)
        ocfg = AdamWConfig(lr=p.lr, weight_decay=0.01)
        rng = np.random.default_rng(0)
        n = len(train_ids)
        losses = []
        for _ in range(p.epochs):
            order = h2d(rng.permutation(n), dev)
            for s in range(0, n - p.batch + 1, p.batch):
                idx = order[s : s + p.batch]
                yb = y_dev.index_select(0, idx)
                logit = self.net(*(x.index_select(0, idx) for x in toks))
                w = torch.where(yb > 0.5, pw, 1.0)
                loss = torch.mean(w * (F.softplus(logit) - yb * logit))  # BCE with logits
                grads = torch.autograd.grad(loss, weights)
                new, opt, _ = adamw_update(params, dict(zip(names, grads)), opt, ocfg)
                with torch.no_grad():
                    torch._foreach_copy_(weights, [new[k] for k in names])
                losses.append(loss.detach())
        self.losses = torch.stack(losses) if losses else torch.zeros(0, device=dev)
        self.fit_seconds = {"tokenize": t1 - t0, "train": time.perf_counter() - t1, "steps": len(losses)}
        return self

    def predict_proba(self, g: TemporalGraph, eids: np.ndarray) -> np.ndarray:
        """(B,) float32 probabilities; the one host copy is at the end."""
        t0 = time.perf_counter()
        am, dt, ro = self.tokenize(g, eids)
        t1 = time.perf_counter()
        with torch.inference_mode():
            proba = to_host(torch.sigmoid(self.logits(am, dt, ro)))
        self.seconds = {"tokenize": t1 - t0, "forward": time.perf_counter() - t1}
        return proba
