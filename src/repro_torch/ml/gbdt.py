"""Histogram gradient-boosted trees in PyTorch (the paper's XGBoost stage).

The port of the JAX package's ``repro.ml.gbdt``, with the same
second-order objective as XGBoost [Chen & Guestrin 2016]: binary logistic
loss, per-leaf weight ``-G/(H+lambda)``, split gain
``1/2 [GL^2/(HL+l) + GR^2/(HR+l) - G^2/(H+l)] - gamma``, quantile-sketch
binning (256 bins, uint8 storage), level-wise growth, class imbalance via
``scale_pos_weight``.

Binning is host numpy, a copy of the reference's, so the bins are
bit-identical.  Everything after it runs on the classifier's ``device``
(the CUDA card by default; the CPU only when asked).  Every histogram is
one call of the hand-written CUDA kernel ``hist_update`` on the card,
whose fixed-point sums make a fit deterministic, and of its plain version
on the CPU: one per tree level over fused ``(node, feature, bin)`` keys
(:func:`repro_torch.kernels.hist_update.hist_update_rows`), and the leaf
sums (:func:`repro_torch.kernels.hist_update.hist_update`).  A fit
copies from the card to the host once, the finished trees, through
:func:`repro_torch.device.to_host`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import h2d, resolve_device, to_host
from repro_torch.kernels.hist_update import ops as hu_ops

__all__ = ["GBDTParams", "GBDTClassifier", "first_split_difference"]


@dataclasses.dataclass(frozen=True)
class GBDTParams:
    n_trees: int = 60
    max_depth: int = 6
    learning_rate: float = 0.2
    reg_lambda: float = 1.0
    gamma: float = 0.0
    min_child_weight: float = 1e-3
    n_bins: int = 256
    scale_pos_weight: Optional[float] = None  # None -> auto (neg/pos)
    base_score: float = 0.5


def _quantile_bins(x: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature quantile sketch -> bin edges (n_features, n_bins-1)."""
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.quantile(x, qs, axis=0).T.astype(np.float32)  # (F, B-1)


def _apply_bins(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    out = np.empty(x.shape, dtype=np.uint8)
    for f in range(x.shape[1]):
        out[:, f] = np.searchsorted(edges[f], x[:, f], side="left")
    return out


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the reference feeds its scalars to its
    float32 arithmetic."""
    return float(np.float32(v))


def _histograms(xb, gh, node, n_nodes: int, n_bins: int):
    """(N,F) uint8 bins, (N,2) grad/hess, (N,) int32 node ->
    (nodes,F,bins,2): one ``hist_update_rows`` call, which reads each row
    once (the reference, ``gbdt.py:54-67``, builds (N, F) keys and repeats
    gh F times; the plain version on the CPU still does)."""
    return hu_ops.hist_update_rows(xb, node, gh, n_nodes, n_bins)


# the block length of the reference's cumsum on the CPU (see _prefix_sum)
_SCAN_BLOCK = 16


def _prefix_sum(x):
    """Inclusive float32 prefix sum over the last axis, added in the order
    of the reference's ``jnp.cumsum`` on the CPU, so that split gains are
    bit-identical to the reference's there (an ulp of difference flips
    near-tie splits): XLA rewrites the cumsum into sequential sums within
    blocks of 16, a prefix sum of the block totals (the same rule,
    recursively), and one add of each block's carry.  ``torch.cumsum``
    adds in float64 on the CPU and in a parallel order on the card."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = x.clone()
        for j in range(1, n):
            out[..., j] = out[..., j - 1] + x[..., j]
        return out
    nb = -(-n // _SCAN_BLOCK)
    lead = x.shape[:-1]
    blocks = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    inner = _prefix_sum(blocks.reshape(lead + (nb, _SCAN_BLOCK)))
    carry = torch.nn.functional.pad(_prefix_sum(inner[..., -1])[..., :-1], (1, 0))
    return (inner + carry[..., None]).reshape(lead + (nb * _SCAN_BLOCK,))[..., :n]


def _best_splits(hist, reg_lambda: float, gamma: float, min_child_weight: float, n_bins: int):
    """hist (nodes,F,B,2) -> (feature, bin, gain) of each node's best split."""
    cum = _prefix_sum(hist.transpose(-1, -2))  # (nodes, F, 2, B)
    gl = cum[..., 0, :]
    hl = cum[..., 1, :]
    gt = gl[..., -1:]
    ht = hl[..., -1:]
    gr = gt - gl
    hr = ht - hl

    def score(G, H):
        return G * G / (H + reg_lambda)

    gain = 0.5 * (score(gl, hl) + score(gr, hr) - score(gt, ht)) - gamma
    valid = (hl >= min_child_weight) & (hr >= min_child_weight)
    # splitting at the last bin sends everything left: forbid
    valid = valid & (torch.arange(n_bins, device=hist.device) < n_bins - 1)
    gain = torch.where(valid, gain, float("-inf"))
    flat = gain.reshape(gain.shape[0], -1)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    feat = (best // n_bins).to(torch.int32)
    binn = (best % n_bins).to(torch.int32)
    return feat, binn, best_gain


class GBDTClassifier:
    """Level-wise histogram GBDT; API mirrors the XGB usage in the paper.

    ``device`` places the fit and the predictions: ``None`` means the CUDA
    card and raises when there is none; ``device="cpu"`` runs the plain
    PyTorch path.  After a fit, ``fit_seconds`` splits its wall time into
    ``"binning"`` (host numpy) and ``"rounds"`` (the boosting rounds up to
    the trees' arrival on the host).
    """

    def __init__(self, params: GBDTParams = GBDTParams(), device=None):
        self.p = params
        self.device = resolve_device(device)
        self.edges: Optional[np.ndarray] = None
        # per tree: (feat per level, bin per level, leaf (2^depth,))
        self.trees: list = []
        # per fitted tree: the best split's gain at every internal node,
        # levels concatenated (-inf where no split was valid)
        self.gains: list = []
        self.base_margin: float = 0.0
        self.fit_seconds: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _build_tree(self, xb, grad, hess):
        """One tree on the device: (feat, bin, gain) of every internal node,
        the levels concatenated (2^depth - 1 each), and the 2^depth
        leaves."""
        p = self.p
        lam = _f32(p.reg_lambda)
        node = torch.zeros(xb.shape[0], dtype=torch.int32, device=xb.device)
        feats: List[torch.Tensor] = []
        bins: List[torch.Tensor] = []
        gains: List[torch.Tensor] = []
        gh = torch.stack([grad, hess], dim=1)
        for level in range(p.max_depth):
            hist = _histograms(xb, gh, node, 1 << level, p.n_bins)
            feat, binn, gain = _best_splits(
                hist, lam, _f32(p.gamma), _f32(p.min_child_weight), p.n_bins
            )
            # nodes with no positive gain become pass-through (split at
            # bin = n_bins-1 keeps all samples on the left child)
            dead = gain <= 0.0
            feat = torch.where(dead, 0, feat)
            binn = torch.where(dead, p.n_bins - 1, binn)
            feats.append(feat)
            bins.append(binn)
            gains.append(gain)
            fx = xb.gather(1, feat[node][:, None].long())[:, 0]
            node = node * 2 + (fx > binn[node]).to(torch.int32)
        leaf_gh = hu_ops.hist_update(node, gh, 1 << p.max_depth)
        leaf = -leaf_gh[:, 0] / (leaf_gh[:, 1] + lam) * _f32(p.learning_rate)
        return torch.cat(feats), torch.cat(bins), torch.cat(gains), leaf

    def _tree_margin(self, xb, feat, binn, leaf):
        node = torch.zeros(xb.shape[0], dtype=torch.int32, device=xb.device)
        for level in range(self.p.max_depth):
            at = node + ((1 << level) - 1)
            fx = xb.gather(1, feat[at][:, None].long())[:, 0]
            node = node * 2 + (fx > binn[at]).to(torch.int32)
        return leaf[node]

    def _margin(self, xb):
        """Base margin plus every tree's leaf values, on the device."""
        margin = torch.full(
            (xb.shape[0],), _f32(self.base_margin), dtype=torch.float32, device=xb.device
        )
        if not self.trees:
            return margin
        feat = h2d(np.stack([np.concatenate(t[0]) for t in self.trees]).astype(np.int32), self.device)
        binn = h2d(np.stack([np.concatenate(t[1]) for t in self.trees]).astype(np.int32), self.device)
        leaf = h2d(np.stack([t[2] for t in self.trees]).astype(np.float32), self.device)
        for i in range(len(self.trees)):
            margin = margin + self._tree_margin(xb, feat[i], binn[i], leaf[i])
        return margin

    # ------------------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray, verbose: bool = False):
        p = self.p
        t0 = time.perf_counter()
        x = np.asarray(x, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        self.edges = _quantile_bins(x, p.n_bins)
        xb_host = _apply_bins(x, self.edges)
        t1 = time.perf_counter()
        xb = h2d(xb_host, self.device)
        yj = h2d(y, self.device)
        spw = p.scale_pos_weight
        if spw is None:
            pos = float(y.sum())
            spw = (len(y) - pos) / max(pos, 1.0)
        w = torch.where(yj > 0.5, torch.full_like(yj, _f32(spw)), torch.ones_like(yj))
        self.base_margin = _logit(p.base_score)
        margin = torch.full(
            (x.shape[0],), _f32(self.base_margin), dtype=torch.float32, device=self.device
        )
        grown = []
        for it in range(p.n_trees):
            prob = torch.sigmoid(margin)
            grad = w * (prob - yj)
            hess = w * prob * (1.0 - prob)
            feat, binn, gain, leaf = self._build_tree(xb, grad, hess)
            grown.append((feat, binn, gain, leaf))
            margin = margin + self._tree_margin(xb, feat, binn, leaf)
            if verbose and (it % 10 == 0 or it == p.n_trees - 1):
                loss = -torch.mean(
                    w * (yj * torch.log(prob + 1e-9) + (1 - yj) * torch.log(1 - prob + 1e-9))
                )
                print(f"  [gbdt] iter {it:3d} loss {float(to_host(loss)):.5f}")
        self.trees, self.gains = self._to_host_trees(grown)
        self.fit_seconds = {"binning": t1 - t0, "rounds": time.perf_counter() - t1}
        return self

    def _to_host_trees(self, grown):
        """The fit's one device->host copy: every tree's int32 (feat, bin)
        and its float32 gains and leaves (carried as their bits) in one
        tensor.  Returns (trees, gains)."""
        if not grown:
            return [], []
        packed = torch.stack(
            [
                torch.cat([f, b, gain.view(torch.int32), leaf.view(torch.int32)])
                for f, b, gain, leaf in grown
            ]
        )
        host = to_host(packed)
        n_int = (1 << self.p.max_depth) - 1
        cuts = [(1 << lv) - 1 for lv in range(self.p.max_depth + 1)]
        trees, gains = [], []
        for row in host:
            f, b = row[:n_int], row[n_int : 2 * n_int]
            gains.append(row[2 * n_int : 3 * n_int].view(np.float32).copy())
            leaf = row[3 * n_int :]
            trees.append(
                (
                    [f[cuts[lv] : cuts[lv + 1]].copy() for lv in range(self.p.max_depth)],
                    [b[cuts[lv] : cuts[lv + 1]].copy() for lv in range(self.p.max_depth)],
                    leaf.view(np.float32).copy(),
                )
            )
        return trees, gains

    def predict_margin(self, x: np.ndarray) -> np.ndarray:
        xb = h2d(_apply_bins(np.asarray(x, np.float32), self.edges), self.device)
        return to_host(self._margin(xb))

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        xb = h2d(_apply_bins(np.asarray(x, np.float32), self.edges), self.device)
        return to_host(torch.sigmoid(self._margin(xb)))

    def predict(self, x: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        return (self.predict_proba(x) >= threshold).astype(np.int8)


def _logit(p: float) -> float:
    return float(np.log(p / (1 - p)))


def first_split_difference(a: GBDTClassifier, b: GBDTClassifier, n_rows: int):
    """The first internal node, in fit order (tree, level, node), where two
    fitted classifiers split differently, or ``None`` when every split
    agrees.  Trees after it grew from other margins, so only this node
    says why.  Returns both splits as (feature, bin, gain) and whether the
    two gains lie within ``tol = n_rows * 2^-24 * max |gain|`` — the
    relative error bound of a float32 sum of ``n_rows`` terms, which a
    plain (sequential float32) histogram has — which makes the node a near
    tie that rounding alone can flip."""
    for t, (ta, tb) in enumerate(zip(a.trees, b.trees)):
        for lv in range(len(ta[0])):
            diff = np.nonzero((ta[0][lv] != tb[0][lv]) | (ta[1][lv] != tb[1][lv]))[0]
            if len(diff) == 0:
                continue
            k = int(diff[0])
            at = (1 << lv) - 1 + k
            ga, gb = float(a.gains[t][at]), float(b.gains[t][at])
            tol = n_rows * 2.0**-24 * max(abs(ga), abs(gb))
            return {
                "tree": t,
                "level": lv,
                "node": k,
                "a": (int(ta[0][lv][k]), int(ta[1][lv][k]), ga),
                "b": (int(tb[0][lv][k]), int(tb[1][lv][k]), gb),
                "tol": tol,
                "near_tie": abs(ga - gb) <= tol,
            }
    return None
