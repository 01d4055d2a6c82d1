"""IBM-AML-style synthetic transaction generator.

Mirrors the *shape* of the IBM AML datasets [Altman et al. 2024] used by the
paper: power-law account activity, timestamped multigraph, and injected
laundering typologies — fan-in, fan-out, cycles, scatter-gather, and
stacked bipartite ("stack") — at LI (low-illicit) / HI (high-illicit)
rates.  Edge labels mark ground-truth laundering transactions.

The real datasets (5M–180M edges) are not shipped with the repository; the
presets keep the six published names at CPU-tractable sizes, and ``scale``
grows them (HI-Small at ``scale=282`` has about 451K accounts and 5.1M
transactions, the published dataset's size).  Every generator is
deterministic in ``seed``, and this copy generates graphs bit-identical to
the JAX package's ``repro.data.synth_aml`` for the same
``(name, seed, scale)``.

**Plant-and-recover**: every injected typology instance is tracked
through the final edge-id shuffle — ``meta["instances"]`` lists, per
instance, its kind and its *global edge ids in injection order* (a
cycle's hops in path order, a fan's transfers in time order, a
scatter-gather's scatter phase then gather phase).  That makes witness
recovery assertable end-to-end: plant a known laundering path, mine
witnesses at one of its edges, and check the planted edge ids come back
(:func:`planted_instances`; ``tests/test_witness.py``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.graph.csr import TemporalGraph, build_temporal_graph

__all__ = [
    "AMLDataset",
    "DATASET_PRESETS",
    "generate_aml_dataset",
    "load_dataset",
    "planted_instances",
]

T_HORIZON = 1 << 20  # timestamp range (seconds-like ticks)
THRESHOLD = 10_000.0  # structuring threshold: illicit amounts stay below


@dataclasses.dataclass(frozen=True)
class AMLDataset:
    name: str
    graph: TemporalGraph
    labels: np.ndarray  # (E,) int8 — 1 = laundering edge
    meta: dict

    @property
    def illicit_rate(self) -> float:
        return float(self.labels.mean()) if self.labels.size else 0.0


# name -> (n_accounts, n_background_edges, illicit_edge_rate)
DATASET_PRESETS: Dict[str, Tuple[int, int, float]] = {
    "LI-Small": (2_000, 24_000, 0.0018),
    "HI-Small": (1_600, 18_000, 0.012),
    "LI-Medium": (6_000, 90_000, 0.0015),
    "HI-Medium": (6_000, 92_000, 0.011),
    "LI-Large": (12_000, 260_000, 0.0012),
    "HI-Large": (12_000, 265_000, 0.010),
}


def _powerlaw_nodes(rng: np.random.Generator, n: int, size: int, alpha: float = 1.1):
    """Zipf-ish node sampling: rank-based power law, vectorized."""
    ranks = rng.random(size) ** (1.0 / (1.0 - alpha + 1e-9))  # heavy tail
    ranks = np.clip(ranks, 1.0, None)
    ids = (ranks % n).astype(np.int64)
    return rng.permutation(n)[ids].astype(np.int32)


def _background(rng, n_nodes: int, n_edges: int):
    src = _powerlaw_nodes(rng, n_nodes, n_edges)
    dst = _powerlaw_nodes(rng, n_nodes, n_edges)
    fix = src == dst
    dst[fix] = (dst[fix] + 1 + rng.integers(0, n_nodes - 1, fix.sum())) % n_nodes
    t = rng.integers(0, T_HORIZON, n_edges, dtype=np.int64)
    amount = np.exp(rng.normal(5.5, 1.6, n_edges)).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), t, amount


def _illicit_amounts(rng, size: int) -> np.ndarray:
    # structuring: uniform just under the reporting threshold
    return rng.uniform(0.35, 0.97, size).astype(np.float32) * THRESHOLD


class _Inject:
    """Accumulates injected laundering edges."""

    def __init__(self, rng: np.random.Generator, n_nodes: int):
        self.rng = rng
        self.n = n_nodes
        self.src: list = []
        self.dst: list = []
        self.t: list = []
        self.amt: list = []
        self.kind: list = []
        # per-instance (kind, [row0, row1) in injection arrays) — rows
        # map to final edge ids after the shuffle (plant-and-recover)
        self.instances: list = []
        self._inst = 0  # instance counter for time stratification

    def _nodes(self, k: int) -> np.ndarray:
        return self.rng.choice(self.n, size=k, replace=False).astype(np.int32)

    def _base_t(self, span: int) -> int:
        # stratify instances over the horizon so the temporal 80/20 split
        # sees typologies on both sides even with a handful of instances
        # (the LI datasets draw as few as 4): the explicit order places a
        # test-region (decile 9) instance third
        order = (2, 5, 9, 0, 7, 3, 8, 1, 6, 4)
        seg = order[self._inst % 10]
        self._inst += 1
        lo = seg * (T_HORIZON - span) // 10
        hi = max(lo + 1, (seg + 1) * (T_HORIZON - span) // 10)
        return int(self.rng.integers(lo, hi))

    def add(self, s, d, t, kind):
        k = len(s)
        self.src.extend(int(x) for x in s)
        self.dst.extend(int(x) for x in d)
        self.t.extend(int(x) for x in t)
        self.amt.extend(_illicit_amounts(self.rng, k))
        self.kind.extend([kind] * k)

    def _mark(self, kind: str, row0: int):
        self.instances.append((kind, row0, len(self.src)))

    # --- typologies ------------------------------------------------------
    def fan_in(self, k: int, window: int):
        row0 = len(self.src)
        nodes = self._nodes(k + 1)
        hub, srcs = nodes[0], nodes[1:]
        t0 = self._base_t(window)
        ts = t0 + np.sort(self.rng.integers(0, window, k))
        self.add(srcs, [hub] * k, ts, "fan_in")
        self._mark("fan_in", row0)

    def fan_out(self, k: int, window: int):
        row0 = len(self.src)
        nodes = self._nodes(k + 1)
        hub, dsts = nodes[0], nodes[1:]
        t0 = self._base_t(window)
        ts = t0 + np.sort(self.rng.integers(0, window, k))
        self.add([hub] * k, dsts, ts, "fan_out")
        self._mark("fan_out", row0)

    def cycle(self, length: int, window: int, shuffle_time: bool = False):
        row0 = len(self.src)
        nodes = self._nodes(length)
        t0 = self._base_t(window)
        offs = np.sort(self.rng.integers(0, window, length))
        if shuffle_time:  # temporal fuzziness: out-of-order camouflage edge
            offs = self.rng.permutation(offs)
        s = nodes
        d = np.roll(nodes, -1)
        self.add(s, d, t0 + offs, "cycle")
        self._mark("cycle", row0)

    def scatter_gather(self, k: int, window: int):
        row0 = len(self.src)
        nodes = self._nodes(k + 2)
        src, sink, mids = nodes[0], nodes[1], nodes[2:]
        t0 = self._base_t(2 * window)
        t_sc = t0 + self.rng.integers(0, window, k)
        # temporal fuzziness: gather phase decoupled, only per-mid ordering
        t_ga = t_sc + 1 + self.rng.integers(0, window, k)
        self.add([src] * k, mids, t_sc, "scatter_gather")
        self.add(mids, [sink] * k, t_ga, "scatter_gather")
        self._mark("scatter_gather", row0)

    def stack(self, k1: int, k2: int, window: int):
        """Stacked bipartite: layer A -> layer B -> layer C."""
        row0 = len(self.src)
        nodes = self._nodes(k1 + k2 + 2)
        a, c = nodes[0], nodes[1]
        bs = nodes[2 : 2 + k1]
        cs = nodes[2 + k1 :]
        t0 = self._base_t(3 * window)
        for b in bs:
            self.add([a], [b], [t0 + int(self.rng.integers(0, window))], "stack")
        for b in bs:
            for d in cs:
                if self.rng.random() < 0.7:
                    self.add(
                        [b],
                        [d],
                        [t0 + window + int(self.rng.integers(0, window))],
                        "stack",
                    )
        for d in cs:
            self.add(
                [d], [c], [t0 + 2 * window + int(self.rng.integers(0, window))], "stack"
            )
        self._mark("stack", row0)


def generate_aml_dataset(
    name: str = "HI-Small",
    seed: int = 0,
    scale: float = 1.0,
    window: int = 4096,
) -> AMLDataset:
    if name not in DATASET_PRESETS:
        raise KeyError(f"unknown dataset {name!r}; options: {list(DATASET_PRESETS)}")
    n_nodes, n_bg, rate = DATASET_PRESETS[name]
    n_nodes = max(64, int(n_nodes * scale))
    n_bg = max(512, int(n_bg * scale))
    # zlib.crc32 (not hash()) so datasets are deterministic across processes
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2**31))

    src, dst, t, amt = _background(rng, n_nodes, n_bg)

    inj = _Inject(rng, n_nodes)
    target_illicit = int(rate * n_bg / (1 - rate))
    # many small instances (sizes 3-9) rather than few big ones: every
    # typology then appears in both sides of the temporal 80/20 split
    # even at reduced scales
    while len(inj.src) < target_illicit:
        typ = rng.integers(0, 5)
        if typ == 0:
            inj.fan_in(int(rng.integers(3, 9)), window)
        elif typ == 1:
            inj.fan_out(int(rng.integers(3, 9)), window)
        elif typ == 2:
            inj.cycle(int(rng.integers(2, 6)), window, shuffle_time=rng.random() < 0.3)
        elif typ == 3:
            inj.scatter_gather(int(rng.integers(3, 8)), window)
        else:
            inj.stack(int(rng.integers(2, 4)), int(rng.integers(2, 4)), window)

    i_src = np.asarray(inj.src, dtype=np.int32)
    i_dst = np.asarray(inj.dst, dtype=np.int32)
    i_t = np.asarray(inj.t, dtype=np.int64)
    i_amt = np.asarray(inj.amt, dtype=np.float32)

    all_src = np.concatenate([src, i_src])
    all_dst = np.concatenate([dst, i_dst])
    all_t = np.concatenate([t, i_t])
    all_amt = np.concatenate([amt, i_amt])
    labels = np.concatenate(
        [np.zeros(n_bg, dtype=np.int8), np.ones(i_src.shape[0], dtype=np.int8)]
    )
    # shuffle edge ids so labels aren't positional
    perm = rng.permutation(all_src.shape[0])
    g = build_temporal_graph(
        all_src[perm], all_dst[perm], all_t[perm], all_amt[perm], n_nodes=n_nodes
    )
    kinds = np.asarray(["bg"] * n_bg + inj.kind, dtype=object)[perm]
    # plant-and-recover bookkeeping: pre-shuffle injection row r sits at
    # final edge id inv_perm[n_bg + r], so every planted instance's edge
    # ids survive the shuffle in injection order
    inv_perm = np.argsort(perm)
    instances = [
        {"kind": k, "eids": inv_perm[n_bg + np.arange(r0, r1)].astype(np.int64)}
        for (k, r0, r1) in inj.instances
    ]
    return AMLDataset(
        name=name,
        graph=g,
        labels=labels[perm],
        meta={
            "window": window,
            "seed": seed,
            "scale": scale,
            "n_illicit": int(labels.sum()),
            "kinds": kinds,
            "instances": instances,
        },
    )


def planted_instances(ds: AMLDataset, kind: Optional[str] = None) -> list:
    """The dataset's planted typology instances (optionally one kind):
    dicts ``{"kind", "eids"}`` with global edge ids in injection order —
    the ground truth witness recovery is asserted against."""
    inst = ds.meta.get("instances", [])
    return [d for d in inst if kind is None or d["kind"] == kind]


_CACHE: dict = {}


def load_dataset(name: str, seed: int = 0, scale: float = 1.0) -> AMLDataset:
    key = (name, seed, scale)
    if key not in _CACHE:
        _CACHE[key] = generate_aml_dataset(name, seed=seed, scale=scale)
    return _CACHE[key]
