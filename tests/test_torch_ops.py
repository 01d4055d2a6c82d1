"""Each of the 11 mining primitives of ``repro_torch.core.ops`` against
its ``repro.core.ops`` counterpart on random CSR rows: exact integer
equality, including inverted windows, the ``node < 0`` / ``x < 0``
sentinels, expand offsets, and the union-dedup representative."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core.ops as jops
import repro_torch.core.ops as tops
from repro_torch.convert import graph_from_reference
from tests.conftest import random_temporal_graph

B, W = 16, 5


@pytest.fixture(scope="module")
def graphs():
    g = random_temporal_graph(np.random.default_rng(21), n_nodes=20, n_edges=220, t_max=300)
    return g, g.to_device(), graph_from_reference(g).to_device(device="cpu")


def _pair(a):
    a = np.asarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _eq(got, ref):
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _eq(g, r)
        return
    g = got.numpy()
    r = np.asarray(ref)
    assert g.shape == r.shape
    np.testing.assert_array_equal(g, r.astype(g.dtype))


def _queries(rng, g):
    """Nodes with -1 sentinels, ids with -1, windows partly inverted."""
    node = rng.integers(-1, g.n_nodes, (B, W)).astype(np.int32)
    x = rng.integers(-1, g.n_nodes, (B, W)).astype(np.int32)
    after = rng.integers(-20, 300, (B, W)).astype(np.int32)
    until = (after + rng.integers(-60, 200, (B, W))).astype(np.int32)
    return node, x, after, until


def test_n_iters_for():
    for n in (0, 1, 2, 3, 255, 256, 1 << 20):
        assert tops.n_iters_for(n) == jops.n_iters_for(n)


@pytest.mark.parametrize("seed", [0, 1])
def test_lower_bound(graphs, seed):
    g, jd, td = graphs
    rng = np.random.default_rng(seed)
    n = g.n_edges
    lo = rng.integers(0, n, (B, W)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 40, (B, W)), n).astype(np.int32)
    q = rng.integers(-5, 310, (B, W)).astype(np.int32)
    it = jops.n_iters_for(n)
    args_j = [_pair(a)[0] for a in (lo, hi, q)]
    args_t = [_pair(a)[1] for a in (lo, hi, q)]
    _eq(
        tops.lower_bound(td.out_t_sorted, *args_t, it),
        jops.lower_bound(jd.out_t_sorted, *args_j, it),
    )
    # scalar query broadcast against (B, W) ranges
    _eq(
        tops.lower_bound(td.in_t_sorted, args_t[0], args_t[1], 150, it),
        jops.lower_bound(jd.in_t_sorted, args_j[0], args_j[1], 150, it),
    )


@pytest.mark.parametrize("fn", ["count_t_in", "count_t_in_pos"])
def test_count_t_in(graphs, fn):
    g, jd, td = graphs
    rng = np.random.default_rng(2)
    n = g.n_edges
    start = rng.integers(0, n, (B, W)).astype(np.int32)
    end = np.minimum(start + rng.integers(0, 50, (B, W)), n).astype(np.int32)
    _, _, after, until = _queries(rng, g)
    it = jops.n_iters_for(g.max_out_deg())
    j = [_pair(a)[0] for a in (start, end, after, until)]
    t = [_pair(a)[1] for a in (start, end, after, until)]
    ref = getattr(jops, fn)(jd.out_t_sorted, *j, it)
    got = getattr(tops, fn)(td.out_t_sorted, *t, it)
    _eq(got, ref)
    # inverted windows clamp to 0, never negative
    cnt = got[0] if isinstance(got, tuple) else got
    assert (cnt >= 0).all()


@pytest.mark.parametrize("fn", ["count_id_in_window", "count_id_in_window_pos"])
@pytest.mark.parametrize("direction", ["out", "in"])
def test_count_id_in_window(graphs, fn, direction):
    g, jd, td = graphs
    rng = np.random.default_rng(3)
    node, x, after, until = _queries(rng, g)
    it = jops.n_iters_for(max(g.max_out_deg(), g.max_in_deg()))
    rows_j = [getattr(jd, f"{direction}_{k}") for k in ("nbr", "t", "indptr")]
    rows_t = [getattr(td, f"{direction}_{k}") for k in ("nbr", "t", "indptr")]
    j = [_pair(a)[0] for a in (node, x, after, until)]
    t = [_pair(a)[1] for a in (node, x, after, until)]
    _eq(getattr(tops, fn)(*rows_t, *t, it), getattr(jops, fn)(*rows_j, *j, it))
    # Python-int window bounds (unanchored stages) and broadcast queries
    _eq(
        getattr(tops, fn)(*rows_t, t[0][:, :1], t[1], -(1 << 30), 1 << 30, it),
        getattr(jops, fn)(*rows_j, j[0][:, :1], j[1], -(1 << 30), 1 << 30, it),
    )


@pytest.mark.parametrize("fn", ["count_window", "count_window_pos"])
def test_count_window(graphs, fn):
    g, jd, td = graphs
    rng = np.random.default_rng(4)
    node, _, after, until = _queries(rng, g)
    it = jops.n_iters_for(g.max_in_deg())
    j = [_pair(a)[0] for a in (node, after, until)]
    t = [_pair(a)[1] for a in (node, after, until)]
    _eq(
        getattr(tops, fn)(td.in_t_sorted, td.in_indptr, *t, it),
        getattr(jops, fn)(jd.in_t_sorted, jd.in_indptr, *j, it),
    )


@pytest.mark.parametrize("fn", ["expand", "expand_pos"])
@pytest.mark.parametrize("offset", ["zero", "scalar", "array"])
def test_expand(graphs, fn, offset):
    g, jd, td = graphs
    rng = np.random.default_rng(5)
    node = rng.integers(-1, g.n_nodes, (B, 3)).astype(np.int32)
    off = {"zero": 0, "scalar": 8, "array": rng.integers(0, 12, (B, 3)).astype(np.int32)}[offset]
    oj, ot = (off, off) if isinstance(off, int) else _pair(off)
    for d in (1, 4, 16):
        _eq(
            getattr(tops, fn)(td.out_indptr, (td.out_nbr, td.out_t), _pair(node)[1], d, offset=ot),
            getattr(jops, fn)(jd.out_indptr, (jd.out_nbr, jd.out_t), _pair(node)[0], d, offset=oj),
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_ids_representative(seed):
    """Duplicate ids with different times: the stable sort must keep the
    same representative time JAX keeps."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 6, (B, 2, 12)).astype(np.int32)
    ts = rng.integers(0, 100, (B, 2, 12)).astype(np.int32)
    mask = rng.random((B, 2, 12)) < 0.7
    inv = int(np.int32(2**31 - 1))
    j = jops.dedup_ids(*(_pair(a)[0] for a in (ids, ts, mask)), np.int32(inv))
    t = tops.dedup_ids(*(_pair(a)[1] for a in (ids, ts, mask)), inv)
    _eq(t, tuple(j))
    # the survivor of every id is its first in-mask slot in the stable order
    assert t[2].sum() <= mask.sum()
