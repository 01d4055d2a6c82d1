"""The port's TemporalGraphStore (a numpy copy of ``repro.stream.store``)
fed the same ingest sequence as the JAX package's: out-of-order and
duplicate timestamps, unseen node ids, eviction under ``retain``.  The
``state_dict`` trees are equal key for key, and so are the
``snapshot()`` and ``local_view()`` graphs and the counters."""
import dataclasses

import numpy as np
import pytest

from repro.stream import TemporalGraphStore as JaxStore
from repro_torch.graph.csr import TemporalGraph
from repro_torch.stream import STORE_STAT_KEYS, TemporalGraphStore, store_states_equal


def _stream(rng, n_nodes=40, n_edges=320, t_max=4000):
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    fix = src == dst
    dst[fix] = (dst[fix] + 1) % n_nodes
    t = np.sort(rng.integers(0, t_max // 8, n_edges)).astype(np.int64) * 8
    t = np.maximum(0, t + rng.integers(-40, 41, n_edges))  # out of order + duplicates
    amt = rng.uniform(1, 100, n_edges).astype(np.float32)
    return src, dst, t, amt


def _graphs_equal(a, b):
    for f in dataclasses.fields(TemporalGraph):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        else:
            assert x == y, f.name


def _states_equal_key_for_key(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            assert set(a[k]) == set(b[k])
            for kk in a[k]:
                np.testing.assert_array_equal(a[k][kk], b[k][kk], err_msg=f"{k}/{kk}")
                assert a[k][kk].dtype == b[k][kk].dtype
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("retain", [None, 600])
def test_same_ingest_sequence_same_state(retain):
    rng = np.random.default_rng(3)
    src, dst, t, amt = _stream(rng)
    ours = TemporalGraphStore(retain=retain, node_capacity=8)
    ref = JaxStore(retain=retain, node_capacity=8)
    for i, ch in enumerate(np.array_split(np.arange(len(src)), 9)):
        s, d = src[ch], dst[ch]
        if i == 5:  # unseen node ids grow the capacity mid-stream
            s, d = s + 100, d + 37
        e_ours = ours.ingest(s, d, t[ch], amt[ch])
        e_ref = ref.ingest(s, d, t[ch], amt[ch])
        np.testing.assert_array_equal(e_ours, e_ref)
        _states_equal_key_for_key(ours.state_dict(), ref.state_dict())
        assert ours.stats == ref.stats and set(ours.stats) == set(STORE_STAT_KEYS)
        _graphs_equal(ours.snapshot().graph, ref.snapshot().graph)
        core = np.unique(np.concatenate([s, d]))[:6]
        t_lo = int(t[ch].min()) - 200
        v_ours, v_ref = ours.local_view(core, t_lo, node_floor=16), ref.local_view(core, t_lo, node_floor=16)
        _graphs_equal(v_ours.graph, v_ref.graph)
        np.testing.assert_array_equal(v_ours.node_ids, v_ref.node_ids)
        np.testing.assert_array_equal(v_ours.edge_ids, v_ref.edge_ids)
        np.testing.assert_array_equal(v_ours.local_seeds(v_ours.edge_ids[:5]), v_ref.local_seeds(v_ref.edge_ids[:5]))
    if retain is not None:
        assert ours.stats["edges_evicted"] > 0 and ours.n_live < len(src)
    assert ours.n_live == ref.n_live and ours.n_edges_total == ref.n_edges_total


def test_state_round_trips_and_rollback_is_exact():
    rng = np.random.default_rng(8)
    src, dst, t, amt = _stream(rng, n_edges=200)
    store = TemporalGraphStore(retain=500)
    for ch in np.array_split(np.arange(150), 4):
        store.ingest(src[ch], dst[ch], t[ch], amt[ch])
    before = store.state_dict()
    memo = store.begin()
    store.ingest(src[150:], dst[150:], t[150:], amt[150:])
    assert not store_states_equal(before, store.state_dict())
    store.rollback(memo)
    assert store_states_equal(before, store.state_dict())
    fresh = TemporalGraphStore()
    fresh.load_state(before)
    assert store_states_equal(before, fresh.state_dict())
    _graphs_equal(fresh.snapshot().graph, store.snapshot().graph)
