"""The port's DetectionService against the JAX package's, fed the same
microbatches: per-tick counts, dirty sets, alert rows, ``TickReport``
stats and store counters; incremental == ``recompute_counts``;
pipelined == sequential with one host sync per tick; the session's
``service()``, ``streaming()`` and ``backend="streaming"``."""
import warnings

import numpy as np
import pytest

from repro.api import MiningSession as JaxSession
from repro.stream import DetectionService as JaxService
from repro_torch.api import MiningSession
from repro_torch.convert import graph_from_reference
from repro_torch.core.compiler import CompiledPattern
from repro_torch.core.patterns import build_pattern
from repro_torch.graph.csr import build_temporal_graph
from repro_torch.core.streaming import StreamingMiner
from repro_torch.stream import STREAM_BUCKET_LADDER, DetectionService, default_retain
from tests.conftest import random_temporal_graph

W = 64
NAMES = ["fan_in", "cycle3", "scatter_gather"]
THRESH = {"cycle3": 1, "fan_in": 3}
BACKENDS = [("pallas", "kernel"), ("xla", "torch")]


def _feed(seed, n_nodes=120, n_edges=600, t_span=12_000, n_batches=10):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    fix = src == dst
    dst[fix] = (dst[fix] + 1) % n_nodes
    t = np.sort(rng.integers(0, t_span // 4, n_edges)).astype(np.int64) * 4
    t = np.maximum(0, t + rng.integers(-8, 9, n_edges))  # out of order + duplicates
    amt = rng.uniform(1, 500, n_edges).astype(np.float32)
    return [(src[c], dst[c], t[c], amt[c]) for c in np.array_split(np.arange(n_edges), n_batches)]


def _same_batch(a, b):
    assert a.columns == b.columns
    for f in ("eids", "src", "dst", "t", "amount", "counts", "score", "triggered"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.to_rows() == b.to_rows()
    ra, rb = a.report, b.report
    for f in ("tick", "n_new", "n_live", "n_dirty", "dirty", "dirty_fraction", "path", "view_nodes",
              "view_edges", "stats", "store", "rejected", "quarantined", "late_contract_breach",
              "degraded", "retries", "trace_misses"):
        assert getattr(ra, f) == getattr(rb, f), f


# "local": no retention, small batches, so the delta path runs; "evict":
# a sliding window (retain="auto"), so ticks evict and re-mine whole
FEEDS = {
    "local": (dict(n_edges=600, t_span=6000, n_batches=15), dict()),
    "evict": (dict(), dict(retain="auto", lateness=1500)),
}


@pytest.mark.parametrize("feed_kind", sorted(FEEDS))
@pytest.mark.parametrize("backends", BACKENDS, ids=["kernel", "torch"])
def test_ticks_match_jax(backends, feed_kind):
    feed_kw, svc_kw = FEEDS[feed_kind]
    feed = _feed(4, **feed_kw)
    kw = dict(thresholds=THRESH, **svc_kw)
    ours = DetectionService(NAMES, window=W, backend=backends[1], device="cpu", **kw)
    ref = JaxService(NAMES, window=W, backend=backends[0], **kw)
    assert ours.ladder == STREAM_BUCKET_LADDER and ours.store.retain == ref.store.retain
    paths = set()
    for b in feed:
        _same_batch(ours.submit(*b), ref.submit(*b))
        paths.add(ours.last_report.path)
        assert set(ours.last_plan.dirty) == set(ref.last_plan.dirty)
        for n, d in ours.last_plan.dirty.items():
            np.testing.assert_array_equal(d, ref.last_plan.dirty[n], err_msg=n)
        np.testing.assert_array_equal(ours.last_plan.union_dirty, ref.last_plan.union_dirty)
    if feed_kind == "local":
        assert "local" in paths
    else:
        assert ours.store.stats["edges_evicted"] > 0
        assert ours.store.retain == default_retain(ours.scheduler, 1500)
    assert ours.stats == ref.stats and ours.stats["host_syncs"] == len(feed)
    for n in NAMES:
        np.testing.assert_array_equal(ours.pattern_counts(n), ref.pattern_counts(n), err_msg=n)
    # counts are frozen at mine time, so incremental == a batch mine of
    # the full history; without eviction that is recompute_counts
    full = build_temporal_graph(*(np.concatenate(c) for c in zip(*feed)))
    for n in NAMES:
        want = CompiledPattern(build_pattern(n, W), full, backend=backends[1], device="cpu").mine()
        np.testing.assert_array_equal(ours.pattern_counts(n), want, err_msg=n)
        np.testing.assert_array_equal(ours.recompute_counts(n), ref.recompute_counts(n), err_msg=n)
        if feed_kind == "local":
            np.testing.assert_array_equal(ours.recompute_counts(n), want, err_msg=n)


def test_pipelined_equals_sequential_one_sync_per_tick():
    feed = _feed(9, n_batches=8)
    kw = dict(thresholds=THRESH, retain="auto", lateness=1500, backend="torch", device="cpu")
    seq = DetectionService(NAMES, window=W, **kw)
    pip = DetectionService(NAMES, window=W, pipeline=True, **kw)
    seq_batches = [seq.submit(*b) for b in feed]
    pip_batches = []
    for i, b in enumerate(feed):
        out = pip.submit(*b)
        assert (out is None) == (i == 0)
        if out is not None:
            pip_batches.append(out)
    pip_batches += pip.flush()
    assert pip.flush() == []
    assert len(pip_batches) == len(feed)
    for a, b in zip(seq_batches, pip_batches):
        for f in ("eids", "counts", "score", "triggered"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert a.report.tick == b.report.tick and a.report.dirty == b.report.dirty
    for svc in (seq, pip):
        assert svc.stats["host_syncs"] == len(feed) == svc.tick
    for n in NAMES:
        np.testing.assert_array_equal(seq.pattern_counts(n), pip.pattern_counts(n), err_msg=n)


@pytest.mark.parametrize("backends", BACKENDS, ids=["kernel", "torch"])
def test_session_streaming_surfaces_match_jax(backends):
    g = random_temporal_graph(np.random.default_rng(2), n_nodes=30, n_edges=220, t_max=600)
    tg = graph_from_reference(g)
    ours = MiningSession(tg, window=W, kernel_backend=backends[1], device="cpu").register(*NAMES)
    ref = JaxSession(g, window=W, kernel_backend=backends[0]).register(*NAMES)
    # backend="streaming": the whole graph as one tick
    got = ours.mine(backend="streaming")
    want = ref.mine(backend="streaming")
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.counts, ours.mine().counts)
    assert got.stats == want.stats and got.stats["host_syncs"] == 1
    # service(): the session's portfolio, device and kernel backend
    svc, jsvc = ours.service(thresholds={"cycle3": 1}), ref.service(thresholds={"cycle3": 1})
    assert svc.backend == backends[1] and svc.device.type == "cpu"
    for c in np.array_split(np.arange(g.n_edges), 4):
        _same_batch(svc.submit(g.src[c], g.dst[c], g.t[c]), jsvc.submit(g.src[c], g.dst[c], g.t[c]))
    # streaming(): the deprecated shim
    with pytest.warns(DeprecationWarning):
        sm = ours.streaming()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jsm = ref.streaming()
    assert isinstance(sm, StreamingMiner) and sm.hop_radius == jsm.hop_radius
    assert sm.time_radius == jsm.time_radius
    for c in np.array_split(np.arange(g.n_edges), 3):
        np.testing.assert_array_equal(sm.ingest(g.src[c], g.dst[c], g.t[c]), jsm.ingest(g.src[c], g.dst[c], g.t[c]))
        assert sm.last_dirty == jsm.last_dirty and sm.last_stats == jsm.last_stats
    for n in NAMES:
        np.testing.assert_array_equal(sm.counts[n], jsm.counts[n], err_msg=n)
    assert sm.graph.n_edges == g.n_edges


def test_witnesses_raise_naming_a7():
    with pytest.raises(NotImplementedError, match="A7"):
        DetectionService(NAMES, window=W, witnesses=2, device="cpu")
    svc = DetectionService(NAMES, window=W, device="cpu")
    assert svc.submit(np.zeros(0), np.zeros(0), np.zeros(0)).evidence is None


def test_portfolio_gather_is_one_copy_like_jax(monkeypatch):
    import jax.numpy as jnp
    import torch

    from repro.core import shard as jax_shard
    from repro_torch.core import executor, shard
    from repro_torch.device import to_host

    rng = np.random.default_rng(0)
    host = {n: rng.integers(0, 99, k).astype(np.int32) for n, k in (("a", 5), ("b", 0), ("c", 33))}
    copies = []
    monkeypatch.setattr(shard, "to_host", lambda t: copies.append(t.shape) or to_host(t))
    stats, jstats = executor.new_stats(), executor.new_stats()
    got = shard.gather({n: torch.from_numpy(v) for n, v in host.items()}, stats, mode="portfolio")
    want = jax_shard.gather({n: jnp.asarray(v) for n, v in host.items()}, jstats, mode="portfolio")
    assert copies == [(38,)] and stats == jstats and stats["host_syncs"] == 1
    for n in host:
        np.testing.assert_array_equal(got[n], np.asarray(want[n]))
        assert got[n].dtype == np.int32
