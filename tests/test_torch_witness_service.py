"""Evidence-carrying alerts in the port's streaming service against the
JAX package's: ``DetectionService(witnesses=k)`` over the feeds of
``tests/test_witness.py`` (with and without eviction) gives equal alert
rows, evidence included, and equal ``TickReport.stats``; the evidence
equals the port's oracle on the live graph; the ``witness`` chaos point
rolls a tick back and the ``witnesses_off`` rung sheds evidence as the
JAX package does; a laundering cycle planted by the data generator comes
back as a witness from its own seed edge."""
import numpy as np
import pytest
import torch

from repro.stream import DetectionService as JaxService
from repro.stream import FaultInjector as JaxFaults
from repro.stream import ResilienceConfig as JaxConfig
from repro.stream import ResilientDetectionService as JaxResilient
from repro.stream import TransientFault as JaxTransient
from repro_torch.core.compiler import CompiledPattern
from repro_torch.core.oracle import GFPReference
from repro_torch.core.patterns import build_pattern
from repro_torch.data.synth_aml import generate_aml_dataset, planted_instances
from repro_torch.stream import (
    DetectionService,
    FaultInjector,
    ResilienceConfig,
    ResilientDetectionService,
    TransientFault,
    store_states_equal,
)

W = 96
BACKENDS = [("pallas", "kernel"), ("xla", "torch")]
REPORT_FIELDS = ("tick", "n_new", "n_live", "n_dirty", "dirty", "dirty_fraction", "path", "view_nodes",
                 "view_edges", "stats", "store", "rejected", "quarantined", "degraded", "retries",
                 "trace_misses")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The eager CPU ops here are small: under the suite's six xdist
    workers on the same cores, torch's intra-op threads oversubscribe
    them and a witness mine runs about 5x slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feed(seed, n_nodes, ticks, per_tick):
    """``tests/test_witness.py``'s ``_run_feed`` microbatches, as a list."""
    rng = np.random.default_rng(seed)
    t, out = 0, []
    for _ in range(ticks):
        s = rng.integers(0, n_nodes, per_tick).astype(np.int32)
        d = (s + rng.integers(1, n_nodes, per_tick).astype(np.int32)) % n_nodes
        tt = np.sort(t + rng.integers(0, 30, per_tick).astype(np.int64))
        t = int(tt[-1]) + 1
        amt = rng.uniform(1, 50, per_tick).astype(np.float32)
        out.append((s, d, tt, amt))
    return out


def _same_batch(a, b):
    assert a.columns == b.columns
    for f in ("eids", "src", "dst", "t", "amount", "counts", "score", "triggered"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.evidence == b.evidence
    assert a.to_rows() == b.to_rows()
    for f in REPORT_FIELDS:
        assert getattr(a.report, f) == getattr(b.report, f), f


# the two feeds of tests/test_witness.py: no retention (evidence checked
# against the oracle on the snapshot), and a sliding window that evicts
FEEDS = {
    "roundtrip": (dict(seed=7, n_nodes=16, ticks=5, per_tick=20),
                  dict(patterns=["fan_in", "cycle3"], thresholds={"fan_in": 2, "cycle3": 1}, witnesses=3)),
    "evict": (dict(seed=8, n_nodes=12, ticks=13, per_tick=25),
              dict(patterns=["fan_in", "cycle2"], thresholds={"fan_in": 2, "cycle2": 1}, witnesses=2,
                   retain="auto", lateness=32)),
}


@pytest.mark.parametrize("feed_kind", sorted(FEEDS))
@pytest.mark.parametrize("backends", BACKENDS, ids=["kernel", "torch"])
def test_evidence_matches_jax(feed_kind, backends):
    feed_kw, svc_kw = FEEDS[feed_kind]
    svc_kw = dict(svc_kw)
    names = svc_kw.pop("patterns")
    ours = DetectionService(names, window=W, backend=backends[1], device="cpu", **svc_kw)
    ref = JaxService(names, window=W, backend=backends[0], **svc_kw)
    checked = 0
    for b in _feed(**feed_kw):
        got, want = ours.submit(*b), ref.submit(*b)
        _same_batch(got, want)
        assert got.evidence is not None and len(got.evidence) == len(got)
        checked += sum(len(ev) for ev in got.evidence)
        assert ours.stats == ref.stats
    assert checked > 0
    last = got
    if feed_kind == "evict":
        assert ours.store.stats["edges_evicted"] > 0
    else:
        # no eviction: global ids == snapshot-local ids, so the evidence
        # equals the oracle's first k on the live graph
        snap = ours.store.snapshot()
        k = ours.witnesses
        oracle = {n: GFPReference(ours._specs[n], snap.graph).mine_witnesses(None, k=k)[1]
                  for n in ours.pattern_names}
        for i in range(len(last)):
            for name, wits in last.evidence[i].items():
                j = last.columns.index(name)
                assert last.triggered[i, j] and len(wits) == min(k, int(last.counts[i, j]))
                seed = int(last.eids[i])
                assert [tuple(h["eid"] for h in wit) for wit in wits] == oracle[name][seed][:k]
    # every resolved hop is the stored transaction with that id
    for ev in last.evidence:
        for wits in ev.values():
            for hop in (h for wit in wits for h in wit if h["eid"] >= 0):
                s, d, t, a = ours.store.edge_fields(np.array([hop["eid"]], dtype=np.int64))
                assert (int(s[0]), int(d[0]), int(t[0]), float(a[0])) == (
                    hop["src"], hop["dst"], hop["t"], hop["amount"])


@pytest.mark.parametrize("backends", BACKENDS, ids=["kernel", "torch"])
def test_pipelined_evidence_equals_sequential(backends):
    feed = _feed(seed=9, n_nodes=14, ticks=8, per_tick=24)
    kw = dict(thresholds={"fan_in": 2, "cycle3": 1}, witnesses=2, retain="auto", lateness=32,
              backend=backends[1], device="cpu")
    seq = DetectionService(["fan_in", "cycle3"], window=W, **kw)
    pipe = DetectionService(["fan_in", "cycle3"], window=W, pipeline=True, **kw)
    want = [seq.submit(*b) for b in feed]
    got = [b for b in (pipe.submit(*b) for b in feed) if b is not None] + pipe.flush()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.evidence == b.evidence and a.to_rows() == b.to_rows()
    assert pipe.stats["host_syncs"] == seq.stats["host_syncs"]


PORTFOLIO = ["fan_in", "cycle3"]
THRESH = {"fan_in": 2, "cycle3": 1}


def _batches(seed, n_batches=8, n_nodes=120, n_edges=600, t_span=6000):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    fix = src == dst
    dst[fix] = (dst[fix] + 1) % n_nodes
    t = np.sort(rng.integers(0, t_span // 4, n_edges)).astype(np.int64) * 4
    t = np.maximum(0, t + rng.integers(-8, 9, n_edges))
    amt = rng.uniform(1.0, 500.0, n_edges).astype(np.float32)
    return [(src[c], dst[c], t[c], amt[c]) for c in np.array_split(np.arange(n_edges), n_batches)]


def _state(svc):
    return (svc.store.state_dict(), {n: svc.pattern_counts(n).copy() for n in svc.pattern_names}, svc.tick)


@pytest.mark.parametrize("point", ["ingest", "mine", "score", "witness"])
def test_rollback_at_every_stage_with_witnesses(point):
    """``tests/test_stream_resilience.py``'s rollback at every stage, the
    ``witness`` point included, on the port beside the JAX service."""
    feed = _batches(7)
    chaos, jchaos = FaultInjector(), JaxFaults()
    ours = DetectionService(PORTFOLIO, window=W, thresholds=THRESH, witnesses=2, chaos=chaos, device="cpu")
    ref = JaxService(PORTFOLIO, window=W, thresholds=THRESH, witnesses=2, chaos=jchaos, backend="pallas")
    for b in feed[:4]:
        _same_batch(ours.submit(*b), ref.submit(*b))
    pre = _state(ours)
    chaos.arm(point, times=1)
    jchaos.arm(point, times=1)
    with pytest.raises(TransientFault):
        ours.submit(*feed[4])
    with pytest.raises(JaxTransient):
        ref.submit(*feed[4])
    assert chaos.log == jchaos.log == [(point, pre[2] + 1)]
    post = _state(ours)
    assert store_states_equal(pre[0], post[0]) and pre[2] == post[2]
    for n in PORTFOLIO:
        np.testing.assert_array_equal(pre[1][n], post[1][n], err_msg=n)
    assert ours.witnesses == 2 and not ours._count_only and ours._tick_ctx is None
    nxt, jnxt = ours.submit(*feed[3]), ref.submit(*feed[3])
    _same_batch(nxt, jnxt)
    assert nxt.report.retries == 0 and nxt.report.degraded == ()


@pytest.mark.parametrize("times,rungs", [(1, ("witnesses_off",)), (2, ("witnesses_off", "single_device"))])
def test_witnesses_off_rung_like_jax(times, rungs):
    """A transient fault in tick 3's mine retries on the next rungs: the
    retried tick carries no evidence; the next tick carries it again."""
    feed = _batches(1, n_batches=6)
    kw = dict(thresholds=THRESH, witnesses=2, resilience=None)
    ours = ResilientDetectionService(PORTFOLIO, window=W, chaos=FaultInjector(), device="cpu", **kw)
    ref = JaxResilient(PORTFOLIO, window=W, backend="pallas", chaos=JaxFaults(), **kw)
    ours.resilience.backoff_s = ref.resilience.backoff_s = 0.0
    ours.chaos.arm("mine", tick=3, times=times, exc=TransientFault)
    ref.chaos.arm("mine", tick=3, times=times, exc=JaxTransient)
    n_evidence = 0
    for i, b in enumerate(feed):
        got, want = ours.submit(*b), ref.submit(*b)
        a, r = got.report, want.report
        assert (a.retries, a.degraded) == (r.retries, r.degraded)
        assert a.stats == r.stats and got.to_rows() == want.to_rows()
        if i == 2:
            assert a.retries == times and a.degraded == rungs
            assert got.evidence is None or all(ev == {} for ev in got.evidence)
        else:
            assert a.degraded == () and got.evidence == want.evidence
            n_evidence += sum(len(ev) for ev in got.evidence)
    assert ours.witnesses == 2 and n_evidence > 0


def test_deadline_budget_sheds_witnesses_like_jax():
    feed = _batches(43, n_batches=6)
    kw = dict(thresholds=THRESH, witnesses=2)
    ours = ResilientDetectionService(PORTFOLIO, window=W, device="cpu",
                                     resilience=ResilienceConfig(deadline_ms=0.0, recover_after_ticks=2), **kw)
    ref = JaxResilient(PORTFOLIO, window=W, backend="pallas",
                       resilience=JaxConfig(deadline_ms=0.0, recover_after_ticks=2), **kw)
    a, r = ours.submit(*feed[0]).report, ref.submit(*feed[0]).report
    assert ours._level == ref._level == 1
    a, r = ours.submit(*feed[1]).report, ref.submit(*feed[1]).report
    assert "witnesses_off" in a.degraded and a.degraded == r.degraded
    assert ours._level == ref._level == 2
    ours.resilience.deadline_ms = ref.resilience.deadline_ms = 60_000.0
    for b in feed[2:6]:
        got, want = ours.submit(*b), ref.submit(*b)
        assert got.report.degraded == want.report.degraded
    assert ours._level == ref._level == 0
    assert got.evidence == want.evidence


def test_plant_and_recover():
    """Ground truth from the data generator: a strictly time-ordered
    3-cycle it planted comes back as a cycle3 witness at its seed edge."""
    planted = None
    for seed in range(6):
        ds = generate_aml_dataset("HI-Small", seed=seed, scale=0.25)
        for inst in planted_instances(ds, "cycle"):
            e = inst["eids"]
            if len(e) == 3 and np.all(np.diff(ds.graph.t[e]) > 0):
                planted, graph = e, ds.graph
                break
        if planted is not None:
            break
    assert planted is not None, "no strictly-ordered 3-cycle planted in 6 seeds"
    for backend in ("kernel", "torch"):
        cp = CompiledPattern(build_pattern("cycle3", ds.meta["window"]), graph, backend=backend, device="cpu")
        seed_edge = np.array([planted[0]], dtype=np.int32)
        w = cp.mine(seed_edge, witnesses=max(1, int(cp.mine(seed_edge)[0])))
        assert int(w.counts[0]) >= 1
        # cycle3 witnesses are (middle edge, closing edge) of the cycle
        assert (int(planted[1]), int(planted[2])) in w.tuples(0)
