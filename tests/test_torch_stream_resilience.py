"""The port's resilient service (``repro_torch.stream.resilience``, a copy
over the port's DetectionService) against the JAX package's: transient
faults are retried up the ladder, poisoned rows are quarantined, a failed
tick rolls back bit-exactly, WAL + checkpoint recovery restores the state
bit for bit, and the numpy checkpoint round-trips (also from a checkpoint
the JAX package wrote)."""
import json

import numpy as np
import pytest

from repro.distributed.checkpoint import save_checkpoint as jax_save
from repro.stream import FaultInjector as JaxFaults
from repro.stream import ResilienceConfig as JaxConfig
from repro.stream import ResilientDetectionService as JaxResilient
from repro.stream import TransientFault as JaxTransient
from repro_torch.distributed.checkpoint import latest_step, prune, restore_checkpoint, save_checkpoint
from repro_torch.stream import (
    DEGRADATION_LADDER,
    DetectionService,
    FaultInjector,
    InjectedFault,
    ResilienceConfig,
    ResilientDetectionService,
    TransientFault,
    make_poisoned_batch,
    store_states_equal,
)

W = 64
PORTFOLIO = ["fan_in", "cycle3"]
THRESH = {"fan_in": 2, "cycle3": 1}


def _batches(seed, n_batches=10, n_nodes=120, n_edges=600, t_span=6000):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    fix = src == dst
    dst[fix] = (dst[fix] + 1) % n_nodes
    t = np.sort(rng.integers(0, t_span // 4, n_edges)).astype(np.int64) * 4
    t = np.maximum(0, t + rng.integers(-8, 9, n_edges))
    amt = rng.uniform(1.0, 500.0, n_edges).astype(np.float32)
    return [(src[c], dst[c], t[c], amt[c]) for c in np.array_split(np.arange(n_edges), n_batches)]


def _spy_backends(svc):
    """Record the service's backend at every dispatched mine."""
    seen, dispatch = [], svc._dispatch_mine

    def spy(*a, **kw):
        seen.append(svc.backend)
        return dispatch(*a, **kw)

    svc._dispatch_mine = spy
    return seen


def _state(svc):
    return (svc.store.state_dict(), {n: svc.pattern_counts(n).copy() for n in svc.pattern_names}, svc.tick)


def _assert_state_equal(a, b):
    assert store_states_equal(a[0], b[0])
    assert set(a[1]) == set(b[1]) and a[2] == b[2]
    for n in a[1]:
        np.testing.assert_array_equal(a[1][n], b[1][n], err_msg=n)


@pytest.mark.parametrize("times,rungs", [(1, ("witnesses_off",)), (2, ("witnesses_off", "single_device"))])
def test_transient_fault_is_retried_like_jax(times, rungs):
    feed = _batches(1, n_batches=6)
    kw = dict(thresholds=THRESH, resilience=None)
    ours = ResilientDetectionService(PORTFOLIO, window=W, chaos=FaultInjector(), device="cpu", **kw)
    ref = JaxResilient(PORTFOLIO, window=W, backend="pallas", chaos=JaxFaults(), **kw)
    ours.resilience.backoff_s = ref.resilience.backoff_s = 0.0
    ours.chaos.arm("mine", tick=3, times=times, exc=TransientFault)
    ref.chaos.arm("mine", tick=3, times=times, exc=JaxTransient)
    mined_on = _spy_backends(ours)
    for i, b in enumerate(feed):
        a, r = ours.submit(*b).report, ref.submit(*b).report
        assert (a.retries, a.degraded) == (r.retries, r.degraded)
        if i == 2:
            assert a.retries == times and a.degraded == rungs
        assert a.stats == r.stats and a.dirty == r.dirty
    # no rung changes the port's backend: every attempt mined on "kernel",
    # the retried ones included (the reference's rung 2 switches to "xla")
    assert DEGRADATION_LADDER[1] == "single_device"
    assert len(mined_on) == len(feed) + times and set(mined_on) == {"kernel"}
    for n in PORTFOLIO:
        np.testing.assert_array_equal(ours.pattern_counts(n), ref.pattern_counts(n), err_msg=n)


def test_poisoned_batch_is_quarantined_like_jax():
    ours = ResilientDetectionService(PORTFOLIO, window=W, thresholds=THRESH, device="cpu", backend="torch")
    ref = JaxResilient(PORTFOLIO, window=W, thresholds=THRESH)
    for b in _batches(2, n_batches=3):
        ours.submit(*b)
        ref.submit(*b)
    src, dst, t, amt, bad = make_poisoned_batch(np.random.default_rng(3), t_base=6000)
    a, r = ours.submit(src, dst, t, amt).report, ref.submit(src, dst, t, amt).report
    assert a.quarantined == r.quarantined == int(bad.sum()) > 0
    assert a.n_new == r.n_new == int((~bad).sum())
    # NaN amounts make the records unequal to themselves: compare as JSON
    assert json.dumps(ours.dead_letters) == json.dumps(ref.dead_letters)
    assert ours.totals == ref.totals
    assert store_states_equal(ours.store.state_dict(), ref.store.state_dict())


@pytest.mark.parametrize("point", ["ingest", "mine", "gather", "score"])
def test_failed_tick_rolls_back_bit_exactly(point):
    chaos = FaultInjector()
    svc = DetectionService(PORTFOLIO, window=W, thresholds=THRESH, retain="auto", lateness=800,
                           chaos=chaos, device="cpu")
    feed = _batches(4, n_batches=8)
    for b in feed[:4]:
        svc.submit(*b)
    pre = _state(svc)
    chaos.arm(point, times=1, exc=InjectedFault)
    with pytest.raises(InjectedFault):
        svc.submit(*feed[4])
    assert chaos.log == [(point, pre[2] + 1)]
    _assert_state_equal(pre, _state(svc))
    chaos.disarm()
    ref = DetectionService(PORTFOLIO, window=W, thresholds=THRESH, retain="auto", lateness=800, device="cpu")
    for b in feed:
        ref.submit(*b)
    for b in feed[4:]:
        svc.submit(*b)
    _assert_state_equal(_state(ref), _state(svc))


def test_wal_checkpoint_recovery_matches_live_and_jax(tmp_path, monkeypatch):
    feed = _batches(5, n_batches=10, n_edges=700, t_span=40_000)
    kw = dict(thresholds=THRESH, retain="auto", lateness=4096)
    cfg = ResilienceConfig(wal_dir=str(tmp_path / "wal"), checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=4)
    jcfg = JaxConfig(wal_dir=str(tmp_path / "jwal"), checkpoint_dir=str(tmp_path / "jckpt"), checkpoint_every=4)
    svc = ResilientDetectionService(PORTFOLIO, window=W, resilience=cfg, device="cpu", **kw)
    ref = JaxResilient(PORTFOLIO, window=W, resilience=jcfg, **kw)
    for b in feed:
        svc.submit(*b)
        ref.submit(*b)
    assert svc.store.stats["edges_evicted"] > 0 and svc.wal.ticks() == ref.wal.ticks() == [9, 10]
    live = _state(svc)
    _assert_state_equal(live, _state(ref))
    del svc
    mined_on = []
    dispatch = ResilientDetectionService._dispatch_mine

    def spy(self, *a, **k):
        mined_on.append(self.backend)
        return dispatch(self, *a, **k)

    monkeypatch.setattr(ResilientDetectionService, "_dispatch_mine", spy)
    rec = ResilientDetectionService.recover(PORTFOLIO, window=W, resilience=cfg, device="cpu", **kw)
    monkeypatch.undo()
    # the WAL tail (ticks 9 and 10) replays on the service's own backend
    assert mined_on == ["kernel", "kernel"]
    jrec = JaxResilient.recover(PORTFOLIO, window=W, resilience=jcfg, **kw)
    _assert_state_equal(live, _state(rec))
    _assert_state_equal(_state(jrec), _state(rec))
    assert rec.stats == jrec.stats  # the WAL replay's counters too
    # the recovered service streams on like the uninterrupted one
    extra = _batches(6, n_batches=1, n_edges=60, t_span=1000)[0]
    extra = (extra[0], extra[1], extra[2] + 40_000, extra[3])
    rec.submit(*extra)
    ref.submit(*extra)
    _assert_state_equal(_state(rec), _state(ref))


def test_numpy_checkpoint_round_trip_and_jax_layout(tmp_path):
    rng = np.random.default_rng(0)
    tree = {
        "store": {"cols": {"src": rng.integers(0, 9, 7).astype(np.int32), "t": np.arange(7, dtype=np.int64)},
                  "meta": np.array([1, -1], np.int64)},
        "counts": {"fan_in": np.arange(5, dtype=np.int64)},
        "exec": np.zeros(8, np.int64),
        "list": [np.float32(2.5) * np.ones(3, np.float32), np.array(3, np.int64)],
    }
    for step in (3, 8, 12):
        save_checkpoint(str(tmp_path / "c"), step, tree, extra={"tick": step})
    (tmp_path / "c" / "step_00000020").mkdir()  # an aborted write: no COMMIT
    assert latest_step(str(tmp_path / "c")) == 12
    got, step, extra = restore_checkpoint(str(tmp_path / "c"), tree)
    assert step == 12 and extra == {"tick": 12}
    _trees_equal(got, tree)
    prune(str(tmp_path / "c"), keep=2)
    assert latest_step(str(tmp_path / "c")) == 12
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == ["step_00000008", "step_00000012"]
    # a checkpoint the JAX package wrote restores here, dtypes included
    jax_save(str(tmp_path / "j"), 5, tree, extra={"tick": 5})
    got, step, _ = restore_checkpoint(str(tmp_path / "j"), tree)
    assert step == 5
    _trees_equal(got, tree)


def _trees_equal(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _trees_equal(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _trees_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
