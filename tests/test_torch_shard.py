"""The port's sharded mining executor (``repro_torch.core.shard``,
``MiningSession.mine(backend="sharded")``) against the JAX package's, on
the small graphs of ``tests/test_shard.py``.

On the CPU the port's mining devices are the lanes of
``repro_torch.launch.mesh.ensure_host_devices``: one lane is the inline
dispatch of one card, four lanes run the per-device dispatch pool, the
round-robin and the device-side sum on four names over one CPU replica.
The JAX side runs on its one CPU device (its multi-device path needs a
subprocess).  Cases: sharded counts equal to JAX ``compiled`` and JAX
``sharded`` for n_parts in {1, 2, 3, 5} under 1 and 4 lanes with both
gather modes forced; duplicate seeds, empty and tiny partitions; one host
sync and per-shard stats that sum to the totals; concurrent dispatch and
concurrent mines hammering the shared caches (exact counts, the launch
shapes counted once); liveness with a heartbeat dir, the overlap ratio
and the balance; the device list and the tree form of the host gather.
"""
import functools
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro.api import MiningSession as JaxSession
from repro_torch.api import MiningSession
from repro_torch.convert import graph_from_reference
from repro_torch.core import executor, shard
from repro_torch.launch import mesh
from tests.conftest import random_temporal_graph

W = 96
PATS = ("fan_in", "cycle3", "scatter_gather")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager CPU ops: torch's intra-op threads would oversubscribe
    the suite's xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_graph():
    return random_temporal_graph(np.random.default_rng(13), n_nodes=18, n_edges=140, t_max=256)


@pytest.fixture(scope="module")
def graph(jax_graph):
    return graph_from_reference(jax_graph)


@pytest.fixture(scope="module")
def jax_session(jax_graph):
    return JaxSession(jax_graph, window=W).register(*PATS)


@pytest.fixture(params=[1, 4], ids=["1lane", "4lanes"])
def lanes(request):
    assert mesh.ensure_host_devices(request.param, device="cpu") == request.param
    yield request.param
    mesh.ensure_host_devices(1, device="cpu")


def _session(graph, *pats, **kw):
    return MiningSession(graph, window=W, device="cpu", **kw).register(*(pats or PATS))


@pytest.mark.parametrize("n_parts", [1, 2, 3, 5])
@pytest.mark.parametrize("forced", [None, True, False], ids=["auto", "collective", "host"])
def test_sharded_equals_jax(graph, jax_session, lanes, n_parts, forced, monkeypatch):
    if forced is not None:
        monkeypatch.setattr(shard, "run_sharded", functools.partial(shard.run_sharded, collective=forced))
    session = _session(graph)
    res = session.mine(backend="sharded", n_parts=n_parts)
    want = jax_session.mine()
    jax_sharded = jax_session.mine(backend="sharded", n_parts=n_parts)
    np.testing.assert_array_equal(res.counts, want.counts)
    np.testing.assert_array_equal(res.counts, jax_sharded.counts)
    mode = {True: "collective", False: "host"}.get(forced, "collective" if n_parts <= lanes else "host")
    assert res.gather_mode == mode
    assert res.stats["host_syncs"] == 1
    assert len(res.shard_devices) == n_parts
    assert set(res.shard_devices) == {f"cpu:{p % lanes}" for p in range(n_parts)}
    if res.gather_mode == jax_sharded.gather_mode:
        # same partitions, same launches, same bytes (the launch-shape and
        # schedule-cache counters depend on each session's history: see
        # test_stats_equal_jax_from_fresh_sessions)
        drop = lambda st: {k: v for k, v in st.items() if k not in ("jit_cache_entries", "schedule_hits")}
        assert drop(res.stats) == drop(jax_sharded.stats)
        assert [drop(st) for st in res.shard_stats] == [drop(st) for st in jax_sharded.shard_stats]


@pytest.mark.parametrize("n_parts, mode", [(1, "collective"), (3, "host")])
def test_stats_equal_jax_from_fresh_sessions(graph, jax_graph, n_parts, mode):
    """Fresh sessions on both sides, the same mines in the same order: the
    sharded stats dicts (whole mine and per shard) equal the reference's
    key for key, launch shapes and schedule replays included."""
    jax_s = JaxSession(jax_graph, window=W).register(*PATS)
    port_s = _session(graph)
    for _ in range(2):  # the second mine replays the partitions' schedules
        want = jax_s.mine(backend="sharded", n_parts=n_parts)
        got = port_s.mine(backend="sharded", n_parts=n_parts)
        np.testing.assert_array_equal(got.counts, want.counts)
        assert got.gather_mode == want.gather_mode == mode
        assert got.stats == want.stats
        assert got.shard_stats == want.shard_stats


@pytest.mark.parametrize(
    "seeds, n_parts",
    [([5, 5, 7, 11, 5], 3), ([], 3), ([3, 9], 5), ([0, 1, 2, 1], 3), ([5, 5, 7, 11], 1)],
    ids=["duplicates", "empty", "more_parts_than_seeds", "python_list", "one_part"],
)
@pytest.mark.parametrize("forced", [None, True, False], ids=["auto", "collective", "host"])
def test_seed_shapes_equal_jax(graph, jax_session, lanes, seeds, n_parts, forced, monkeypatch):
    if forced is not None:
        monkeypatch.setattr(shard, "run_sharded", functools.partial(shard.run_sharded, collective=forced))
    session = _session(graph)
    want = jax_session.mine(seeds=np.asarray(seeds, dtype=np.int32))
    got = session.mine(seeds=seeds, backend="sharded", n_parts=n_parts)
    assert got.counts.shape == (len(seeds), len(PATS))
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.counts, session.mine(seeds=np.asarray(seeds, dtype=np.int32)).counts)
    assert got.stats["host_syncs"] == 1
    if not seeds and forced is None:
        assert got.gather_mode == "host"  # an empty mine skips the device-side sum


@pytest.mark.parametrize("n_parts", [1, 3, 6])
def test_shard_stats_sum_to_mine_totals(graph, lanes, n_parts):
    """The launch-side counters of the shards sum to the mine's; the sync
    side (host_syncs, bytes_d2h) is the gather's alone."""
    res = _session(graph, "fan_in", "cycle3").mine(backend="sharded", n_parts=n_parts)
    assert len(res.shard_stats) == n_parts
    for key in executor.STAT_KEYS:
        if key in ("host_syncs", "bytes_d2h"):
            assert all(st[key] == 0 for st in res.shard_stats), key
        else:
            assert res.stats[key] == sum(st[key] for st in res.shard_stats), key
    assert res.stats["host_syncs"] == 1 and res.stats["bytes_d2h"] > 0


def test_full_portfolio_bit_exact_one_sync_and_replay(graph, lanes):
    from repro_torch.core.patterns import PATTERN_NAMES

    session = _session(graph, *PATTERN_NAMES)
    base = session.mine()
    got = session.mine(backend="sharded")
    np.testing.assert_array_equal(got.counts, base.counts)
    assert got.backend == "sharded" and got.stats["host_syncs"] == 1
    assert got.stats["kernel_calls"] > 1 and "fan_in" in got.fused
    assert got.partition_plan.n_parts == lanes  # one partition per mining device by default
    bal = got.shard_balance()
    assert set(bal) == {"predicted_cost_skew", "kernel_call_skew", "padded_element_skew"}
    assert all(v >= 1.0 for v in bal.values())
    again = session.mine(backend="sharded")
    np.testing.assert_array_equal(again.counts, base.counts)
    assert again.stats["host_syncs"] == 1 and again.stats["schedule_hits"] > 0


def test_liveness_overlap_and_balance(graph, tmp_path):
    mesh.ensure_host_devices(4, device="cpu")
    try:
        hb_dir = str(tmp_path / "hb")
        session = _session(graph, "fan_in", "cycle3", shard_heartbeat_dir=hb_dir)
        res = session.mine(backend="sharded")
        lv = res.worker_liveness
        devices = set(res.shard_devices)
        assert devices == {"cpu:0", "cpu:1", "cpu:2", "cpu:3"}
        assert set(lv["last_beat"]) == devices and set(lv["wall_medians"]) == devices
        assert all(n >= 2 for n in lv["beats"].values())  # pickup + done
        assert isinstance(lv["stragglers"], list)
        assert set(lv["alive"]) == devices
        assert {f[:-3] for f in os.listdir(hb_dir) if f.endswith(".hb")} == devices
        assert res.dispatch_wall_s > 0 and res.dispatch_overlap_ratio() > 0
        assert len(res.per_shard_seconds) == 4
        res2 = session.mine(backend="sharded")
        assert all(res2.worker_liveness["beats"][d] > lv["beats"][d] for d in devices)
        plain = _session(graph, "fan_in").mine(backend="sharded")
        assert plain.worker_liveness["alive"] is None
        # the beats also land in the metrics registry
        from repro_torch.obs import metrics as obs_metrics

        snap = obs_metrics.get_registry().snapshot()
        assert any("repro_shard_worker_beats" in k and "cpu:3" in k for k in snap)
    finally:
        mesh.ensure_host_devices(1, device="cpu")
    compiled = _session(graph, "fan_in").mine()
    assert compiled.dispatch_overlap_ratio() is None and compiled.shard_balance() is None


def test_concurrent_dispatch_hammers_shared_caches(graph):
    """Eight threads mine interleaved seed sets through one compiled plan
    with a 2-entry schedule LRU, chunk coalescing on, while the fused
    seed-local plan is hammered through the same session: every result is
    exact, and each launch shape is counted once across the threads."""
    session = _session(graph)
    session.compile()
    cp = session._compiled[session._canon_of["scatter_gather"]]
    cp.schedule_cache_cap = 2
    fused = session._fused
    unit_sel = tuple(range(fused.n_units))
    rng = np.random.default_rng(5)
    seed_sets = [np.array([5, 5, 7, 11, 5], dtype=np.int32), np.array([], dtype=np.int32)] + [
        rng.integers(0, graph.n_edges, size=n).astype(np.int32) for n in (1, 3, 7, 12, 20, 9)
    ]
    expect_cp = [cp.mine(s) for s in seed_sets]
    expect_units = [fused.mine_units(s, executor.new_stats(), unit_sel) for s in seed_sets]
    keys_before = len(cp._trace_keys)

    def mine_one(i):
        s = seed_sets[i % len(seed_sets)]
        st = executor.new_stats()
        col = cp.mine_async(s, stats=st, coalesce=2).numpy().astype(np.int64)
        units = fused.launch_units(s, st, unit_sel, device="cpu", coalesce=2).numpy()[: len(s)].astype(np.int64)
        return i, col, units, st

    new_entries = 0
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        with ThreadPoolExecutor(max_workers=8) as pool:
            for i, col, units, st in pool.map(mine_one, range(64), timeout=300):
                j = i % len(seed_sets)
                np.testing.assert_array_equal(col, expect_cp[j])
                np.testing.assert_array_equal(units, expect_units[j])
                new_entries += st["jit_cache_entries"]
    finally:
        sys.setswitchinterval(switch)
    # a lost update of the shared launch-shape set would break this sum
    assert keys_before + new_entries == len(cp._trace_keys)


def test_concurrent_sharded_mines_from_threads(graph, lanes):
    session = _session(graph, "fan_in", "cycle3")
    seeds = np.array([5, 5, 7, 11, 2, 9, 0], dtype=np.int32)
    base = session.mine(seeds=seeds)
    sequential = session.mine(seeds=seeds, backend="sharded", n_parts=3)

    def mine_one(i):
        return session.mine(seeds=seeds, backend="sharded", n_parts=1 + (i % 3))

    with ThreadPoolExecutor(max_workers=4) as pool:
        for i, res in enumerate(pool.map(mine_one, range(12))):
            np.testing.assert_array_equal(res.counts, base.counts)
            assert res.stats["host_syncs"] == 1
            if i % 3 == 2:
                for key in ("kernel_calls", "padded_elements", "bytes_h2d", "bytes_d2h"):
                    assert res.stats[key] == sequential.stats[key], key


def test_mining_devices_and_mesh():
    assert mesh.ensure_host_devices(3, device="cpu") == 3
    try:
        devs = shard.mining_devices(device="cpu")
        assert [str(d) for d in devs] == ["cpu:0", "cpu:1", "cpu:2"]
        assert [str(d) for d in shard.mining_devices(2, device="cpu")] == ["cpu:0", "cpu:1"]
        assert len(shard.mining_devices(99, device="cpu")) == 3  # degrades to the visible set
        assert mesh.make_shard_mesh(devs[1:]) == devs[1:]
    finally:
        mesh.ensure_host_devices(1, device="cpu")
    assert mesh.host_lanes() == 1
    with pytest.raises(ValueError):
        mesh.make_shard_mesh([])
    # the LM's meshes (A12b) want the CUDA card by default and a process group
    for fn in (mesh.make_production_mesh, mesh.make_local_mesh):
        with pytest.raises(RuntimeError, match="CUDA device|process group"):
            fn()
        with pytest.raises(RuntimeError, match="process group"):
            fn(device="cpu")


def test_replica_is_the_mirror_on_every_cpu_lane(graph):
    session = _session(graph, "fan_in")
    session.compile()
    ctx = shard.ShardContext(session._dg, devices=["cpu:0", "cpu:1"])
    assert ctx.replica("cpu:1") is session._dg and ctx.replica(torch.device("cpu", 0)) is session._dg
    assert ctx.device_for(3) == torch.device("cpu", 1)


def test_gather_tree_form_one_sync():
    stats = executor.new_stats()
    outs = [{"a": torch.arange(6, dtype=torch.int32).reshape(3, 2), "b": torch.tensor([7], dtype=torch.int32)},
            {"a": torch.zeros((0, 2), dtype=torch.int32), "b": torch.tensor([8, 9], dtype=torch.int32)}]
    host = shard.gather(outs, stats)
    assert isinstance(host, list) and len(host) == 2
    np.testing.assert_array_equal(host[0]["a"], np.arange(6).reshape(3, 2))
    np.testing.assert_array_equal(host[1]["b"], [8, 9])
    assert host[1]["a"].shape == (0, 2)
    assert stats["host_syncs"] == 1 and stats["bytes_d2h"] == 4 * 9
    single = shard.gather({"x": torch.tensor([1, 2], dtype=torch.int32)}, stats)
    assert isinstance(single, dict) and stats["host_syncs"] == 2
    with pytest.raises(TypeError):
        shard.gather({"x": torch.zeros(1), "y": torch.zeros(1, dtype=torch.int32)}, stats)


def test_place_rows_drops_out_of_range_rows():
    vec = torch.tensor([[1, 2], [3, 4], [5, 6], [9, 9]], dtype=torch.int32)  # last row: ladder padding
    rows = torch.tensor([2, 0, 7], dtype=torch.int64)  # 7 is past n_total: dropped
    out = shard._place_rows(vec, rows, 3)
    np.testing.assert_array_equal(out.numpy(), [[3, 4], [0, 0], [1, 2]])
