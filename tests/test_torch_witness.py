"""The port's witness extraction (``repro_torch.witness``) against the
JAX package's: the ``tests/test_witness.py`` matrix held to the port's
``GFPReference`` under both kernel backends (on the CPU ``"kernel"``
takes the plain ``intersect_count``; witness cubes broadcast on both),
``repro_torch.witness.extract.mine_witnesses`` against
``repro.witness.extract.mine_witnesses`` (counts, eids and ``stats`` key
for key), and the session's witness mode against the JAX session's.
Witness eids and counts are integers: every comparison is exact."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api.session import MiningSession as JaxSession
from repro.core.compiler import CompiledPattern as JaxCompiled
from repro.core.patterns import build_pattern as jax_build
from repro.witness.extract import mine_witnesses as jax_mine_witnesses
from repro_torch.api import MiningSession
from repro_torch.convert import graph_from_reference
from repro_torch.core.compiler import CompiledPattern
from repro_torch.core.oracle import GFPReference
from repro_torch.core.patterns import PATTERN_NAMES, build_pattern
from repro_torch.witness import witness_layout
from repro_torch.witness.extract import mine_witnesses
from tests.conftest import random_temporal_graph

W = 96
BACKENDS = ("kernel", "torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The eager CPU ops here are small: under the suite's six xdist
    workers on the same cores, torch's intra-op threads oversubscribe
    them and a witness mine runs about 5x slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(seed, **kw):
    return graph_from_reference(random_temporal_graph(np.random.default_rng(seed), **kw))


def _assert_parity(spec, g, seeds, k, backend, **cp_kw):
    cp = CompiledPattern(spec, g, backend=backend, device="cpu", **cp_kw)
    w = cp.mine(seeds, witnesses=k)
    oc, ow = GFPReference(spec, g).mine_witnesses(seeds, k=k)
    np.testing.assert_array_equal(w.counts, oc)
    n = g.n_edges if seeds is None else len(seeds)
    for i in range(n):
        assert w.tuples(i) == ow[i][:k], (spec.name, i)
    return cp, w


# ---------------------------------------------------------------------------
# 1. oracle exactness, whole pattern library
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small(small_graph):
    return graph_from_reference(small_graph)


@pytest.mark.parametrize("name", PATTERN_NAMES)
def test_witnesses_match_oracle(small, name):
    """The witness callables never read the kernel backend (their compare
    cubes broadcast on both), so the witness mine runs once; the counting
    mine it must equal runs under both backends."""
    spec = build_pattern(name, 4096)
    rng = np.random.default_rng(0)
    seeds = rng.choice(small.n_edges, size=min(60, small.n_edges), replace=False).astype(np.int32)
    cp, w = _assert_parity(spec, small, seeds, 3, "kernel")
    # ONE combined counts+ids fetch per mine
    assert cp.stats["host_syncs"] == 1
    # witness-mode counts == counting-mode counts, bit for bit
    for backend in BACKENDS:
        np.testing.assert_array_equal(
            w.counts, CompiledPattern(spec, small, backend=backend, device="cpu").mine(seeds)
        )
    assert w.n_hops == len(witness_layout(cp.ir))
    assert w.eids.shape == (len(seeds), 3, w.n_hops)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", PATTERN_NAMES)
def test_witnesses_tied_timestamps(name, backend):
    """t_max=16: heavy timestamp collisions, the arrival-order tiebreak;
    both backends select the same witnesses with the same counters."""
    g = _graph(4, n_nodes=12, n_edges=120, t_max=16)
    cp, w = _assert_parity(build_pattern(name, W), g, None, 3, backend)
    other = CompiledPattern(build_pattern(name, W), g, backend=BACKENDS[backend == "kernel"], device="cpu")
    np.testing.assert_array_equal(other.mine(witnesses=3).eids, w.eids)
    assert other.stats == cp.stats


@pytest.mark.parametrize("backend", BACKENDS)
def test_witnesses_duplicate_seeds(backend):
    g = _graph(1, n_nodes=16, n_edges=120, t_max=256)
    seeds = np.array([5, 5, 17, 5, 17, 0], dtype=np.int32)
    for name in ("fan_in", "cycle3", "counterparty"):
        _assert_parity(build_pattern(name, W), g, seeds, 2, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_witnesses_k_exceeds_matches(backend):
    """k far above any count: n_found == count, padding rows stay -1."""
    g = _graph(2, n_nodes=16, n_edges=100, t_max=256)
    cp, w = _assert_parity(build_pattern("cycle3", W), g, None, 50, backend)
    assert np.array_equal(w.n_found, np.minimum(w.counts, 50))
    empty = np.flatnonzero(w.counts == 0)
    assert empty.size > 0
    for i in empty[:5]:
        assert w.tuples(int(i)) == []
        assert (w.eids[i] == -1).all()
    for i in np.flatnonzero(w.counts > 0)[:5]:
        assert (w.eids[int(i), int(w.n_found[i]) :] == -1).all()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("strategy", ["bs1", "bs2", "pw"])
@pytest.mark.parametrize("name", ["cycle4", "cycle5", "reciprocal"])
def test_witness_strategies_match_oracle(name, strategy, backend):
    """Every forced intersect strategy (bs2 remapped to bs1 in the
    bulk-only schedule) selects the same canonical witnesses."""
    g = _graph(11, n_nodes=18, n_edges=140, t_max=256)
    _assert_parity(build_pattern(name, W), g, None, 3, backend, force_strategy=strategy)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["sweeps", "chunked"])
@pytest.mark.parametrize("name", ["cycle5", "peel_chain", "scatter_gather"])
def test_witness_sweeps_and_chunking(name, mode, backend):
    """Hub-tail sweep grids (tiny ladder) and tiny-batch chunking do not
    change the selected witnesses."""
    g = _graph(11, n_nodes=18, n_edges=140, t_max=256)
    kw = {"ladder": (2, 4)} if mode == "sweeps" else {"batch_elem_cap": 1 << 8}
    cp, _ = _assert_parity(build_pattern(name, W), g, None, 3, backend, **kw)
    if mode == "sweeps":
        assert any(len(key) > 4 and key[1] == "wit" and max(key[4]) > 1 for key in cp._kernels)


def test_witness_k_validation():
    g = _graph(3, n_nodes=8, n_edges=40, t_max=64)
    cp = CompiledPattern(build_pattern("fan_in", W), g, device="cpu")
    with pytest.raises(ValueError):
        mine_witnesses(cp, None, 0)
    w = mine_witnesses(cp, np.zeros(0, np.int32), 2)
    assert w.eids.shape == (0, 2, 1) and cp.stats["host_syncs"] == 0


def test_witness_translate_and_resolve():
    g = _graph(6, n_nodes=16, n_edges=100, t_max=256)
    w = CompiledPattern(build_pattern("cycle3", W), g, device="cpu").mine(witnesses=2)
    base = 1000
    wt = w.translate(np.arange(g.n_edges, dtype=np.int64) + base)
    m = w.eids >= 0
    assert np.array_equal(wt.eids[m], w.eids[m] + base)
    assert (wt.eids[~m] == -1).all()

    def fields(eids):
        e = np.asarray(eids, dtype=np.int64)
        return g.src[e], g.dst[e], g.t[e], g.amount[e]

    resolved = w.resolve(fields)
    assert len(resolved) == g.n_edges
    for i in range(g.n_edges):
        assert len(resolved[i]) == int(w.n_found[i])
        for j, wit in enumerate(resolved[i]):
            for p, hop in enumerate(wit):
                e = int(w.eids[i, j, p])
                assert hop["eid"] == e
                if e >= 0:
                    assert (hop["src"], hop["dst"], hop["t"]) == (int(g.src[e]), int(g.dst[e]), int(g.t[e]))


# ---------------------------------------------------------------------------
# 2. against the JAX package's extraction: counts, eids, stats key for key
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_graph():
    return random_temporal_graph(np.random.default_rng(17), n_nodes=16, n_edges=120, t_max=256)


@pytest.mark.parametrize("name", PATTERN_NAMES)
def test_extraction_matches_jax(jax_graph, name):
    seeds = np.arange(0, jax_graph.n_edges, 2, dtype=np.int32)
    ref_cp = JaxCompiled(jax_build(name, W), jax_graph, ladder=(2, 4, 16))
    want = jax_mine_witnesses(ref_cp, seeds, 3)
    cp = CompiledPattern(build_pattern(name, W), graph_from_reference(jax_graph), ladder=(2, 4, 16), device="cpu")
    got = mine_witnesses(cp, seeds, 3)
    assert [dataclasses.astuple(h) for h in got.hops] == [dataclasses.astuple(h) for h in want.hops]
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.n_found, want.n_found)
    np.testing.assert_array_equal(got.eids, want.eids)
    assert cp.stats == ref_cp.stats
    # a second mine replays the schedule and every launch shape
    mine_witnesses(cp, seeds, 3)
    jax_mine_witnesses(ref_cp, seeds, 3)
    assert cp.stats == ref_cp.stats and cp.stats["schedule_hits"] == 1


# ---------------------------------------------------------------------------
# 3. session layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_session_witness_mode_matches_jax(backend):
    jg = random_temporal_graph(np.random.default_rng(5), n_nodes=20, n_edges=140, t_max=256)
    g = graph_from_reference(jg)
    names = ["fan_in", "cycle3", "stack", "scatter_gather"]  # fan_in/stack are fused seed-local
    sess = MiningSession(g, device="cpu", kernel_backend=backend)
    ref = JaxSession(jg)
    for n in names:
        sess.register(build_pattern(n, W))
        ref.register(jax_build(n, W))
    seeds = np.arange(jg.n_edges, dtype=np.int32)
    plain = sess.mine(names, seeds)
    res = sess.mine(names, seeds, witnesses=2)
    want = ref.mine(names, seeds, witnesses=2)
    np.testing.assert_array_equal(plain.counts, res.counts)
    np.testing.assert_array_equal(res.counts, want.counts)
    assert res.fused == () and set(res.witnesses) == set(names)
    # one host sync per unique plan, and the counters equal the JAX session's
    assert res.stats["host_syncs"] == len(names)
    assert res.stats == want.stats
    for n in names:
        np.testing.assert_array_equal(res.witnesses[n].eids, want.witnesses[n].eids, err_msg=n)
        oc, ow = GFPReference(build_pattern(n, W), g).mine_witnesses(seeds, k=2)
        np.testing.assert_array_equal(res.witnesses[n].counts, oc)
        assert all(res.witnesses[n].tuples(i) == ow[i][:2] for i in range(len(seeds)))
    # the standalone plans of fused patterns are kept and replayed
    again = sess.mine(names, seeds, witnesses=2)
    assert again.stats["schedule_hits"] == len(names)
    with pytest.raises(ValueError):
        sess.mine(names, seeds, backend="oracle", witnesses=2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_witness_schedules_do_not_outlive_a_view(backend):
    """A streaming service gives every tick's plan one schedule cache in
    "shape" mode; a witness mine on the next tick's view must not replay
    a schedule staged from an earlier view for the same local seed ids."""
    from collections import OrderedDict

    spec = build_pattern("scatter_gather", W)
    cache = OrderedDict()
    seeds = np.arange(16, dtype=np.int32)
    for seed in (21, 22, 21):
        g = _graph(seed, n_nodes=18, n_edges=140, t_max=256)
        cp = CompiledPattern(spec, g, backend=backend, device="cpu", schedule_cache=cache, schedule_mode="shape")
        w = mine_witnesses(cp, seeds, 2)
        oc, ow = GFPReference(spec, g).mine_witnesses(seeds, k=2)
        np.testing.assert_array_equal(w.counts, oc)
        for i in range(len(seeds)):
            assert w.tuples(i) == ow[i][:2], (seed, i)
