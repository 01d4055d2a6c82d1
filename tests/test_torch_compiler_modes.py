"""The port's CompiledPattern against the JAX package's down every
execution path that varies per seed: forced bs1/bs2/pw, a tiny ladder
with tail sweeps, the hub branch decomposition, chunking, and schedule
replay, on a dense random graph where counts are nonzero; plus the deep,
union, difference and fuzzy library patterns against the enumerator.
Counts AND ``stats`` dicts must be equal (``_pair``)."""
import numpy as np
import pytest

import repro.core.compiler as JC
import repro_torch.core.compiler as TC
from repro.core.oracle import GFPReference
from repro.core.patterns import PATTERN_NAMES, build_pattern, feature_pattern_set
from repro_torch.convert import graph_from_reference, spec_from_reference
from tests.conftest import random_temporal_graph
from tests.test_torch_compiler import BACKENDS, _pair

W = 96
FULL = feature_pattern_set("full")


@pytest.fixture(scope="module")
def dense():
    g = random_temporal_graph(np.random.default_rng(11), n_nodes=18, n_edges=140, t_max=256)
    return g, graph_from_reference(g)


@pytest.mark.parametrize("name", ["cycle3", "cycle4", "scatter_gather"])
def test_dense_graph_nonzero_counts(dense, name):
    """The dense graph gives the compiled patterns nonzero counts; the
    second mine replays the cached schedule (schedule_hits)."""
    spec = build_pattern(name, W)
    ref, got = _pair(spec, dense, *BACKENDS[0], n_mines=2)
    assert got.sum() > 0
    np.testing.assert_array_equal(got, GFPReference(spec, dense[0]).mine())


# cycle3's pairwise count_edges knows only bs (forced bs1/bs2) and pw
FORCED = [
    (name, strategy)
    for name in ("cycle4", "scatter_gather", "cycle3")
    for strategy in (("bs1", "bs2", "pw") if name != "cycle3" else ("bs1", "pw"))
]


@pytest.mark.parametrize("name,strategy", FORCED)
def test_forced_strategies(dense, name, strategy):
    backends = BACKENDS[0] if strategy == "pw" else BACKENDS[1]
    _pair(build_pattern(name, W), dense, *backends, force_strategy=strategy)


@pytest.mark.parametrize("name", ["cycle3", "cycle4", "counterparty", "peel_chain"])
def test_tiny_ladder_sweeps(dense, name):
    """A minuscule ladder forces tail sweeps at every level (and one-off
    geometric-grid union buckets); the sweep loop runs inside the port's
    kernel callable, one call per swept bucket like the JAX fori_loop."""
    _pair(build_pattern(name, W), dense, *BACKENDS[0], ladder=(2, 4))


@pytest.mark.parametrize("name", ["cycle3", "cycle4", "scatter_gather", "cycle5"])
def test_branch_mode(dense, name, monkeypatch):
    """Every seed down the per-branch hub path in both packages."""
    monkeypatch.setattr(JC, "BRANCH_DECOMP_COST", -1.0)
    monkeypatch.setattr(TC, "BRANCH_DECOMP_COST", -1.0)
    ref, _ = _pair(build_pattern(name, W), dense, *BACKENDS[0])
    np.testing.assert_array_equal(ref, GFPReference(build_pattern(name, W), dense[0]).mine())


def test_chunked(dense):
    _pair(build_pattern("cycle4", W), dense, *BACKENDS[0], batch_elem_cap=1 << 8)


@pytest.mark.parametrize("name", sorted(set(PATTERN_NAMES) - set(FULL)))
def test_other_library_patterns_match_oracle(dense, name):
    """Deep, union, difference and fuzzy patterns: port == enumerator."""
    spec = build_pattern(name, W)
    got = TC.CompiledPattern(spec_from_reference(spec), dense[1], device="cpu").mine()
    np.testing.assert_array_equal(got, GFPReference(spec, dense[0]).mine())
