"""The port's GFPReference (a numpy copy of ``repro.core.oracle``) against
the JAX package's, pattern by pattern, and the port session's
``backend="oracle"`` against its compiled backends and the JAX session."""
import numpy as np
import pytest

from repro.api import MiningSession as JaxSession
from repro.core.oracle import GFPReference as JaxGFP
from repro.core.patterns import build_pattern as jax_build, feature_pattern_set
from repro_torch.api import MiningSession
from repro_torch.convert import graph_from_reference
from repro_torch.core import GFPReference
from repro_torch.core.patterns import build_pattern
from tests.conftest import random_temporal_graph

W = 96
DEEP = feature_pattern_set("full_deep")


@pytest.fixture(scope="module")
def graphs():
    g = random_temporal_graph(np.random.default_rng(21), n_nodes=20, n_edges=150, t_max=256)
    return g, graph_from_reference(g)


@pytest.mark.parametrize("name", DEEP)
def test_gfp_reference_matches_jax(graphs, name):
    g, tg = graphs
    want = JaxGFP(jax_build(name, W), g)
    got = GFPReference(build_pattern(name, W), tg)
    np.testing.assert_array_equal(got.mine(), want.mine())
    seeds = np.arange(0, g.n_edges, 3, dtype=np.int32)
    for k in (None, 2):
        gc, gw = got.mine_witnesses(seeds, k=k)
        wc, ww = want.mine_witnesses(seeds, k=k)
        np.testing.assert_array_equal(gc, wc)
        assert gw == ww


@pytest.mark.parametrize("backends", [("pallas", "kernel"), ("xla", "torch")], ids=["kernel", "torch"])
def test_oracle_backend_equals_compiled_and_jax(graphs, backends):
    g, tg = graphs
    session = MiningSession(tg, window=W, kernel_backend=backends[1], device="cpu").register(*DEEP)
    orc = session.mine(backend="oracle")
    comp = session.mine()
    np.testing.assert_array_equal(orc.counts, comp.counts)
    assert orc.backend == "oracle" and orc.columns == tuple(DEEP)
    assert orc.stats == {k: 0 for k in orc.stats}
    jax = JaxSession(g, window=W, kernel_backend=backends[0]).register(*DEEP).mine(backend="oracle")
    np.testing.assert_array_equal(orc.counts, jax.counts)
    # canonical duplicates share one oracle, and a re-mine reuses it
    seeds = np.array([4, 4, 0, 17], np.int32)
    again = session.mine(seeds=seeds, backend="oracle")
    np.testing.assert_array_equal(again.counts, comp.counts[seeds])
    assert len(session._oracles) == len(session._members)
