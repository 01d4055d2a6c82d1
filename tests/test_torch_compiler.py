"""The port's CompiledPattern against the JAX package's and against the
GFP-reference enumerator: exact counts AND equal ``stats`` dicts, key for
key, for ``backend="kernel"|"torch"`` (the counterparts of
``"pallas"|"xla"``), on the 9 ``"full"`` patterns; the IR facts, the
backend names and the device rules.  The execution modes (forced
strategies, tail sweeps, branch mode, chunking, replay) are in
``tests/test_torch_compiler_modes.py``."""
import numpy as np
import pytest
import torch

import repro.core.compiler as JC
import repro_torch.core.compiler as TC
from repro.core.oracle import GFPReference
from repro.core.patterns import build_pattern, feature_pattern_set
from repro_torch.convert import graph_from_reference, spec_from_reference
from tests.conftest import random_temporal_graph

W = 96
FULL = feature_pattern_set("full")
BACKENDS = [("pallas", "kernel"), ("xla", "torch")]


@pytest.fixture(scope="module")
def dense():
    g = random_temporal_graph(np.random.default_rng(11), n_nodes=18, n_edges=140, t_max=256)
    return g, graph_from_reference(g)


@pytest.fixture(scope="module")
def small(small_graph):
    return small_graph, graph_from_reference(small_graph)


def _pair(spec, graphs, jax_backend, port_backend, seeds=None, n_mines=1, **kw):
    """Mine with both packages; return (jax counts, port counts) after
    asserting equal counts and equal stats."""
    g, tg = graphs
    jcp = JC.CompiledPattern(spec, g, backend=jax_backend, **kw)
    tcp = TC.CompiledPattern(
        spec_from_reference(spec), tg, backend=port_backend, device="cpu", **kw
    )
    for _ in range(n_mines):
        ref = jcp.mine(seeds)
        got = tcp.mine(seeds)
        np.testing.assert_array_equal(got, ref)
        assert tcp.stats == jcp.stats
    assert got.dtype == np.int64
    return ref, got


# the seed-local patterns never reach the pairwise cube, so one backend
# pair covers them; the compiled ones run under both
FULL_CASES = [
    pytest.param(name, b, id=f"{name}-{b[1]}")
    for name in FULL
    for b in (BACKENDS if name in ("cycle3", "cycle4", "scatter_gather") else BACKENDS[:1])
]


@pytest.mark.parametrize("name,backends", FULL_CASES)
def test_full_patterns_match_jax_and_oracle(small, name, backends):
    spec = build_pattern(name, 4096)
    g = small[0]
    seeds = np.random.default_rng(0).choice(g.n_edges, size=120, replace=False).astype(np.int32)
    ref, _ = _pair(spec, small, *backends, seeds=seeds)
    np.testing.assert_array_equal(ref, GFPReference(spec, g).mine(seeds))


def test_ir_and_plan_text_match(small):
    for name in ("scatter_gather", "cycle5", "new_counterparty"):
        spec = build_pattern(name, 64)
        j, t = JC.analyze_stage_graph(spec), TC.analyze_stage_graph(spec_from_reference(spec))
        assert (t.hop_depth, t.dirty_radius, t.time_radius) == (
            j.hop_depth,
            j.dirty_radius,
            j.time_radius,
        )
    txt = TC.CompiledPattern(
        spec_from_reference(build_pattern("cycle5", 4096)), small[1], device="cpu"
    ).plan_text()
    assert "L1" in txt and "L2" in txt and "intersect" in txt


def test_backend_and_device_rules(dense):
    spec = spec_from_reference(build_pattern("cycle3", W))
    with pytest.raises(ValueError, match="kernel|torch"):
        TC.CompiledPattern(spec, dense[1], backend="pallas", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TC.CompiledPattern(spec, dense[1])
    cp = TC.CompiledPattern(spec, dense[1], device="cpu")
    assert cp.backend == "kernel" and cp.device.type == "cpu"
    # witness mode is ported: the same counts, one host sync for both
    w = cp.mine(witnesses=2)
    np.testing.assert_array_equal(w.counts, cp.mine())
    assert w.eids.shape == (dense[1].n_edges, 2, w.n_hops) and cp.stats["host_syncs"] == 2
    assert cp.mine(np.zeros(0, np.int32)).shape == (0,)
