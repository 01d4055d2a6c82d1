"""``graph/partition.py`` and ``data/trovares.py`` (numpy copies) against
the JAX package, the session's ``"partitioned"`` backend against
``"compiled"``, and the keyword overrides of ``mine_async`` and the fused
plan's ``launch_units``."""
import numpy as np
import pytest
import torch

from repro.api import MiningSession as JaxSession
from repro.data.trovares import generate_trovares_graph as jax_trovares
from repro.graph.partition import partition_edges as jax_partition
from repro_torch.api import MiningSession
from repro_torch.convert import graph_from_reference
from repro_torch.core import executor
from repro_torch.core.compiler import CompiledPattern
from repro_torch.core.patterns import build_pattern, feature_pattern_set
from repro_torch.data import TROVARES_SIZES, generate_trovares_graph
from repro_torch.graph import PartitionPlan, partition_edges
from tests.conftest import random_temporal_graph

W = 96
FULL = feature_pattern_set("full")


@pytest.fixture(scope="module")
def graphs():
    g = random_temporal_graph(np.random.default_rng(5), n_nodes=22, n_edges=170, t_max=300)
    return g, graph_from_reference(g)


@pytest.mark.parametrize("n_parts", [1, 3, 4, 7])
def test_partition_plans_equal_jax(graphs, n_parts):
    g, tg = graphs
    seeds = np.random.default_rng(n_parts).integers(0, g.n_edges, 90).astype(np.int32)
    for ids in (None, seeds):
        got = partition_edges(tg, n_parts, edge_ids=ids)
        want = jax_partition(g, n_parts, edge_ids=ids)
        assert isinstance(got, PartitionPlan) and got.n_parts == want.n_parts
        for f in ("edge_ids", "valid", "cost", "positions"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert got.skew == want.skew


@pytest.mark.parametrize("backends", [("pallas", "kernel"), ("xla", "torch")], ids=["kernel", "torch"])
def test_partitioned_equals_compiled_and_jax(graphs, backends):
    g, tg = graphs
    seeds = np.concatenate([np.arange(g.n_edges), [3, 3, 50]]).astype(np.int32)  # duplicates too
    session = MiningSession(tg, window=W, kernel_backend=backends[1], device="cpu").register(*FULL)
    part = session.mine(seeds=seeds, backend="partitioned", n_parts=3)
    comp = session.mine(seeds=seeds)
    np.testing.assert_array_equal(part.counts, comp.counts)
    assert part.backend == "partitioned" and part.partition_plan.n_parts == 3
    assert len(part.per_part_seconds) == 3
    jax = JaxSession(g, window=W, kernel_backend=backends[0]).register(*FULL)
    jpart = jax.mine(seeds=seeds, backend="partitioned", n_parts=3)
    np.testing.assert_array_equal(part.counts, jpart.counts)
    assert part.stats == jpart.stats


@pytest.mark.parametrize("seed", [0, 1])
def test_trovares_graph_bit_identical(seed):
    got = generate_trovares_graph(TROVARES_SIZES["Trovares-10K"], seed=seed)
    want = jax_trovares(10_000, seed=seed)
    assert (got.n_nodes, got.n_edges, got.t_max) == (want.n_nodes, want.n_edges, want.t_max)
    for f in ("src", "dst", "t", "amount", "out_indptr", "out_nbr", "out_t_sorted", "in_indptr", "in_nbr"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_mine_async_keywords_give_the_default_counts(graphs, backend):
    _, tg = graphs
    cp = CompiledPattern(build_pattern("scatter_gather", W), tg, backend=backend, device="cpu",
                         batch_elem_cap=4096)
    seeds = np.arange(tg.n_edges, dtype=np.int32)
    want = cp.mine_async(seeds).numpy()
    lifetime = dict(cp.stats)
    dg = tg.to_device(device="cpu")
    for coalesce in (1, 4):
        stats = executor.new_stats()
        got = cp.mine_async(seeds, dg=dg, device="cpu", stats=stats, coalesce=coalesce)
        np.testing.assert_array_equal(got.numpy(), want)
        assert stats["kernel_calls"] > 0 and stats["schedule_hits"] == 1
        assert cp.stats == lifetime  # redirected: the plan's own counters stay put
    # coalescing merges equal-width chunks: fewer launches, same padded work
    base, fat = executor.new_stats(), executor.new_stats()
    cp.mine_async(seeds, stats=base)
    cp.mine_async(seeds, stats=fat, coalesce=4)
    assert fat["kernel_calls"] <= base["kernel_calls"]
    assert fat["padded_elements"] == base["padded_elements"]
    assert torch.equal(cp.mine_async(np.zeros(0, np.int32), dg=dg), torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="differs"):
        cp.mine_async(seeds, device="meta")


def test_fused_launch_units_keywords(graphs):
    _, tg = graphs
    session = MiningSession(tg, window=W, device="cpu", batch_elem_cap=512).register(*FULL).compile()
    fused = session._fused
    seeds = np.arange(tg.n_edges, dtype=np.int32)
    want = fused.launch_units(seeds, executor.new_stats())
    stats = executor.new_stats()
    got = fused.launch_units(seeds, stats, dg=tg.to_device(device="cpu"), coalesce=4)
    np.testing.assert_array_equal(got[: len(seeds)].numpy(), want[: len(seeds)].numpy())
    assert stats["kernel_calls"] >= 1
