"""The port's graph substrate against the JAX package's: the synthetic
AML generator builds bit-identical graphs, and ``DeviceGraph`` mirrors
``repro``'s ``to_device`` field for field (padding, fill values, floors)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data.synth_aml import generate_aml_dataset as jax_generate
from repro.graph.csr import build_temporal_graph as jax_build
from repro.graph.csr import csr_row_offsets as jax_row_offsets
from repro_torch.convert import graph_from_reference
from repro_torch.data.synth_aml import generate_aml_dataset, planted_instances
from repro_torch.graph.csr import (
    DeviceGraph,
    TemporalGraph,
    build_temporal_graph,
    csr_row_offsets,
)
from tests.conftest import random_temporal_graph


def _assert_graphs_equal(a, b):
    for f in dataclasses.fields(TemporalGraph):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize(
    "name,seed,scale", [("HI-Small", 7, 0.25), ("LI-Small", 3, 0.1), ("HI-Medium", 0, 0.02)]
)
def test_synth_aml_bit_identical(name, seed, scale):
    ref = jax_generate(name, seed=seed, scale=scale)
    got = generate_aml_dataset(name, seed=seed, scale=scale)
    _assert_graphs_equal(ref.graph, got.graph)
    np.testing.assert_array_equal(ref.labels, got.labels)
    np.testing.assert_array_equal(ref.meta["kinds"], got.meta["kinds"])
    assert len(planted_instances(got)) == len(ref.meta["instances"])
    for r, g in zip(ref.meta["instances"], got.meta["instances"]):
        assert r["kind"] == g["kind"]
        np.testing.assert_array_equal(r["eids"], g["eids"])


def test_build_temporal_graph_copy():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 30, 300).astype(np.int32)
    dst = rng.integers(0, 30, 300).astype(np.int32)
    t = rng.integers(0, 1000, 300).astype(np.int64)
    amt = rng.random(300).astype(np.float32)
    _assert_graphs_equal(
        jax_build(src, dst, t, amt, n_nodes=32), build_temporal_graph(src, dst, t, amt, n_nodes=32)
    )
    g = build_temporal_graph(src, dst, t, n_nodes=32)
    nodes = np.array([0, 31, 5, 5], dtype=np.int64)
    for a, b in zip(jax_row_offsets(g.out_indptr, nodes), csr_row_offsets(g.out_indptr, nodes)):
        np.testing.assert_array_equal(a, b)


def test_graph_from_reference_roundtrip(small_graph):
    _assert_graphs_equal(small_graph, graph_from_reference(small_graph))


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"pad": True},
        {"pad": True, "floor_nodes": 100, "floor_edges": 1000, "floor_deg": 64},
        {"pad": True, "floor_nodes": 3, "floor_edges": 7, "floor_deg": 2},
    ],
    ids=["plain", "pad", "pad-floors-up", "pad-floors-low"],
)
@pytest.mark.parametrize("graph", ["random", "small"])
def test_device_graph_mirror(kw, graph, small_graph):
    if graph == "random":
        g = random_temporal_graph(np.random.default_rng(3), n_nodes=21, n_edges=150)
    else:
        g = small_graph
    ref = g.to_device(**kw)
    got = graph_from_reference(g).to_device(device="cpu", **kw)
    assert isinstance(got, DeviceGraph)
    for f in dataclasses.fields(DeviceGraph):
        x, y = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(x, int):
            assert x == y, f.name
            continue
        x = np.asarray(x)
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu", f.name
        assert y.dtype == (torch.float32 if f.name == "amount" else torch.int32), f.name
        np.testing.assert_array_equal(x, y.numpy(), err_msg=f.name)


def test_to_device_defaults_to_cuda():
    g = graph_from_reference(random_temporal_graph(np.random.default_rng(0)))
    if torch.cuda.is_available():
        assert g.to_device().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            g.to_device()
