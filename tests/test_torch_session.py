"""The port's MiningSession against the JAX package's: the portfolio
count matrix and the ``stats`` dict are equal, with
``host_syncs == 1 + n_compiled``; entry points run on CUDA by default and
on the CPU only when asked; and the port imports neither jax nor
``repro``."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import MiningSession as JaxSession
from repro.core.patterns import feature_pattern_set
from repro_torch.api import MiningSession, canonical_key
from repro_torch.convert import graph_from_reference, spec_from_reference
from repro_torch.core.patterns import build_pattern
from tests.conftest import random_temporal_graph

ROOT = Path(__file__).resolve().parents[1]
W = 96


@pytest.fixture(scope="module")
def dense():
    g = random_temporal_graph(np.random.default_rng(11), n_nodes=18, n_edges=140, t_max=256)
    return g, graph_from_reference(g)


@pytest.mark.parametrize("backends", [("pallas", "kernel"), ("xla", "torch")], ids=["kernel", "torch"])
def test_full_portfolio_matches_jax_session(small_graph, backends):
    pats = feature_pattern_set("full")
    seeds = np.random.default_rng(0).choice(small_graph.n_edges, size=150, replace=False).astype(np.int32)
    js = JaxSession(small_graph, window=4096, kernel_backend=backends[0]).register(*pats)
    ts = MiningSession(
        graph_from_reference(small_graph), window=4096, kernel_backend=backends[1], device="cpu"
    ).register(*pats)
    for _ in range(2):  # the second mine replays every compiled schedule
        jr, tr = js.mine(seeds=seeds), ts.mine(seeds=seeds)
        assert tr.columns == jr.columns == tuple(pats)
        np.testing.assert_array_equal(tr.counts, jr.counts)
        assert tr.stats == jr.stats
        assert set(tr.fused) == set(jr.fused) == {
            "fan_in", "fan_out", "deg_in", "deg_out", "cycle2", "stack"
        }
        assert tr.stats["host_syncs"] == 1 + len(ts._compiled) == 4
    assert tr.stats["schedule_hits"] == 3
    assert ts.stats == js.stats


def test_full_deep_portfolio_dense_graph(dense):
    g, tg = dense
    pats = feature_pattern_set("full_deep")
    jr = JaxSession(g, window=W).register(*pats).mine()
    ts = MiningSession(tg, window=W, device="cpu").register(*pats)
    tr = ts.mine()
    np.testing.assert_array_equal(tr.counts, jr.counts)
    assert tr.counts.sum() > 0
    assert tr.stats["host_syncs"] == 1 + len(ts._compiled)
    # a pattern subset, seed subset, and the result accessors
    sub = ts.mine(["cycle3", "fan_in"], seeds=np.array([3, 0, 17, 5], np.int32))
    np.testing.assert_array_equal(sub.column("cycle3"), tr.column("cycle3")[[3, 0, 17, 5]])
    assert sub.as_features().dtype == np.float32
    assert sub.totals()["fan_in"] == int(sub.column("fan_in").sum())


def test_registration_specs_and_dedup(dense):
    """Library names, port specs and converted reference specs register
    alike; structural duplicates share one plan."""
    g, tg = dense
    from repro.core.patterns import build_pattern as jax_build

    ts = MiningSession(tg, window=W, device="cpu")
    ts.register("cycle3", spec_from_reference(jax_build("cycle3", W)))
    ts.compile()
    assert len(ts._compiled) == 1
    assert canonical_key(build_pattern("cycle3", W)) == canonical_key(
        spec_from_reference(jax_build("cycle3", W))
    )
    feats = ts.mine(["cycle2", "fan_out"]).as_features()
    ref = JaxSession(g, window=W).register("cycle2", "fan_out").mine().as_features()
    np.testing.assert_array_equal(feats, ref)


def test_unported_surfaces_name_their_roadmap_item(dense):
    ts = MiningSession(dense[1], window=W, device="cpu").register("fan_in")
    # the sharded backend is ported (A8): the compiled counts, one sync
    sharded = ts.mine(backend="sharded")
    np.testing.assert_array_equal(sharded.counts, ts.mine().counts)
    assert sharded.stats["host_syncs"] == 1
    # the LM scaffold's meshes are ported (A12b): a DeviceMesh over the
    # process group, on the CUDA card unless given the CPU, never a fallback
    from repro_torch.launch import mesh

    with pytest.raises(RuntimeError, match="CUDA device|process group"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_production_mesh(device="cpu")
    # witnesses (A7) are ported: counts as a counting mine, top-k tuples
    res = ts.mine(witnesses=3)
    np.testing.assert_array_equal(res.counts, ts.mine().counts)
    assert set(res.witnesses) == {"fan_in"} and res.witnesses["fan_in"].k == 3
    assert ts.service(witnesses=2).witnesses == 2
    with pytest.raises(ValueError, match="unknown backend"):
        ts.mine(backend="nope")


def test_device_defaults_to_cuda(dense):
    if torch.cuda.is_available():
        assert MiningSession(dense[1], window=W).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            MiningSession(dense[1], window=W)
    res = MiningSession(dense[1], window=W, device="cpu").register("cycle3").mine()
    assert res.counts.shape == (dense[1].n_edges, 1)


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module and everything chip_smoke.py imports load
    in a fresh interpreter without jax or the JAX package."""
    code = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
sys.path.insert(0, sys.argv[2])
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert len(mods) >= 15, mods
print("ok", len(mods))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "src"), str(ROOT)],
        capture_output=True,
        text=True,
        env=env,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
