"""The port's mining launcher (``repro_torch.launch.mine``) against the
JAX package's: ``mine_partitioned`` gives the reference's counts under
the ``sharded`` and ``partitioned`` backends, and the command line runs
on the CPU."""
import numpy as np
import pytest
import torch

from repro.data.synth_aml import load_dataset as jax_load
from repro.launch.mine import mine_partitioned as jax_mine_partitioned
from repro_torch.convert import graph_from_reference
from repro_torch.launch import mesh
from repro_torch.launch.mine import main, mine_partitioned


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_graph():
    return jax_load("HI-Small", scale=0.05).graph


@pytest.mark.parametrize("backend", ["sharded", "partitioned"])
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("pattern", ["scatter_gather", "fan_in"])
def test_mine_partitioned_equals_reference(jax_graph, backend, lanes, pattern):
    want, want_plan, _ = jax_mine_partitioned(jax_graph, pattern, 4096, 4, backend=backend)
    mesh.ensure_host_devices(lanes, device="cpu")
    try:
        got, plan, timing = mine_partitioned(graph_from_reference(jax_graph), pattern, 4096, 4,
                                             backend=backend, device="cpu")
    finally:
        mesh.ensure_host_devices(1, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plan.edge_ids, want_plan.edge_ids)
    assert timing["warmup_s"] > 0 and len(timing["per_part"]) == 4
    if backend == "sharded":
        assert timing["host_syncs"] == 1
        assert timing["gather_mode"] == ("collective" if lanes >= 4 else "host")
        assert len(set(timing["devices"])) == lanes
        assert set(timing["balance"]) == {"predicted_cost_skew", "kernel_call_skew", "padded_element_skew"}


@pytest.mark.parametrize("backend", ["sharded", "partitioned"])
def test_main_runs_on_the_cpu(capsys, backend):
    try:
        counts, plan, timing = main(["--device", "cpu", "--scale", "0.05", "--parts", "3", "--backend", backend])
    finally:
        mesh.ensure_host_devices(1, device="cpu")
    out = capsys.readouterr().out
    assert f"scatter_gather on HI-Small [{backend}]: {counts.sum()} instances" in out
    assert plan.n_parts == 3
    if backend == "sharded":
        assert "gather collective" in out and "host_syncs 1" in out
        assert timing["devices"] == ["cpu:0", "cpu:1", "cpu:2"]


def test_main_rejects_an_unknown_pattern():
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--scale", "0.05", "--pattern", "nope"])
    mesh.ensure_host_devices(1, device="cpu")
