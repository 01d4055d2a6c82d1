"""The port's copy of ``distributed/fault_tolerance.py`` against the JAX
package's on the cases of ``tests/test_checkpoint_ft.py``: the re-mesh
plan, file heartbeats and the straggler monitor."""
import numpy as np
import pytest

from repro.distributed import fault_tolerance as ref
from repro_torch.distributed import fault_tolerance as port


@pytest.mark.parametrize("chips", [512, 256, 248, 16, 300, 1000])
@pytest.mark.parametrize("mp", [16, 8])
def test_plan_remesh_equals_reference(chips, mp):
    assert port.plan_remesh(chips, model_parallel=mp) == ref.plan_remesh(chips, model_parallel=mp)


def test_plan_remesh_cases():
    assert port.plan_remesh(512) == ((2, 16, 16), ("pod", "data", "model"))
    assert port.plan_remesh(256) == ((16, 16), ("data", "model"))
    assert port.plan_remesh(248) == ((15, 16), ("data", "model"))
    with pytest.raises(RuntimeError):
        port.plan_remesh(8, model_parallel=16)


def test_heartbeat_read_by_either(tmp_path):
    """Heartbeats the port writes are alive to the reference's reader and
    the other way round (one file format)."""
    port.Heartbeat(str(tmp_path), "a", timeout_s=100).beat(1)
    ref.Heartbeat(str(tmp_path), "b", timeout_s=100).beat(1)
    assert port.Heartbeat(str(tmp_path), "c").alive_hosts() == ["a", "b"]
    assert ref.Heartbeat(str(tmp_path), "c").alive_hosts() == ["a", "b"]
    hb = port.Heartbeat(str(tmp_path), "a", timeout_s=1.0)
    assert hb.alive_hosts(now=1e18) == []  # everyone timed out


def test_straggler_monitor_equals_reference():
    rng = np.random.default_rng(0)
    mons = [port.StragglerMonitor(threshold=1.5, window=8), ref.StragglerMonitor(threshold=1.5, window=8)]
    for step in range(40):
        for host, base in (("a", 1.0), ("b", 1.1), ("c", 3.0 if step > 20 else 1.0)):
            x = float(base + rng.random() * 0.1)
            for m in mons:
                m.record(host, x)
        assert mons[0].medians() == mons[1].medians()
        assert mons[0].stragglers() == mons[1].stragglers()
    assert mons[0].stragglers() == ["c"]
