"""The port's copies of ``repro.obs.metrics`` and ``repro.obs.flight``
give the JAX package's outputs for one recorded sequence."""
import json

import numpy as np

from repro.obs import flight as jax_flight
from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro_torch.obs import FlightRecorder, MetricsRegistry, flight, metrics, observe_stats, trace


def _drive(mod, reg):
    c = reg.counter("repro_demo_total", help="a counter")
    c.inc()
    c.inc(4)
    reg.counter("repro_demo_total", labels={"device": "cuda:0"}, help="a counter").inc(2)
    g = reg.gauge("repro_level", help="a gauge")
    g.set(3)
    g.set(1)
    h = reg.histogram("repro_tick_seconds", help="tick latency")
    for x in np.linspace(0.001, 0.5, 37):
        h.observe(float(x))
    mod.observe_stats({"kernel_calls": 7, "host_syncs": 1, "jit_cache_entries": 5}, "repro_executor", registry=reg)
    mod.observe_stats({"kernel_calls": 2, "host_syncs": 1, "jit_cache_entries": 3}, "repro_executor", registry=reg)
    return reg.exposition(), reg.snapshot()


def test_metrics_registry_matches_jax():
    ours = _drive(metrics, MetricsRegistry())
    ref = _drive(jax_metrics, jax_metrics.MetricsRegistry())
    assert ours[0] == ref[0]
    assert json.dumps(ours[1], sort_keys=True) == json.dumps(ref[1], sort_keys=True)
    assert metrics.GAUGE_STAT_KEYS == jax_metrics.GAUGE_STAT_KEYS
    assert observe_stats is metrics.observe_stats


def _record(rec_cls, tr, path):
    tr.enable()
    try:
        tr.get_tracer().reset()
        rec = rec_cls(capacity=3)
        for tick in range(1, 6):
            with tr.span("tick", tick=tick) as sp:
                with tr.span("tick:mine", n=tick * 2):
                    pass
            rec.record({"tick": tick, "dirty": {"fan_in": tick}, "n": np.int64(tick)}, span_id=sp.span_id)
        rec.dump(str(path), reason="tick_failed", failure={"tick": 5, "type": "TransientFault"})
    finally:
        tr.disable()
        tr.get_tracer().reset()
    lines = [json.loads(x) for x in open(path)]
    for ln in lines:  # wall-clock stamps and span timings differ run to run
        ln.pop("wall_time", None)
        for sp in ln.get("spans") or ():
            sp.pop("t0_ns"), sp.pop("dur_ns"), sp.pop("id"), sp.pop("parent"), sp.pop("tid")
        ln.pop("span_id", None)
    return len(rec), rec.n_recorded, lines


def test_flight_recorder_matches_jax(tmp_path):
    ours = _record(FlightRecorder, trace, tmp_path / "ours.jsonl")
    ref = _record(jax_flight.FlightRecorder, jax_trace, tmp_path / "ref.jsonl")
    assert ours == ref
    assert ours[0] == 3 and ours[1] == 5 and ours[2][0]["postmortem"] is True
    assert flight.FlightRecorder is FlightRecorder
