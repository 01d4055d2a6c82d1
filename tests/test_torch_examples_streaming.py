"""``repro_torch.examples.streaming_detection`` and
``repro_torch.examples.trace_capture`` against the JAX package's own
``examples/streaming_detection.py`` and ``examples/trace_capture.py``, run
unchanged in a subprocess on the CPU (the trace script with 8 forced
host devices, as it sets them): at the same flags every printed line is
the same once the times are masked, except the departures listed below
with their reasons; the span-name multisets of the Chrome traces and the
metric names of the exposition are the same."""
import collections
import json
import os
import re

import pytest
import torch

from repro_torch.examples import streaming_detection, trace_capture
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from tests.examples_parity import masked, run_reference

STREAM_FLAGS = ["--scale", "0.1", "--batches", "4"]
TRACE_SCALE = ["--scale", "0.05"]

# (pattern, replacement, reason) applied to both sides' lines after the
# times are masked
TRACE_DEPARTURES = (
    (r"-> \S+/(\w+\.trace\.json)", r"-> <out>/\1", "each side writes its traces to a directory of its own"),
    # the summary's total_ms and mean_ms columns are times without a unit
    (r"^(\s+\d+)\s+\d+\.\d+\s+\d+\.\d+(\s+)", r"\1  <ms>  <ms>\2", "times in ms"),
    (r"^(repro_\w*seconds\S*) \S+$", r"\1 <value>", "times in seconds (latencies, unix times of a beat)"),
    (r'device="TFRT_CPU_(\d+)"', r'device="cpu:\1"', "jax names its k-th CPU device TFRT_CPU_k, the port cpu:k"),
    # the reference opens a "compile" span around the first call of each
    # fresh JIT trace, one per trace miss, and span ids count every span;
    # the port compiles nothing at run time, so its ids run behind by the
    # misses of the earlier ticks, and its streaming trace holds that many
    # fewer spans: test_trace_lines_equal_reference_script checks both
    (r"span_id=\d+", "span_id=<id>", "ids count the reference's compile spans"),
    (r"^streaming: \d+ spans", "streaming: <n> spans", "the count holds the reference's compile spans"),
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_streaming_lines_equal_reference_script(tmp_path, capsys):
    want = run_reference("streaming_detection", STREAM_FLAGS, tmp_path)
    capsys.readouterr()
    got = streaming_detection.main(STREAM_FLAGS + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert masked(printed) == masked(want)
    assert got["cycle3_equal"] and len(got["ticks"]) == 4
    assert got["total_alerts"] == sum(len(t["alerts"]) for t in got["ticks"]) > 0
    assert got["totals"] == {n: int(c.sum()) for n, c in got["counts"].items()}


def _span_names(path):
    with open(path) as f:
        return collections.Counter(e["name"] for e in json.load(f)["traceEvents"])


def _metric_names(exposition):
    return sorted({ln.split()[2] for ln in exposition.splitlines() if ln.startswith("# TYPE ")})


def test_trace_lines_equal_reference_script(tmp_path, capsys):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    want = run_reference("trace_capture", TRACE_SCALE + ["--out-dir", "traces"], ref_dir,
                         extra_env={"XLA_FLAGS": flags.strip()})
    # the script runs in a fresh process: a tracer and a registry of its own here
    previous = obs_trace.set_tracer(obs_trace.Tracer()), obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    capsys.readouterr()
    try:
        got = trace_capture.main(TRACE_SCALE + ["--out-dir", str(port_dir), "--device", "cpu"])
    finally:
        obs_trace.set_tracer(previous[0])
        obs_metrics.set_registry(previous[1])
    printed = capsys.readouterr().out
    assert masked(printed, TRACE_DEPARTURES) == masked(want, TRACE_DEPARTURES)

    # the two departures in ids and counts are the reference's compile
    # spans, one per fresh JIT trace, which the port counts as fresh
    # launch shapes (TickReport.trace_misses)
    misses = [t["trace_misses"] for t in got["ticks"]]
    ref_ids = [int(x) for x in re.findall(r"span_id=(\d+)", want)]
    assert len(ref_ids) == len(got["ticks"]) == trace_capture.TICKS
    for k, t in enumerate(got["ticks"]):
        assert ref_ids[k] - t["span_id"] == sum(misses[:k])
    ref_stream = int(re.search(r"streaming: (\d+) spans", want).group(1))
    assert ref_stream == got["streaming_spans"] + sum(misses)

    for name in ("sharded_mine", "streaming"):
        ref_names = _span_names(ref_dir / "traces" / f"{name}.trace.json")
        port_names = _span_names(port_dir / f"{name}.trace.json")
        assert ref_names.pop("compile", 0) == (sum(misses) if name == "streaming" else 0)
        assert port_names == ref_names == collections.Counter(got["span_names"][name])
    assert {f"dispatch:shard{k}" for k in range(8)} <= set(got["span_names"]["sharded_mine"])
    assert {"tick", "tick:ingest", "tick:plan", "tick:mine", "tick:score"} <= set(got["span_names"]["streaming"])
    ref_exposition = want[want.index("# HELP"):]
    assert _metric_names(got["exposition"]) == _metric_names(ref_exposition)
