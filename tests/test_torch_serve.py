"""The port's triage server (``repro_torch.launch.serve``) against the JAX
package's: one submitter over the same feed writes the same audit lines
(the ``span_id`` and the final ``metrics`` line set aside), failed ticks
are contained with a structured ``SubmitError``, ``health()`` and
``ready()`` report the liveness surface, poisoned input is contained,
repeat alerts are deduplicated, and the command line runs on the CPU."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.synth_aml import generate_aml_dataset as jax_generate
from repro.launch.serve import DEFAULT_PORTFOLIO as JAX_PORTFOLIO
from repro.launch.serve import TriageServer as JaxServer
from repro.launch.serve import load_test as jax_load_test
from repro.launch.serve import make_feed as jax_make_feed
from repro.stream import DetectionService as JaxService
from repro_torch.convert import graph_from_reference
from repro_torch.launch.serve import DEFAULT_PORTFOLIO, SubmitError, TriageServer, _alert_key, load_test, make_feed
from repro_torch.stream import (
    DetectionService,
    FaultInjector,
    InjectedFault,
    ResilienceConfig,
    ResilientDetectionService,
    make_poisoned_batch,
    store_states_equal,
)

ROOT = Path(__file__).resolve().parents[1]
W = 64
PORTFOLIO = ["fan_in", "cycle3"]
THRESH = {"fan_in": 2, "cycle3": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The eager CPU ops here are small: under the suite's six xdist
    workers on the same cores, torch's intra-op threads oversubscribe
    them and a witness mine runs about 5x slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audit(path):
    """Audit lines without the span ids; the final metrics line apart."""
    lines = [json.loads(ln) for ln in Path(path).read_text().splitlines()]
    assert lines and lines[-1].get("metrics") is True
    for ln in lines[:-1]:
        ln.pop("span_id", None)
    return lines[:-1], lines[-1]


@pytest.mark.parametrize("backends", [("pallas", "kernel"), ("xla", "torch")], ids=["kernel", "torch"])
def test_audit_log_matches_jax(tmp_path, backends):
    ds = jax_generate("HI-Small", seed=0, scale=0.05)
    assert DEFAULT_PORTFOLIO == JAX_PORTFOLIO
    kw = dict(window=4096, thresholds=dict(DEFAULT_PORTFOLIO), witnesses=2)
    ours = TriageServer(DetectionService(list(DEFAULT_PORTFOLIO), backend=backends[1], device="cpu", **kw),
                        audit_path=str(tmp_path / "ours.jsonl"))
    ref = JaxServer(JaxService(list(JAX_PORTFOLIO), backend=backends[0], **kw),
                    audit_path=str(tmp_path / "ref.jsonl"))
    feed = make_feed(graph_from_reference(ds.graph), 64)[:12]
    jfeed = jax_make_feed(ds.graph, 64)[:12]
    for a, b in zip(feed, jfeed):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    got, want = load_test(ours, feed, 1), jax_load_test(ref, jfeed, 1)
    for k in ("ticks", "txns", "alerts", "evidence_hop_tuples", "errors", "suppressed_duplicates", "submitters"):
        assert got[k] == want[k], k
    assert got["alerts"] > 0 and got["evidence_hop_tuples"] > 0
    ours.close()
    ref.close()
    lines, metrics = _audit(tmp_path / "ours.jsonl")
    jlines, _ = _audit(tmp_path / "ref.jsonl")
    assert lines == jlines
    assert any(ln.get("evidence") for ln in lines)
    assert metrics["snapshot"]
    # the dedup key is the JAX package's
    row = next(ln for ln in lines if "eid" in ln and not ln.get("dedup"))
    assert _alert_key(row)[:2] == (row["eid"], tuple(row["patterns"]))


def _batches(seed, n_batches=4, n_nodes=120, n_edges=400, t_span=4000):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    fix = src == dst
    dst[fix] = (dst[fix] + 1) % n_nodes
    t = np.sort(rng.integers(0, t_span // 4, n_edges)).astype(np.int64) * 4
    amt = rng.uniform(1.0, 500.0, n_edges).astype(np.float32)
    return [(src[c], dst[c], t[c], amt[c]) for c in np.array_split(np.arange(n_edges), n_batches)]


def _state(svc):
    return (svc.store.state_dict(), {n: svc.pattern_counts(n).copy() for n in svc.pattern_names}, svc.tick)


def test_triage_server_survives_failed_ticks_and_reports_health():
    chaos = FaultInjector()
    svc = ResilientDetectionService(PORTFOLIO, window=W, thresholds=THRESH, chaos=chaos, witnesses=2,
                                    resilience=ResilienceConfig(max_retries=0), device="cpu")
    server = TriageServer(svc)
    feed = _batches(53)
    server.submit(*feed[0])
    pre = _state(svc)
    chaos.arm("mine", times=1, exc=InjectedFault)
    err = server.submit(*feed[1])
    assert isinstance(err, SubmitError)
    assert err.error == "InjectedFault" and err.rolled_back and err.tick == pre[2]
    post = _state(svc)
    assert store_states_equal(pre[0], post[0]) and pre[2] == post[2]
    for n in PORTFOLIO:
        np.testing.assert_array_equal(pre[1][n], post[1][n], err_msg=n)
    chaos.disarm()
    out = server.submit(*feed[2])
    assert not isinstance(out, SubmitError) and out.evidence is not None
    h = server.health()
    assert h["ready"] and h["errors"] == 1 and h["ticks"] == 2
    assert h["last_error"]["error"] == "InjectedFault"
    assert h["service"]["tick"] == svc.tick
    assert server.ready()
    server.close()
    assert not server.ready()


def test_triage_server_poisoned_input_containment(tmp_path):
    svc = ResilientDetectionService(PORTFOLIO, window=W, thresholds=THRESH, device="cpu")
    server = TriageServer(svc, audit_path=str(tmp_path / "audit.jsonl"))
    s, d, t, a, bad = make_poisoned_batch(np.random.default_rng(3))
    batch = server.submit(s, d, t, a)
    assert not isinstance(batch, SubmitError)
    assert batch.report.quarantined == int(bad.sum())
    # a plain service: the poison raises inside, the server contains it
    raw = DetectionService(PORTFOLIO, window=W, thresholds=THRESH, device="cpu")
    err = TriageServer(raw).submit(s, d, t, a)
    assert isinstance(err, SubmitError)
    assert raw.store.n_live == 0  # rolled back, not corrupted
    server.close()


def test_audit_log_dedups_repeat_alerts(tmp_path):
    path = tmp_path / "audit.jsonl"
    server = TriageServer(DetectionService(["fan_in"], window=W, thresholds={"fan_in": 2}, device="cpu"),
                          audit_path=str(path))
    server.submit(np.arange(2, 8, dtype=np.int32), np.zeros(6, np.int32), np.full(6, 100, np.int64))
    assert server.n_alerts > 0 and server.n_suppressed == 0
    for src, t in ((8, 101), (9, 102)):
        server.submit(np.array([src], np.int32), np.array([0], np.int32), np.array([t], np.int64))
    assert server.n_suppressed > 0
    server.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    alerts = [ln for ln in lines if "eid" in ln and not ln.get("dedup")]
    dedups = [ln for ln in lines if ln.get("dedup")]
    assert len(alerts) == len({(a["eid"], tuple(a["patterns"])) for a in alerts})
    assert server.n_alerts > len(alerts)
    assert server.n_suppressed == sum(d["repeat_count"] - 1 for d in dedups)
    assert all(d["repeat_count"] >= 2 for d in dedups)
    assert lines[-1]["metrics"] is True
    assert server.metrics("prometheus").startswith("#")
    with pytest.raises(ValueError):
        server.metrics("xml")


def test_serve_command_line_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    audit = tmp_path / "alerts.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--scale", "0.05",
         "--max-batches", "4", "--audit", str(audit)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout[out.stdout.index("{"):])
    assert summary["ticks"] == 4 and summary["errors"] == 0
    assert json.loads(audit.read_text().splitlines()[-1])["metrics"] is True
