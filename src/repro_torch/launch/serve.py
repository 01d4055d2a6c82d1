"""`repro_torch.launch.serve` — the AML scoring/triage endpoint, in torch
(the port of the JAX package's ``repro.launch.serve``).

This is the mining system's own serving surface: a
:class:`TriageServer` wraps a :class:`repro_torch.stream.DetectionService`
behind a ``submit()`` endpoint — concurrent submitters push transaction
microbatches, each submit ticks the service (ingest → dirty-frontier
re-mine → score → witness evidence), and every alert is appended to a
JSON-lines **audit log** carrying its resolved evidence hops
(``{stage, eid, src, dst, t, amount}`` per hop — what an analyst files
a SAR from).

The service is single-writer (the store mutates on ingest), so submits
serialize on a lock; concurrency buys pipelining of feed preparation
and audit IO against device mining, and the built-in load test measures
the end-to-end submit latency distribution *under contention* — the
number the triage queue actually experiences.

The service runs on the CUDA card unless ``--device cpu`` is given; its
counting mines go through the CUDA ``intersect_count`` kernel.

Usage (load test over a synthetic IBM-AML-style feed; HI-Small at its
published size, on the card):
  PYTHONPATH=src python -m repro_torch.launch.serve --dataset HI-Small \
      --scale 282 --witnesses 2 --audit build/alerts.jsonl

On the CPU, a small feed:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --scale 0.05 --max-batches 4
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.stream.service import AlertBatch, DetectionService

__all__ = [
    "TriageServer",
    "SubmitError",
    "make_feed",
    "load_test",
    "DEFAULT_PORTFOLIO",
]

# portfolio + thresholds matched to the typologies data/synth_aml.py
# injects (the JAX package's defaults)
DEFAULT_PORTFOLIO: Dict[str, int] = {
    "fan_in": 4,
    "fan_out": 4,
    "cycle2": 1,
    "cycle3": 1,
    "scatter_gather": 6,
}


@dataclasses.dataclass
class SubmitError:
    """Structured failure of one submit: the tick was rolled back
    transactionally (the service state is exactly as if the call never
    happened) and the server keeps serving.  ``error`` is the exception
    class name, ``detail`` its message."""

    error: str
    detail: str
    tick: int  # tick counter after rollback (i.e. the pre-call tick)
    rolled_back: bool = True


def _alert_key(row: dict) -> Tuple[int, Tuple[str, ...], str]:
    """Audit-log dedup key of one alert row: (seed eid, fired patterns,
    evidence content hash) — a seed that re-fires with the same patterns
    and the same witness evidence is the SAME alert, not a new one."""
    ev = hashlib.sha1(
        json.dumps(row.get("evidence"), sort_keys=True).encode()
    ).hexdigest()[:16]
    return (int(row["eid"]), tuple(row["patterns"]), ev)


class TriageServer:
    """Thread-safe scoring/triage front-end over a DetectionService.

    ``submit(src, dst, t, amount)`` ticks the service under the writer
    lock and appends the tick's alert rows (scores, fired patterns,
    per-pattern counts, resolved witness evidence when the service was
    built with ``witnesses=k``) to the audit log.  Latency/throughput
    counters accumulate under a separate lock so ``summary()`` can be
    read while submitters run.

    **Failure containment**: a tick that raises is rolled back by the
    service's transactional submit; the server records it, returns a
    structured :class:`SubmitError` instead of propagating, and keeps
    serving subsequent submits.  ``health()`` / ``ready()`` expose the
    liveness surface a supervisor probes.

    **Audit dedup**: alert rows are deduplicated ACROSS ticks on
    (seed eid, fired patterns, evidence hash) — a seed re-firing with
    identical evidence bumps an in-memory ``repeat_count`` instead of
    re-emitting the line; ``close()`` flushes one ``dedup`` summary line
    per repeated alert.
    """

    def __init__(self, service: DetectionService, audit_path: Optional[str] = None):
        self.service = service
        self._svc_lock = threading.Lock()
        self._meta_lock = threading.Lock()
        self._audit = open(audit_path, "a") if audit_path else None
        self.latencies: List[float] = []
        self.n_alerts = 0
        self.n_txns = 0
        self.n_evidence_hops = 0
        self.n_errors = 0
        self.n_suppressed = 0  # audit lines saved by dedup
        self.last_error: Optional[SubmitError] = None
        self._seen: Dict[Tuple[int, Tuple[str, ...], str], int] = {}
        self._closed = False

    def submit(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        t: np.ndarray,
        amount: Optional[np.ndarray] = None,
    ) -> Union[AlertBatch, SubmitError]:
        t0 = time.perf_counter()
        with self._svc_lock:
            try:
                batch = self.service.submit(src, dst, t, amount)
            except Exception as e:  # tick already rolled back
                err = SubmitError(
                    error=type(e).__name__,
                    detail=str(e),
                    tick=self.service.tick,
                )
                with self._meta_lock:
                    self.n_errors += 1
                    self.last_error = err
                obs_metrics.get_registry().counter(
                    "repro_triage_submit_errors_total",
                    help="submits that failed (tick rolled back)",
                ).inc()
                # resilient services dump a flight-recorder postmortem
                # bundle so the ticks LEADING UP to the failure survive
                postmortem = getattr(self.service, "postmortem", None)
                if callable(postmortem):
                    postmortem(self.service.tick + 1, failure=e)
                return err
            rows = batch.to_rows()
        dt = time.perf_counter() - t0
        obs_metrics.get_registry().histogram(
            "repro_triage_submit_seconds",
            help="end-to-end submit latency under the writer lock",
        ).observe(dt)
        hops = 0
        if batch.evidence is not None:
            hops = sum(
                len(wit)
                for ev in batch.evidence
                for wits in ev.values()
                for wit in wits
            )
        keyed = (
            [(_alert_key(row), row) for row in rows]
            if self._audit is not None
            else []
        )
        with self._meta_lock:
            self.latencies.append(dt)
            self.n_txns += len(src)
            self.n_alerts += len(rows)
            self.n_evidence_hops += hops
            if self._audit is not None:
                tick = batch.report.tick
                # span id joins the audit line to the tick's span tree
                # in trace exports / flight-recorder postmortem bundles
                span = (
                    {"span_id": batch.report.span_id}
                    if batch.report.span_id is not None
                    else {}
                )
                lines = []
                for key, row in keyed:
                    if key in self._seen:
                        self._seen[key] += 1
                        self.n_suppressed += 1
                        continue
                    self._seen[key] = 1
                    lines.append(json.dumps({"tick": tick, **span, **row}) + "\n")
                if lines:
                    self._audit.write("".join(lines))
        return batch

    def health(self) -> dict:
        """Liveness/observability snapshot (cheap; safe under load)."""
        with self._meta_lock:
            out = {
                "ready": self.ready(),
                "ticks": len(self.latencies),
                "errors": self.n_errors,
                "last_error": (
                    dataclasses.asdict(self.last_error)
                    if self.last_error
                    else None
                ),
                "alerts": self.n_alerts,
                "suppressed_duplicates": self.n_suppressed,
            }
        svc_health = getattr(self.service, "health", None)
        if callable(svc_health):
            out["service"] = svc_health()
        else:
            out["service"] = {"tick": self.service.tick}
        return out

    def ready(self) -> bool:
        """Readiness probe: accepting submits."""
        return not self._closed

    def metrics(self, format: str = "dict") -> Union[dict, str]:
        """Metrics endpoint over the global `repro_torch.obs` registry:
        ``format="dict"`` returns the flat snapshot (JSON-friendly),
        ``format="prometheus"`` the text exposition a scraper ingests."""
        reg = obs_metrics.get_registry()
        if format == "prometheus":
            return reg.exposition()
        if format == "dict":
            return reg.snapshot()
        raise ValueError(f"unknown metrics format {format!r}")

    def close(self) -> None:
        with self._meta_lock:
            self._closed = True
            if self._audit is not None:
                # flush dedup summaries: one line per alert that repeated
                for (eid, patterns, ev), n in self._seen.items():
                    if n > 1:
                        self._audit.write(
                            json.dumps(
                                {
                                    "dedup": True,
                                    "eid": eid,
                                    "patterns": list(patterns),
                                    "evidence_sha1": ev,
                                    "repeat_count": n,
                                }
                            )
                            + "\n"
                        )
                # final metrics snapshot: the run's counters/latency
                # quantiles land in the same audit stream the analysts
                # (and CI artifacts) already collect
                self._audit.write(
                    json.dumps(
                        {"metrics": True, "snapshot": self.metrics()}
                    )
                    + "\n"
                )
                self._audit.close()
                self._audit = None

    def summary(self) -> dict:
        with self._meta_lock:
            lat = np.asarray(self.latencies, dtype=np.float64)
            out = {
                "ticks": int(lat.size),
                "txns": int(self.n_txns),
                "alerts": int(self.n_alerts),
                "evidence_hop_tuples": int(self.n_evidence_hops),
                "errors": int(self.n_errors),
                "suppressed_duplicates": int(self.n_suppressed),
            }
        if lat.size:
            out.update(
                {
                    "p50_ms": float(np.percentile(lat, 50) * 1e3),
                    "p99_ms": float(np.percentile(lat, 99) * 1e3),
                    "max_ms": float(lat.max() * 1e3),
                }
            )
        return out


Feed = List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]


def make_feed(graph, batch: int) -> Feed:
    """Slice a batch graph's edges, time-ordered, into submit-sized
    microbatches (the replay feed of the load test)."""
    order = np.argsort(graph.t, kind="stable")
    src, dst, t, amt = (
        graph.src[order],
        graph.dst[order],
        graph.t[order],
        graph.amount[order],
    )
    return [
        (src[i : i + batch], dst[i : i + batch], t[i : i + batch], amt[i : i + batch])
        for i in range(0, len(src), batch)
    ]


def load_test(server: TriageServer, feed: Feed, n_submitters: int) -> dict:
    """Drive the server with ``n_submitters`` concurrent threads pulling
    microbatches off a shared cursor (so the global feed order is
    preserved up to in-flight skew — the service's lateness contract
    absorbs it).  Returns the server summary plus wall-clock throughput.
    """
    cursor = {"i": 0}
    cur_lock = threading.Lock()

    def worker():
        while True:
            with cur_lock:
                i = cursor["i"]
                if i >= len(feed):
                    return
                cursor["i"] = i + 1
            server.submit(*feed[i])

    threads = [threading.Thread(target=worker) for _ in range(max(1, n_submitters))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    out = server.summary()
    out["wall_s"] = wall
    out["txns_per_s"] = out["txns"] / wall if wall > 0 else 0.0
    out["submitters"] = n_submitters
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="HI-Small")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--submitters", type=int, default=4)
    ap.add_argument("--witnesses", type=int, default=2)
    ap.add_argument("--max-batches", type=int, default=0, help="0 = whole feed")
    ap.add_argument("--audit", default=None, help="JSONL alert audit log path")
    ap.add_argument(
        "--device", default=None, help="cuda (default: the card) or cpu"
    )
    args = ap.parse_args()

    from repro_torch.data.synth_aml import generate_aml_dataset

    ds = generate_aml_dataset(
        args.dataset, seed=args.seed, scale=args.scale, window=args.window
    )
    svc = DetectionService(
        list(DEFAULT_PORTFOLIO),
        window=args.window,
        thresholds=dict(DEFAULT_PORTFOLIO),
        witnesses=args.witnesses,
        device=args.device,
    )
    server = TriageServer(svc, audit_path=args.audit)
    feed = make_feed(ds.graph, args.batch)
    if args.max_batches:
        feed = feed[: args.max_batches]
    print(
        f"serving {sum(len(b[0]) for b in feed)} txns "
        f"({len(feed)} batches of {args.batch}) through "
        f"{args.submitters} submitters, witnesses={args.witnesses}"
    )
    out = load_test(server, feed, args.submitters)
    server.close()
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
