"""`repro_torch.obs.flight` — bounded flight recorder for streaming ticks.

A black box for the detection service: a ring buffer of the last ``N``
:class:`~repro_torch.stream.service.TickReport`-shaped records, each paired
with the span tree the tick produced (when tracing was enabled).  On a
fault — a chaos-injected failure, an exhausted-retry tick, a
``SubmitError`` surfaced by the triage server — the recorder dumps the
whole ring plus the failure record to a JSONL **postmortem bundle**, so
the ticks *leading up to* the crash are preserved with their per-stage
latency attribution, not just the crash itself.

Recording is cheap (one dict append under a lock per tick; span trees
are only attached when the tracer is enabled) and always on: the value
of a flight recorder is precisely that it was running before anyone
knew they needed it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import List, Optional

from repro_torch.obs import trace as _trace

__all__ = ["FlightRecorder"]


def _jsonable(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = dataclasses.asdict(x)
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "item") and callable(getattr(x, "item", None)):
        try:
            return x.item()  # numpy scalar
        except (ValueError, TypeError):
            return str(x)
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return str(x)


class FlightRecorder:
    """Ring buffer of tick records + their span trees.

    ``record(report, span_id=...)`` snapshots one tick: the report (any
    dataclass or dict), a wall-clock stamp, and — when the global tracer
    is enabled — every finished span belonging to the tick's span tree
    (matched by walking ``parent`` links up to ``span_id``).

    ``dump(path, reason=...)`` writes the ring oldest-first as JSON
    lines, preceded by one header line, and returns the path.
    """

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._ring: List[dict] = []
        self._lock = threading.Lock()
        self.n_recorded = 0
        self.n_dumps = 0

    def __len__(self) -> int:
        return len(self._ring)

    def _tick_spans(self, span_id: Optional[int]) -> Optional[list]:
        tracer = _trace.get_tracer()
        if span_id is None or not tracer.enabled:
            return None
        spans = tracer.spans()
        by_id = {ev["id"]: ev for ev in spans}
        keep = []
        for ev in spans:
            cur = ev
            seen = set()
            while cur is not None and cur["id"] not in seen:
                if cur["id"] == span_id:
                    keep.append(
                        {
                            "id": ev["id"],
                            "parent": ev["parent"],
                            "name": ev["name"],
                            "tid": ev["tid"],
                            "t0_ns": ev["t0_ns"],
                            "dur_ns": ev["dur_ns"],
                            "attrs": _jsonable(ev["attrs"]),
                        }
                    )
                    break
                seen.add(cur["id"])
                cur = by_id.get(cur["parent"])
        return keep

    def record(self, report, span_id: Optional[int] = None) -> None:
        entry = {
            "wall_time": time.time(),
            "report": _jsonable(report),
            "span_id": span_id,
            "spans": self._tick_spans(span_id),
        }
        with self._lock:
            self._ring.append(entry)
            del self._ring[: -self.capacity]
            self.n_recorded += 1

    def last(self) -> Optional[dict]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def dump(
        self,
        path: str,
        reason: str = "on_demand",
        failure: Optional[dict] = None,
    ) -> str:
        """Write the postmortem bundle: a header line (reason, failure
        details, ring occupancy) then one JSON line per recorded tick,
        oldest first."""
        with self._lock:
            ring = list(self._ring)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(
                json.dumps(
                    {
                        "postmortem": True,
                        "reason": reason,
                        "failure": _jsonable(failure),
                        "wall_time": time.time(),
                        "ticks_recorded": self.n_recorded,
                        "ticks_in_ring": len(ring),
                    }
                )
                + "\n"
            )
            for entry in ring:
                f.write(json.dumps(entry) + "\n")
        self.n_dumps += 1
        return path
