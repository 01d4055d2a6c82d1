"""`repro_torch.obs.trace` — nested span tracer with Chrome trace-event export.

A **span** is one timed region of the pipeline (``compile``,
``schedule_build``, ``stage``, ``dispatch:shard3``, ``tick:mine``, ...)
recorded with wall time, thread id, its parent span (per-thread nesting
stack), free-form attributes, and optional **counter deltas**: pass
``stats=some_dict`` and the numeric values of that dict are snapshotted
at span entry and diffed at exit, so a ``dispatch:shard{k}`` span carries
exactly the ``kernel_calls`` / ``bytes_h2d`` / ... it caused.

Design constraints (this module is threaded through the mining hot
paths):

* **Off by default, near-zero disabled overhead.**  ``span()`` on a
  disabled tracer is ONE branch returning a shared no-op context
  manager — no allocation, no lock, no clock read.  The streaming bench
  budget is < 2% p50 tick overhead with tracing disabled
  (``tests/test_obs.py`` bounds it in a microbench-style unit test).
* **Thread-safe.**  The sharded dispatch pool enters spans from one
  worker thread per device concurrently; the nesting stack is
  thread-local and finished spans append to a lock-guarded list.
* **No host syncs.**  Spans time *dispatch*, not device completion: CUDA
  launches are asynchronous, so a ``dispatch:shard{k}`` span closing
  means the shard's launches were *submitted*, not that the device
  finished them.  Device execution overlaps later spans (that overlap
  is exactly what the trace view shows); only the ``gather`` span ends
  after real device work, because the fetch blocks.  The tracer itself
  never touches a device tensor.

Exports:

* :meth:`Tracer.export_chrome` — Chrome trace-event JSON (the
  ``traceEvents`` array of ``"ph": "X"`` complete events), loadable in
  ``chrome://tracing`` or https://ui.perfetto.dev.  Thread lanes are
  real OS thread ids, so per-shard dispatch overlap is visible as
  parallel lanes.
* :meth:`Tracer.summary` — plain-text hierarchical aggregate (span name
  path -> count / total / mean wall), for logs and CI output.

Usage::

    from repro_torch.obs import trace
    trace.enable()
    session.mine(backend="sharded")
    trace.get_tracer().export_chrome("/tmp/mine.trace.json")
    print(trace.get_tracer().summary())
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "enable",
    "disable",
    "is_enabled",
    "span",
]


class _NoopSpan:
    """Shared do-nothing context manager: the disabled-tracer fast path.

    A single instance is returned by every ``span()`` call on a disabled
    tracer, so the disabled cost is one attribute load, one branch, and
    two trivial method calls — no allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self

    @property
    def span_id(self) -> Optional[int]:
        return None


_NOOP = _NoopSpan()


class Span:
    """One live span: records itself into the tracer on ``__exit__``."""

    __slots__ = (
        "tracer",
        "name",
        "attrs",
        "_stats",
        "_stats_before",
        "span_id",
        "parent_id",
        "tid",
        "t0_ns",
    )

    def __init__(self, tracer: "Tracer", name: str, attrs: dict, stats):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self._stats = stats
        self._stats_before = (
            None
            if stats is None
            else {k: v for k, v in stats.items() if isinstance(v, (int, float))}
        )
        self.span_id = None
        self.parent_id = None
        self.tid = 0
        self.t0_ns = 0

    def set(self, **attrs) -> "Span":
        """Attach attributes mid-span (chainable)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self.tracer
        self.span_id = tr._next_id()
        self.tid = threading.get_ident()
        stack = tr._stack()
        self.parent_id = stack[-1] if stack else None
        stack.append(self.span_id)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1_ns = time.perf_counter_ns()
        tr = self.tracer
        stack = tr._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if self._stats_before is not None:
            for k, v0 in self._stats_before.items():
                v1 = self._stats.get(k, v0)
                if isinstance(v1, (int, float)) and v1 != v0:
                    self.attrs[k] = v1 - v0
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        tr._record(
            {
                "id": self.span_id,
                "parent": self.parent_id,
                "name": self.name,
                "tid": self.tid,
                "t0_ns": self.t0_ns,
                "dur_ns": t1_ns - self.t0_ns,
                "attrs": self.attrs,
            }
        )
        return False


class Tracer:
    """Span collector.  One process-global instance (:func:`get_tracer`)
    serves the whole stack; tests may construct private ones."""

    def __init__(self, enabled: bool = False, capacity: int = 200_000):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)  # drop-oldest bound on kept spans
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._id_lock = threading.Lock()
        self._id = 0
        self.dropped = 0

    # -- span plumbing --------------------------------------------------
    def _next_id(self) -> int:
        with self._id_lock:
            self._id += 1
            return self._id

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _record(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self.capacity:
                drop = len(self._events) - self.capacity
                del self._events[:drop]
                self.dropped += drop

    def span(self, name: str, *, stats: Optional[dict] = None, **attrs):
        """A context manager timing ``name``.  THE hot-path call: one
        branch when disabled."""
        if not self.enabled:
            return _NOOP
        return Span(self, name, attrs, stats)

    def current_span_id(self) -> Optional[int]:
        """Id of the innermost open span on this thread (None when
        disabled or outside any span) — the cross-reference key audit
        logs and tick reports carry."""
        if not self.enabled:
            return None
        st = self._stack()
        return st[-1] if st else None

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration marker event (degradation bumps, retries)."""
        if not self.enabled:
            return
        self._record(
            {
                "id": self._next_id(),
                "parent": self.current_span_id(),
                "name": name,
                "tid": threading.get_ident(),
                "t0_ns": time.perf_counter_ns(),
                "dur_ns": 0,
                "attrs": attrs,
            }
        )

    # -- control --------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._events = []
            self.dropped = 0

    def spans(self) -> List[dict]:
        """Finished spans, oldest first (copies the list, not the
        dicts)."""
        with self._lock:
            return list(self._events)

    # -- exports --------------------------------------------------------
    def export_chrome(self, path: Optional[str] = None) -> dict:
        """The trace as a Chrome trace-event JSON object (written to
        ``path`` when given).  Spans become ``"ph": "X"`` complete
        events; zero-duration markers become ``"ph": "i"`` instants.
        Load in ``chrome://tracing`` or https://ui.perfetto.dev — each
        OS thread is a lane, so sharded dispatch overlap and the
        tick-stage breakdown read directly off the view."""
        events = []
        for ev in self.spans():
            args = {
                k: v
                for k, v in ev["attrs"].items()
                if isinstance(v, (str, int, float, bool))
            }
            args["span_id"] = ev["id"]
            if ev["parent"] is not None:
                args["parent_span_id"] = ev["parent"]
            base = {
                "name": ev["name"],
                "cat": ev["name"].split(":")[0],
                "pid": 1,
                "tid": ev["tid"],
                "ts": ev["t0_ns"] / 1e3,  # trace-event ts unit is us
                "args": args,
            }
            if ev["dur_ns"] == 0:
                events.append({**base, "ph": "i", "s": "t"})
            else:
                events.append({**base, "ph": "X", "dur": ev["dur_ns"] / 1e3})
        out = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(out, f)
        return out

    def summary(self) -> str:
        """Plain-text hierarchical roll-up: spans aggregated by their
        name path (root -> ... -> name), children indented under
        parents, each line ``count  total_ms  mean_ms  name``."""
        spans = self.spans()
        by_id = {ev["id"]: ev for ev in spans}

        def path_of(ev) -> tuple:
            names: List[str] = []
            seen = set()
            cur = ev
            while cur is not None and cur["id"] not in seen:
                seen.add(cur["id"])
                names.append(cur["name"])
                cur = by_id.get(cur["parent"])
            return tuple(reversed(names))

        agg: Dict[tuple, List[float]] = {}
        for ev in spans:
            p = path_of(ev)
            ent = agg.setdefault(p, [0, 0.0])
            ent[0] += 1
            ent[1] += ev["dur_ns"] / 1e6
        lines = [f"{'count':>7}  {'total_ms':>10}  {'mean_ms':>9}  span"]
        for p in sorted(agg):
            n, tot = agg[p]
            indent = "  " * (len(p) - 1)
            lines.append(
                f"{n:>7}  {tot:>10.2f}  {tot / max(1, n):>9.3f}  "
                f"{indent}{p[-1]}"
            )
        if self.dropped:
            lines.append(f"# {self.dropped} spans dropped (capacity)")
        return "\n".join(lines)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer every instrumented module shares."""
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the global tracer (tests); returns the previous one."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def enable() -> None:
    _TRACER.enable()


def disable() -> None:
    _TRACER.disable()


def is_enabled() -> bool:
    return _TRACER.enabled


def span(name: str, *, stats: Optional[dict] = None, **attrs):
    """Module-level convenience: a span on the global tracer.  This is
    the call sites' entry point — when tracing is disabled it costs one
    global load, one attribute branch, and the shared no-op manager."""
    return _TRACER.span(name, stats=stats, **attrs)
