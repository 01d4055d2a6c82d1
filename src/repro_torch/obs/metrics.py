"""`repro_torch.obs.metrics` — typed metrics registry with Prometheus-style
text exposition.

One process-global :class:`MetricsRegistry` (:func:`get_registry`)
unifies the counters the system already keeps in loose dicts —
``repro_torch.core.executor.STAT_KEYS``, the store's ``STORE_STAT_KEYS``, and
the resilience counters — behind three typed instruments:

* :class:`Counter` — monotone totals (``inc``); e.g. kernel launches,
  quarantined rows.
* :class:`Gauge` — point-in-time values (``set``); e.g. JIT cache size,
  degradation-ladder level, per-device worker liveness beats.
* :class:`Histogram` — latency/size distributions with p50/p90/p99
  quantile estimation over a bounded reservoir (``observe``); e.g. tick
  seconds, per-shard dispatch walls.

Instruments are get-or-create by ``(name, labels)`` — labels are an
optional dict rendered Prometheus-style (``name{device="cpu:3"} 42``) —
and every mutation is lock-guarded per instrument, so the sharded
dispatch pool can hammer one counter from every worker thread without
dropping increments (``tests/test_obs.py`` asserts bit-exact totals
under a thread hammer).

:meth:`MetricsRegistry.exposition` renders the whole registry in the
Prometheus text format (``# HELP`` / ``# TYPE`` + samples; histograms as
summary-style quantile samples plus ``_count`` / ``_sum``);
:meth:`MetricsRegistry.snapshot` returns the same data as a plain dict
for JSON endpoints (``TriageServer.metrics()``).

Helper :func:`observe_stats` maps one of the legacy stat dicts onto the
registry in a single call (counters for monotone keys, gauges for the
gauge-semantics keys like ``jit_cache_entries``).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "observe_stats",
    "GAUGE_STAT_KEYS",
]

# keys of the legacy executor stat dict that are gauges, not counters
# (see the STAT_KEYS glossary in repro_torch.core.executor)
GAUGE_STAT_KEYS = ("jit_cache_entries",)


def _fmt_labels(labels: Optional[Tuple[Tuple[str, str], ...]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels=None):
        self.name = name
        self.help = help
        self.labels = labels  # canonical tuple of (key, value) pairs
        self._lock = threading.Lock()

    def samples(self) -> List[Tuple[str, float]]:  # [(suffix+labels, value)]
        raise NotImplementedError


class Counter(_Instrument):
    """Monotone total.  ``inc`` is lock-guarded: `+=` on a Python int is
    read-modify-write and WOULD drop increments under the dispatch
    pool's thread contention."""

    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def samples(self):
        return [(_fmt_labels(self.labels), self._value)]


class Gauge(_Instrument):
    """Point-in-time value; ``set`` replaces, ``max_set`` keeps the
    running max (useful for high-water marks like JIT cache size)."""

    kind = "gauge"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def max_set(self, v: float) -> None:
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self):
        return self._value

    def samples(self):
        return [(_fmt_labels(self.labels), self._value)]


class Histogram(_Instrument):
    """Distribution with quantile estimation over a bounded reservoir.

    The first ``reservoir`` observations are kept exactly (quantiles
    then match ``np.percentile`` bit-for-bit — asserted in tests); past
    that, uniform reservoir sampling via a deterministic LCG keeps a
    fixed-size representative sample.  ``count`` and ``sum`` stay exact
    regardless."""

    kind = "histogram"

    def __init__(self, name, help="", labels=None, reservoir: int = 8192):
        super().__init__(name, help, labels)
        self.reservoir = int(reservoir)
        self._samples: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._rng = 0x9E3779B9  # deterministic LCG state (no random dep)

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            if len(self._samples) < self.reservoir:
                self._samples.append(v)
            else:
                # Algorithm R: replace a uniform slot in [0, count)
                self._rng = (self._rng * 1103515245 + 12345) & 0x7FFFFFFF
                j = self._rng % self._count
                if j < self.reservoir:
                    self._samples[j] = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile of the reservoir, ``q`` in
        [0, 1] (matches ``np.percentile(samples, q * 100)``)."""
        with self._lock:
            if not self._samples:
                return float("nan")
            return float(np.percentile(np.asarray(self._samples), q * 100.0))

    def samples(self):
        lab = self.labels or ()
        out = []
        for q in (0.5, 0.9, 0.99):
            out.append(
                (
                    _fmt_labels(lab + (("quantile", f"{q:g}"),)),
                    self.quantile(q),
                )
            )
        out.append(("_count" + _fmt_labels(lab), self._count))
        out.append(("_sum" + _fmt_labels(lab), self._sum))
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create instrument store keyed on (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple, _Instrument] = {}

    def _get(self, kind: str, name: str, help: str, labels, **kw):
        lab = (
            tuple(sorted((str(k), str(v)) for k, v in labels.items()))
            if labels
            else None
        )
        key = (name, lab)
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = _KINDS[kind](name, help=help, labels=lab, **kw)
                    self._instruments[key] = inst
        if inst.kind != kind:
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {kind}"
            )
        return inst

    def counter(self, name, help="", labels=None) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name, help="", labels=None) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(
        self, name, help="", labels=None, reservoir: int = 8192
    ) -> Histogram:
        return self._get(
            "histogram", name, help, labels, reservoir=reservoir
        )

    def reset(self) -> None:
        with self._lock:
            self._instruments = {}

    # -- exports --------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Flat ``{rendered_name: value}`` dict (JSON-friendly; the
        TriageServer ``metrics()`` endpoint returns this)."""
        out: Dict[str, float] = {}
        with self._lock:
            insts = list(self._instruments.values())
        for inst in insts:
            for suffix, v in inst.samples():
                out[inst.name + suffix] = v
        return out

    def exposition(self) -> str:
        """Prometheus text exposition of every instrument."""
        with self._lock:
            insts = list(self._instruments.values())
        by_name: Dict[str, List[_Instrument]] = {}
        for inst in insts:
            by_name.setdefault(inst.name, []).append(inst)
        lines: List[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            kind = group[0].kind
            help_ = next((g.help for g in group if g.help), "")
            lines.append(f"# HELP {name} {help_}")
            # histograms expose quantile samples -> Prometheus "summary"
            lines.append(
                f"# TYPE {name} "
                f"{'summary' if kind == 'histogram' else kind}"
            )
            for inst in group:
                for suffix, v in inst.samples():
                    lines.append(f"{name}{suffix} {v}")
        return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry all instrumented modules share."""
    return _REGISTRY


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the global registry (tests); returns the previous one."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = reg
    return prev


def observe_stats(
    stats: Dict[str, int],
    prefix: str,
    registry: Optional[MetricsRegistry] = None,
    gauge_keys: Tuple[str, ...] = GAUGE_STAT_KEYS,
) -> None:
    """Fold one legacy stat-dict *delta* into the registry: each key
    becomes ``{prefix}_{key}`` — a Counter incremented by the delta, or
    (for ``gauge_keys``) a Gauge tracking the high-water mark.  Callers
    pass per-call/per-tick deltas, not lifetime totals."""
    reg = registry if registry is not None else _REGISTRY
    for k, v in stats.items():
        if not isinstance(v, (int, float)):
            continue
        name = f"{prefix}_{k}"
        if k in gauge_keys:
            reg.gauge(name).max_set(v)
        else:
            reg.counter(name).inc(v)
