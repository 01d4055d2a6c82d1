"""`repro_torch.stream.chaos` — deterministic fault injection for the
streaming detection stack (the test/bench harness behind
`repro_torch.stream.resilience`).

A :class:`FaultInjector` is armed with :class:`FaultSpec`\\ s naming a
**fault point** — a stage boundary the service fires on its way through
a tick — and fires there either by raising (``TransientFault`` for
retryable failures, any other exception type for hard ones) or by
simulating a SIGKILL (``kill=True`` → ``os._exit(9)``: no ``finally``
blocks, no rollback — exactly what a power loss leaves behind, which is
what the WAL + checkpoint recovery path must absorb).

Fault points fired by the stack (all AFTER the stage's state mutations,
so a surviving rollback is actually exercised):

  ``ingest``     — after the store ingested the batch
  ``mine``       — after a pattern's counts were written
  ``score``      — entering the scoring stage
  ``witness``    — entering evidence extraction
  ``wal``        — before the WAL append of an accepted batch
  ``checkpoint`` — before anything durable is written
  ``checkpoint_commit`` — after the checkpoint committed, before WAL
                   truncation/pruning

Poisoned-input generation (:func:`make_poisoned_batch`) lives here too:
NaN amounts, negative/overflow/non-finite timestamps, negative node
ids, and uncoercible dtypes — the quarantine layer's test diet.

Everything is deterministic: specs match on (point, tick) and disarm
after ``times`` firings, so a chaos test injects exactly the fault it
names, exactly where it names it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "InjectedFault",
    "TransientFault",
    "FaultSpec",
    "FaultInjector",
    "make_poisoned_batch",
    "POISON_KINDS",
]


class InjectedFault(RuntimeError):
    """A chaos-injected hard failure (not retried by the resilience
    layer's transient-retry loop)."""


class TransientFault(InjectedFault):
    """A chaos-injected *transient* failure — the kind the degradation
    ladder retries with backoff."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: fire at ``point`` (optionally only on ``tick``),
    ``times`` times, by raising ``exc`` — or by dying outright when
    ``kill`` is set."""

    point: str
    tick: Optional[int] = None  # None = any tick
    times: int = 1  # -1 = never disarm
    exc: type = TransientFault
    kill: bool = False
    fired: int = 0


class FaultInjector:
    """The armory: the service calls :meth:`fire` at each fault point;
    matching armed specs raise (or kill).  ``log`` records every firing
    as ``(point, tick)`` for test assertions."""

    def __init__(self):
        self.specs: List[FaultSpec] = []
        self.log: List[Tuple[str, int]] = []

    def arm(
        self,
        point: str,
        *,
        tick: Optional[int] = None,
        times: int = 1,
        exc: type = TransientFault,
        kill: bool = False,
    ) -> FaultSpec:
        spec = FaultSpec(point=point, tick=tick, times=times, exc=exc, kill=kill)
        self.specs.append(spec)
        return spec

    def disarm(self) -> None:
        self.specs = []

    def fire(self, point: str, tick: int) -> None:
        for spec in self.specs:
            if spec.point != point:
                continue
            if spec.tick is not None and spec.tick != tick:
                continue
            if spec.times >= 0 and spec.fired >= spec.times:
                continue
            spec.fired += 1
            self.log.append((point, tick))
            if spec.kill:
                # simulate SIGKILL: no unwinding, no rollback, no atexit —
                # recovery must come from the WAL + committed checkpoints
                os._exit(9)
            raise spec.exc(f"chaos: injected fault at {point!r} (tick {tick})")


POISON_KINDS = (
    "nan_amount",
    "negative_timestamp",
    "overflow_timestamp",
    "non_finite_timestamp",
    "negative_node",
    "non_integer_node",
)


def make_poisoned_batch(
    rng: np.random.Generator,
    n_clean: int = 6,
    n_nodes: int = 32,
    t_base: int = 1000,
    kinds: Tuple[str, ...] = POISON_KINDS,
):
    """A microbatch of ``n_clean`` valid rows plus one poisoned row per
    requested kind, shuffled.  Returns ``(src, dst, t, amount, bad)``
    where ``bad`` marks the poisoned rows — the quarantine layer must
    dead-letter exactly those and ingest the rest.

    Arrays are float64 so NaN/overflow values are representable; the
    validator owns the cast back to the store's dtypes.
    """
    n = n_clean + len(kinds)
    src = rng.integers(0, n_nodes, n).astype(np.float64)
    dst = (src + 1 + rng.integers(0, n_nodes - 1, n)) % n_nodes
    t = (t_base + rng.integers(0, 64, n)).astype(np.float64)
    amount = rng.uniform(1.0, 100.0, n)
    bad = np.zeros(n, dtype=bool)
    for i, kind in enumerate(kinds):
        row = n_clean + i
        bad[row] = True
        if kind == "nan_amount":
            amount[row] = np.nan
        elif kind == "negative_timestamp":
            t[row] = -5.0
        elif kind == "overflow_timestamp":
            t[row] = 1e19  # past int64
        elif kind == "non_finite_timestamp":
            t[row] = np.inf
        elif kind == "negative_node":
            src[row] = -3.0
        elif kind == "non_integer_node":
            dst[row] = 4.5
        else:  # pragma: no cover - unknown kind is a test bug
            raise ValueError(f"unknown poison kind {kind!r}")
    order = rng.permutation(n)
    return src[order], dst[order], t[order], amount[order], bad[order]
