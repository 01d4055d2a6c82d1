"""Fault tolerance: heartbeats, failure detection, elastic re-meshing,
straggler mitigation.

A copy of the JAX package's ``repro.distributed.fault_tolerance`` (it is
numpy only); the port's sharded executor (:mod:`repro_torch.core.shard`)
beats a :class:`Heartbeat` per device and feeds a
:class:`StragglerMonitor` per dispatch.

On a real multi-pod deployment each host runs a `Heartbeat` (file/KV-store
based liveness) and the coordinator applies `plan_remesh` when membership
changes: training resumes from the last committed checkpoint on the
largest (pod, data, model) mesh the surviving chips support — the
checkpoint layout is mesh-agnostic (see distributed/checkpoint.py), so no
resharding tooling is needed beyond device_put.

Straggler mitigation operates at two levels:
  * static — the degree-aware LPT edge partitioner bounds per-partition
    mining cost skew (graph/partition.py: `PartitionPlan.skew`),
  * dynamic — `StragglerMonitor` tracks per-step host timings and flags
    hosts slower than `threshold` x median for data-reshard/eviction.

Everything here is deterministic and unit-tested; the failure-injection
test kills a training run mid-step (subprocess SIGKILL) and proves
bit-exact resume, including onto a different mesh shape.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Heartbeat", "plan_remesh", "StragglerMonitor"]


class Heartbeat:
    """File-based liveness (stands in for the cluster KV store)."""

    def __init__(self, root: str, host_id: str, timeout_s: float = 30.0):
        self.root = root
        self.host_id = host_id
        self.timeout_s = timeout_s
        os.makedirs(root, exist_ok=True)

    def beat(self, step: Optional[int] = None) -> None:
        payload = {"t": time.time(), "step": step}
        path = os.path.join(self.root, f"{self.host_id}.hb")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def alive_hosts(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        out = []
        for name in os.listdir(self.root):
            if not name.endswith(".hb"):
                continue
            try:
                with open(os.path.join(self.root, name)) as f:
                    t = json.load(f)["t"]
            except Exception:
                continue
            if now - t <= self.timeout_s:
                out.append(name[:-3])
        return sorted(out)


def plan_remesh(
    n_alive_chips: int,
    model_parallel: int = 16,
    chips_per_pod: int = 256,
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (pod, data, model) mesh the surviving chips support.

    Keeps TP (model) fixed — TP degree is an arch property — and shrinks
    data/pod parallelism to the largest multiple that fits.
    """
    if n_alive_chips < model_parallel:
        raise RuntimeError(
            f"cannot keep model_parallel={model_parallel} with "
            f"{n_alive_chips} chips"
        )
    pods = max(1, n_alive_chips // chips_per_pod)
    per_pod = n_alive_chips // pods
    data = max(1, per_pod // model_parallel)
    if pods > 1:
        return (pods, data, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 1.5
    window: int = 16
    history: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def record(self, host: str, step_seconds: float) -> None:
        h = self.history.setdefault(host, [])
        h.append(float(step_seconds))
        if len(h) > self.window:
            del h[0]

    def medians(self) -> Dict[str, float]:
        return {h: float(np.median(v)) for h, v in self.history.items() if v}

    def stragglers(self) -> List[str]:
        med = self.medians()
        if len(med) < 2:
            return []
        global_med = float(np.median(list(med.values())))
        return sorted(
            h for h, m in med.items() if m > self.threshold * global_med
        )
