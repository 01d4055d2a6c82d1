"""`repro_torch.stream.resilience` — fault-tolerant streaming detection
(a copy of the JAX package's ``repro.stream.resilience`` over the port's
:class:`~repro_torch.stream.service.DetectionService`).

Wraps :class:`repro_torch.stream.service.DetectionService` (whose ticks are
already transactional: any mid-tick failure rolls the store, counts,
and tick counters back bit-exactly) with the durability and
graceful-degradation layers a production deployment needs:

**Input quarantine** — :class:`BatchValidator` dead-letters rows the
store would otherwise corrupt on (NaN amounts, negative / overflow /
non-integral timestamps, negative or non-integral node ids) and —
under the default ``late_policy="quarantine"`` — rows arriving below
the eviction cutoff (the lateness *contract breach* that previously
degraded silently to stale counts).  Whole batches with mismatched
lengths or uncoercible dtypes are rejected outright.  Per-tick
``rejected`` / ``quarantined`` / ``late_contract_breach`` counters land
on the :class:`~repro_torch.stream.service.TickReport`; dead-lettered rows
are appended as JSONL to ``quarantine_path`` when set.

**Write-ahead log + checkpoints** — every *accepted* (post-quarantine)
microbatch is appended to a :class:`WriteAheadLog` (one atomic ``.npz``
per tick) before it is applied; every ``checkpoint_every`` ticks the
full mutable state (store arrival columns + run index + counters,
per-pattern counts, executor counters, tick) is written through
:func:`repro_torch.distributed.checkpoint.save_checkpoint` (step-atomic:
a COMMIT marker published by atomic rename — a kill mid-write leaves
an ignorable ``.tmp``).  :meth:`ResilientDetectionService.recover`
restores the latest committed checkpoint, replays the WAL tail, and
resumes with counts **bit-identical** to the uninterrupted run.  A
tick that ultimately fails removes its WAL entry and dead-letters the
batch, so the live (rolled-back) state and the recovered state agree.

**Degradation ladder with retry** — transient failures
(:class:`repro_torch.stream.chaos.TransientFault` by default) are retried
with exponential backoff, each retry ascending ``DEGRADATION_LADDER``:

  1. ``witnesses_off``  — shed evidence extraction (inert until
     witnesses are ported: the port's service takes no ``witnesses=k``);
  2. ``single_device``  — retry on attempt-local plan caches.  The
     reference falls back to its ``xla`` backend here; the port has no
     second device path to fall to, so the attempt keeps the service's
     backend (a kernel that fails to build or launch raises) and only
     rebuilds its plans, which keeps the tick's counters equal to the
     reference's;
  3. ``count_only``     — skip scoring/alerting entirely, keep the
     incremental counts exact.

A per-tick ``deadline_ms`` budget makes the ladder *sticky*: a tick
that blows its deadline raises the standing level (shedding work on
subsequent ticks); ``recover_after_ticks`` consecutive in-budget ticks
walk it back down.  Every step taken is recorded on the tick report's
``degraded`` tuple, retries on ``retries``.

Fault injection for all of the above lives in :mod:`repro_torch.stream.chaos`.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import executor
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.distributed.checkpoint import (
    latest_step,
    prune,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.stream.chaos import TransientFault
from repro_torch.stream.service import AlertBatch, DetectionService

__all__ = [
    "DEGRADATION_LADDER",
    "ResilienceConfig",
    "BatchValidator",
    "WriteAheadLog",
    "ResilientDetectionService",
]

# shedding order: cheapest-to-lose first; ``level`` k applies rungs [:k]
DEGRADATION_LADDER: Tuple[str, ...] = (
    "witnesses_off",
    "single_device",
    "count_only",
)

_T_MAX = np.int64(2**62)  # timestamp sanity bound (far below int64 wrap)
_NODE_MAX = np.int64(2**31 - 1)  # node ids are int32


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs of :class:`ResilientDetectionService` (all durability paths
    optional — ``None`` disables that layer)."""

    wal_dir: Optional[str] = None  # accepted-batch write-ahead log
    checkpoint_dir: Optional[str] = None  # durable full-state snapshots
    # flight-recorder postmortem bundles (repro_torch.obs.flight): a tick that
    # exhausts its retries dumps the last-N-ticks ring + failure record
    # to ``{postmortem_dir}/postmortem_tick_{tick}.jsonl``
    postmortem_dir: Optional[str] = None
    checkpoint_every: int = 8  # ticks between checkpoints
    keep_checkpoints: int = 2
    validate: bool = True  # input quarantine on/off
    quarantine_path: Optional[str] = None  # JSONL dead-letter sink
    late_policy: str = "quarantine"  # "quarantine" | "ingest"
    deadline_ms: Optional[float] = None  # per-tick latency budget
    max_retries: int = 2  # transient-failure retries per tick
    backoff_s: float = 0.01  # first retry sleep
    backoff_multiplier: float = 4.0
    recover_after_ticks: int = 4  # in-budget ticks before level decays
    retryable: Tuple[type, ...] = (TransientFault,)


# ----------------------------------------------------------------------
# input quarantine
# ----------------------------------------------------------------------
class BatchValidator:
    """Schema + value validation for one transaction microbatch.

    :meth:`validate` never raises on bad data: it returns the clean rows
    in the store's dtypes plus dead-letter records and per-reason counts.
    Batch-level defects (length mismatch, dtypes that cannot coerce to
    numbers) reject the WHOLE batch — there is no row-level trust left.
    """

    def __init__(self, late_policy: str = "quarantine"):
        if late_policy not in ("quarantine", "ingest"):
            raise ValueError(f"unknown late_policy {late_policy!r}")
        self.late_policy = late_policy

    def validate(
        self,
        src,
        dst,
        t,
        amount=None,
        *,
        cutoff: int = 0,
    ):
        """-> ``(src, dst, t, amount, records, counts)`` where the first
        four are the clean rows (``int32/int32/int64/float32-or-None``),
        ``records`` is a list of dead-letter dicts and ``counts`` maps
        ``{"rejected": n, "quarantined": n, "late": n}``."""
        counts = {"rejected": 0, "quarantined": 0, "late": 0}
        empty = (
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.int64),
            None if amount is None else np.zeros(0, np.float32),
        )
        try:
            fsrc = np.asarray(src, dtype=np.float64).reshape(-1)
            fdst = np.asarray(dst, dtype=np.float64).reshape(-1)
            ft = np.asarray(t, dtype=np.float64).reshape(-1)
            famt = (
                None
                if amount is None
                else np.asarray(amount, dtype=np.float64).reshape(-1)
            )
        except (TypeError, ValueError):
            n = len(np.atleast_1d(np.asarray(src, dtype=object)))
            counts["rejected"] = n
            return (*empty, [{"reason": "uncoercible_dtype", "rows": n}], counts)
        lengths = {len(fsrc), len(fdst), len(ft)}
        if famt is not None:
            lengths.add(len(famt))
        if len(lengths) != 1:
            counts["rejected"] = max(lengths)
            return (
                *empty,
                [{"reason": "length_mismatch", "rows": max(lengths)}],
                counts,
            )
        n = len(fsrc)
        if n == 0:
            return (*empty, [], counts)

        reason = np.zeros(n, dtype=object)  # first failing reason per row

        def flag(mask: np.ndarray, why: str) -> None:
            fresh = mask & (reason == 0)
            reason[fresh] = why

        for col, what in ((fsrc, "src"), (fdst, "dst")):
            flag(~np.isfinite(col), f"non_finite_{what}")
            flag(col < 0, f"negative_{what}")
            flag(col > _NODE_MAX, f"{what}_overflow")
            flag(np.floor(col) != col, f"non_integer_{what}")
        flag(~np.isfinite(ft), "non_finite_timestamp")
        flag(ft < 0, "negative_timestamp")
        flag(ft > _T_MAX, "timestamp_overflow")
        flag(np.floor(ft) != ft, "non_integer_timestamp")
        if famt is not None:
            flag(~np.isfinite(famt), "nan_amount")
        bad = reason != 0
        counts["quarantined"] = int(bad.sum())

        late = ~bad & (ft < cutoff)
        counts["late"] = int(late.sum())
        if self.late_policy == "quarantine":
            reason[late] = "late_contract_breach"
            counts["quarantined"] += counts["late"]
            bad = bad | late

        records = [
            {
                "row": int(i),
                "reason": str(reason[i]),
                "src": float(fsrc[i]),
                "dst": float(fdst[i]),
                "t": float(ft[i]),
                "amount": None if famt is None else float(famt[i]),
            }
            for i in np.flatnonzero(bad)
        ]
        keep = ~bad
        return (
            fsrc[keep].astype(np.int32),
            fdst[keep].astype(np.int32),
            ft[keep].astype(np.int64),
            None if famt is None else famt[keep].astype(np.float32),
            records,
            counts,
        )


# ----------------------------------------------------------------------
# write-ahead log
# ----------------------------------------------------------------------
class WriteAheadLog:
    """Accepted-microbatch log: one atomic ``tick_%08d.npz`` per tick
    (written to a ``.tmp`` then :func:`os.replace`\\ d — a kill mid-write
    leaves nothing readable).  Entries are pruned once a checkpoint
    covers them and removed when their tick ultimately fails, so the set
    of committed entries after the last checkpoint IS the replay tail."""

    def __init__(self, wal_dir: str):
        self.dir = wal_dir
        os.makedirs(wal_dir, exist_ok=True)

    def _path(self, tick: int) -> str:
        return os.path.join(self.dir, f"tick_{tick:08d}.npz")

    def append(self, tick, src, dst, t, amount=None) -> str:
        path = self._path(tick)
        tmp = path + ".tmp.npz"
        np.savez(
            tmp,
            src=np.asarray(src, np.int32),
            dst=np.asarray(dst, np.int32),
            t=np.asarray(t, np.int64),
            amount=(
                np.zeros(0, np.float32)
                if amount is None
                else np.asarray(amount, np.float32)
            ),
            has_amount=np.array(0 if amount is None else 1, np.int64),
        )
        os.replace(tmp, path)
        return path

    def ticks(self) -> List[int]:
        out = []
        for p in glob.glob(os.path.join(self.dir, "tick_*.npz")):
            name = os.path.basename(p)
            if name.endswith(".tmp.npz"):
                continue
            out.append(int(name[len("tick_") : -len(".npz")]))
        return sorted(out)

    def last_tick(self) -> Optional[int]:
        ticks = self.ticks()
        return ticks[-1] if ticks else None

    def entries(self, after: int = 0):
        """Yield ``(tick, (src, dst, t, amount))`` for ticks > ``after``
        in order."""
        for tick in self.ticks():
            if tick <= after:
                continue
            with np.load(self._path(tick)) as z:
                amount = z["amount"] if int(z["has_amount"]) else None
                yield tick, (z["src"], z["dst"], z["t"], amount)

    def remove(self, tick: int) -> None:
        try:
            os.remove(self._path(tick))
        except FileNotFoundError:
            pass

    def prune_through(self, tick: int) -> None:
        for s in self.ticks():
            if s <= tick:
                self.remove(s)


# ----------------------------------------------------------------------
# the resilient service
# ----------------------------------------------------------------------
class ResilientDetectionService(DetectionService):
    """:class:`DetectionService` plus quarantine, WAL + checkpoint
    durability, and the retrying degradation ladder.  Construct with the
    same arguments plus ``resilience=ResilienceConfig(...)``; recover a
    crashed process with :meth:`recover` (same constructor arguments —
    the portfolio is code, only the mutable state is durable)."""

    def __init__(self, *args, resilience: Optional[ResilienceConfig] = None, **kw):
        super().__init__(*args, **kw)
        self.resilience = resilience or ResilienceConfig()
        cfg = self.resilience
        self.validator = BatchValidator(cfg.late_policy)
        self.wal = WriteAheadLog(cfg.wal_dir) if cfg.wal_dir else None
        self._level = 0  # standing degradation-ladder level
        self._clean_streak = 0  # in-budget ticks since last breach
        self.dead_letters: List[dict] = []  # bounded tail, see _dead_letter
        self.totals = {"rejected": 0, "quarantined": 0, "dead_letter_ticks": 0}

    # -- dead-letter sink ----------------------------------------------
    def _dead_letter(self, records: List[dict]) -> None:
        if not records:
            return
        stamped = [{"tick": self.tick, **r} for r in records]
        self.dead_letters.extend(stamped)
        del self.dead_letters[:-256]  # keep a bounded tail in memory
        if self.resilience.quarantine_path:
            with open(self.resilience.quarantine_path, "a") as f:
                for r in stamped:
                    f.write(json.dumps(r) + "\n")

    # -- degradation ladder --------------------------------------------
    def _apply_level(self, level: int):
        saved = (
            self.witnesses,
            self.backend,
            self._kernels,
            self._trace_keys,
            self._count_only,
        )
        if level >= 1:
            self.witnesses = 0  # always 0 until witnesses are ported
        if level >= 2:
            # the backend stays: the attempt gets fresh plan caches, so a
            # plan cached by the failed attempt is not reused
            self._kernels = {n: {} for n in self.pattern_names}
            self._trace_keys = {n: set() for n in self.pattern_names}
        if level >= 3:
            self._count_only = True
        return saved

    def _restore_level(self, saved) -> None:
        (
            self.witnesses,
            self.backend,
            self._kernels,
            self._trace_keys,
            self._count_only,
        ) = saved

    # -- the resilient tick --------------------------------------------
    def _replay_orphans(self) -> None:
        """Re-enter ticks whose ingest a pipelined commit failure rolled
        back (:attr:`DetectionService.orphaned`).  Each orphan was
        already validated and WAL-logged at its original submission, so
        it re-enters the bare tick path directly — no second WAL entry,
        no re-validation — with its original report notes restored."""
        while self.orphaned:
            tick, inp, notes = self.orphaned.pop(0)
            saved_notes = self._tick_notes
            self._tick_notes = dict(notes)
            try:
                DetectionService.submit(self, *inp)
            except BaseException:
                self.orphaned.insert(0, (tick, inp, notes))
                raise
            finally:
                self._tick_notes = saved_notes

    def submit(
        self,
        src,
        dst,
        t,
        amount=None,
        *,
        _from_wal: bool = False,
    ) -> Optional[AlertBatch]:
        cfg = self.resilience
        if _from_wal and self.pipeline:
            # WAL replay is strictly sequential: every replayed tick must
            # commit before the next is applied, or a replayed-in-flight
            # tick could be skipped by a checkpoint taken mid-replay
            self.pipeline = False
            try:
                return self.submit(src, dst, t, amount, _from_wal=True)
            finally:
                self.pipeline = True
        notes: Dict[str, object] = {}
        if cfg.validate and not _from_wal:
            src, dst, t, amount, records, counts = self.validator.validate(
                src, dst, t, amount, cutoff=self.store._cutoff
            )
            self._dead_letter(records)
            notes["rejected"] = counts["rejected"]
            notes["quarantined"] = counts["quarantined"]
            # under late_policy="ingest" the late rows reach the store,
            # which counts them itself — don't double-count on the report
            if cfg.late_policy == "quarantine":
                notes["late"] = counts["late"]
            self.totals["rejected"] += counts["rejected"]
            self.totals["quarantined"] += counts["quarantined"]
        wal_tick = self.tick + 1
        if self.wal is not None and not _from_wal:
            with obs_trace.span("tick:wal", tick=wal_tick, n_rows=len(src)):
                self._fire("wal")
                self.wal.append(wal_tick, src, dst, t, amount)

        level = min(3, len(DEGRADATION_LADDER), self._level)
        if _from_wal:
            # replay only needs the counts/store to advance — alerts and
            # evidence were already served by the original run; it mines
            # on the service's own backend, since no rung changes it
            level = len(DEGRADATION_LADDER)
        backoff = cfg.backoff_s
        attempt = 0
        while True:
            saved = self._apply_level(level)
            self._tick_notes = dict(
                notes,
                degraded=DEGRADATION_LADDER[:level],
                retries=attempt,
            )
            if cfg.deadline_ms is not None and not _from_wal:
                self._tick_deadline = (
                    time.perf_counter() + cfg.deadline_ms / 1000.0
                )
            try:
                # a prior pipelined commit failure may have rolled back
                # an already-ingested predecessor: replay it first so the
                # stream re-enters in WAL order
                self._replay_orphans()
                batch = super().submit(src, dst, t, amount)
            except cfg.retryable as e:
                if attempt >= cfg.max_retries:
                    self._abandon_tick(
                        wal_tick, src, dst, t, amount, _from_wal, failure=e
                    )
                    raise
                attempt += 1
                obs_metrics.get_registry().counter(
                    "repro_resilience_retries_total",
                    help="transient-failure tick retries",
                ).inc()
                level = min(level + 1, len(DEGRADATION_LADDER))
                time.sleep(backoff)
                backoff *= cfg.backoff_multiplier
                continue
            except BaseException as e:
                # hard failure: the transactional tick already rolled
                # back; drop the WAL entry and dead-letter the batch so
                # live state == recovered state
                self._abandon_tick(
                    wal_tick, src, dst, t, amount, _from_wal, failure=e
                )
                raise
            finally:
                self._restore_level(saved)
                self._tick_notes = {}
                self._tick_deadline = None
            break

        if not _from_wal:
            # pipelined submits return the PREVIOUS tick's batch (None
            # on the first call): the ladder settles on whatever report
            # just committed
            if batch is not None:
                self._settle_level(batch.report, cfg)
            if (
                cfg.checkpoint_dir
                and cfg.checkpoint_every > 0
                and self.tick % cfg.checkpoint_every == 0
            ):
                self.checkpoint()
        obs_metrics.get_registry().gauge(
            "repro_resilience_level",
            help="standing degradation-ladder level (0 = full service)",
        ).set(self._level)
        return batch

    def _abandon_tick(
        self,
        wal_tick: int,
        src,
        dst,
        t,
        amount,
        _from_wal: bool,
        failure: Optional[BaseException] = None,
    ) -> None:
        if self.wal is not None and not _from_wal:
            self.wal.remove(wal_tick)
        self.totals["dead_letter_ticks"] += 1
        n = len(np.atleast_1d(src))
        self._dead_letter([{"reason": "tick_failed", "rows": int(n)}])
        # orphans that never made it back in die with the tick: drop
        # their WAL entries too, so the recovered state matches the live
        # (rolled-back) state
        for otick, oinp, _ in self.orphaned:
            if self.wal is not None:
                self.wal.remove(otick)
            self.totals["dead_letter_ticks"] += 1
            self._dead_letter(
                [
                    {
                        "reason": "tick_failed",
                        "rows": int(len(np.atleast_1d(oinp[0]))),
                    }
                ]
            )
        self.orphaned.clear()
        self.postmortem(wal_tick, failure=failure)

    def postmortem(
        self, tick: int, failure: Optional[BaseException] = None
    ) -> Optional[str]:
        """Dump the flight-recorder ring (last N tick reports + span
        trees) as a JSONL postmortem bundle; called automatically when a
        tick exhausts its retries, callable on demand.  ``None`` when no
        ``postmortem_dir`` is configured."""
        if not self.resilience.postmortem_dir:
            return None
        path = os.path.join(
            self.resilience.postmortem_dir,
            f"postmortem_tick_{tick:08d}.jsonl",
        )
        return self.flight.dump(
            path,
            reason="tick_failed" if failure is not None else "on_demand",
            failure=(
                None
                if failure is None
                else {
                    "tick": tick,
                    "type": type(failure).__name__,
                    "message": str(failure),
                }
            ),
        )

    def _settle_level(self, report, cfg: ResilienceConfig) -> None:
        if cfg.deadline_ms is None:
            return
        if report.seconds * 1000.0 > cfg.deadline_ms:
            self._level = min(self._level + 1, len(DEGRADATION_LADDER))
            self._clean_streak = 0
        elif self._level > 0:
            self._clean_streak += 1
            if self._clean_streak >= cfg.recover_after_ticks:
                self._level -= 1
                self._clean_streak = 0

    # -- durability -----------------------------------------------------
    def _state_tree(self) -> dict:
        """The full mutable state as a checkpoint pytree: store state,
        per-pattern counts trimmed to the live id space, executor
        counters.  Structure depends only on the portfolio, so a fresh
        service's tree is a valid ``tree_like`` for restore."""
        n = self.store.n_edges_total
        return {
            "store": self.store.state_dict(),
            "counts": {
                name: self.counts[name][:n].copy()
                for name in self.pattern_names
            },
            "exec": np.array(
                [self.stats[k] for k in executor.STAT_KEYS], np.int64
            ),
        }

    def _load_state_tree(self, tree: dict, extra: dict) -> None:
        self.store.load_state(tree["store"])
        n = self.store.n_edges_total
        for name in self.pattern_names:
            c = np.asarray(tree["counts"][name], dtype=np.int64)
            buf = np.zeros(max(n, len(c), 1), np.int64)
            buf[: len(c)] = c
            self.counts[name] = buf
        self.stats = {
            k: int(v)
            for k, v in zip(executor.STAT_KEYS, np.asarray(tree["exec"]))
        }
        self.tick = int(extra["tick"])
        self.last_report = None
        self.last_plan = None

    def checkpoint(self) -> Optional[str]:
        """Write a committed checkpoint of the full state and prune the
        WAL entries it covers.  Step-atomic: a kill before the COMMIT
        rename leaves an aborted ``.tmp`` that recovery ignores."""
        cfg = self.resilience
        if not cfg.checkpoint_dir:
            return None
        if self._inflight is not None or self._done:
            # a checkpoint covers only COMMITTED ticks (its WAL prune
            # assumes the covered counts are final): drain the pipelined
            # tail first, and re-queue the drained batches so subsequent
            # pipelined submits keep returning them in order
            for b in self.flush():
                self._done.append(b)
        with obs_trace.span("tick:checkpoint", tick=self.tick):
            self._fire("checkpoint")
            path = save_checkpoint(
                cfg.checkpoint_dir,
                self.tick,
                self._state_tree(),
                extra={"tick": self.tick, "columns": list(self.pattern_names)},
            )
            self._fire("checkpoint_commit")
            if self.wal is not None:
                self.wal.prune_through(self.tick)
            prune(cfg.checkpoint_dir, keep=max(1, cfg.keep_checkpoints))
        return path

    @classmethod
    def recover(cls, *args, resilience: ResilienceConfig, **kw):
        """Rebuild a service after a crash: restore the latest committed
        checkpoint (if any), replay the WAL tail, resume.  Counts are
        bit-identical to the uninterrupted run (chaos tests assert it,
        eviction and out-of-order feeds included)."""
        svc = cls(*args, resilience=resilience, **kw)
        after = 0
        if resilience.checkpoint_dir:
            step = latest_step(resilience.checkpoint_dir)
            if step is not None:
                tree, _, extra = restore_checkpoint(
                    resilience.checkpoint_dir, svc._state_tree(), step
                )
                svc._load_state_tree(tree, extra)
                after = svc.tick
        if svc.wal is not None:
            for _, (src, dst, t, amount) in svc.wal.entries(after):
                svc.submit(src, dst, t, amount, _from_wal=True)
        return svc

    # -- observability --------------------------------------------------
    def health(self) -> dict:
        cfg = self.resilience
        return {
            "tick": self.tick,
            "level": self._level,
            "degraded": list(DEGRADATION_LADDER[: self._level]),
            "n_live": self.store.n_live,
            "rejected_total": self.totals["rejected"],
            "quarantined_total": self.totals["quarantined"],
            "dead_letter_ticks": self.totals["dead_letter_ticks"],
            "flight_ticks": len(self.flight),
            "wal_last_tick": None if self.wal is None else self.wal.last_tick(),
            "checkpoint_last_tick": (
                latest_step(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
            ),
        }
