"""Checkpoint/restore for preempted chunks (context-save analogue).

The preemption model of the scheduler core is lossy by default: an
evicted chunk is requeued at zero progress and re-runs from scratch, so
under an aggressive interactive stream a large fraction of slot-time is
discarded as evicted partial work (~26% at 10 ms inter-arrival in the
THEMIS-style benchmark).  Rodriguez-Canal et al. (2022) show FPGA
context-save/restore makes preemption near-free at task granularity;
THEMIS (Karabulut et al., 2024) motivates pricing the save/restore cost
inside the fairness loop instead of assuming it away.  This module is
that cost model:

  - a `ChunkCheckpoint` records an evicted chunk's *progress fraction*
    (plus module, footprint, shell of origin) at the instant the
    scheduler evicts it;
  - a `CheckpointManager` owns the records — one per (rid, chunk),
    consumed when the chunk is re-issued — and prices the modeled
    context-save and context-restore costs: `PolicyConfig.ckpt_save_ms`
    / `ckpt_restore_ms` by default, overridden per implementation
    alternative by `ImplAlt.meta["ckpt_save_ms"]` /
    `meta["ckpt_restore_ms"]`, and speed-scaled like chunk times
    (context movement runs through the shell's own fabric, unlike the
    generation-independent configuration port).

Progress is estimated from the scheduler's cost model: the fraction of
the chunk's estimated service time that elapsed after the run's own
overheads (restore, save, reconfiguration).  It is a *model* — the
simulator realizes it exactly when `est_chunk_ms` matches the true
chunk time, and the live daemon uses it as a wall-clock estimate (an
in-process computation cannot restore partial context, so the
daemon re-runs resumed chunks in full while keeping the same scheduling
contract and accounting).

One manager is shared by every `SchedulerState` in a `Fabric` (like the
`CostModel`), keyed by (rid, chunk) — rids are fabric-unique — so a
checkpointed chunk can *migrate*: when work stealing moves it to
another shell, the fabric re-keys its record (`rekey`) and the thief
resumes it there, paying restore + transfer instead of re-running from
zero.  A shell without context-readback support (`ShellSpec.ckpt =
False`) never saves, and a record migrated onto it is dropped.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ChunkCheckpoint:
    """Saved context of one preempted chunk: how far it got, where."""
    rid: int
    chunk: int
    module: str
    footprint: int                 # footprint at save time (informational:
    #                                progress is implementation-portable —
    #                                work-items done, not bitstream state)
    progress: float                # fraction of the chunk's compute done
    shell: str | None = None       # shell of origin (None: bare state)
    t_saved: float = 0.0

    @property
    def remaining(self) -> float:
        return max(0.0, 1.0 - self.progress)


# schedlint (analysis/mutation.py): checkpoint records carry no version
# of their own — they piggyback on the owning shell's `_version`.  That
# is sound only if every call to one of these mutators sits on an
# execution path that also bumps a shell version; the mutation checker
# enforces exactly that, which is what lets memo keys treat
# `_recs`/`_rid_progress` reads as covered by the "state" token.
CKPT_MUTATORS = ("save", "take", "rekey", "drop_request")


class CheckpointManager:
    """Owns `ChunkCheckpoint` records and prices save/restore.

    The scheduler calls `save` when it evicts an assignment (recording
    progress, returning the priced save cost) and `take` when it
    re-issues the chunk (consuming the record; the resumed assignment
    runs only the remaining fraction plus the restore cost).  A fabric
    calls `rekey` when stealing moves a checkpointed chunk across
    shells, and `drop_request` when a request is aborted.
    """

    def __init__(self, registry, policy):
        self.registry = registry
        self.policy = policy
        self._recs: dict[tuple[int, int], ChunkCheckpoint] = {}
        # per-rid summed progress of recorded chunks, kept in sync with
        # _recs so the hot backlog estimator reads it in O(1)
        self._rid_progress: dict[int, float] = {}
        self.stats = {"saves": 0, "restores": 0, "migrations": 0,
                      "dropped": 0}

    def __len__(self) -> int:
        return len(self._recs)

    # -- cost model -----------------------------------------------------------

    def _cost_ms(self, module: str, footprint: int, key: str,
                 default: float, speed: float) -> float:
        impl = self.registry.module(module).impl_for(footprint)
        v = default if impl is None else impl.meta.get(key, default)
        return float(v) / speed

    def save_cost_ms(self, module: str, footprint: int,
                     speed: float = 1.0) -> float:
        return self._cost_ms(module, footprint, "ckpt_save_ms",
                             self.policy.ckpt_save_ms, speed)

    def restore_cost_ms(self, module: str, footprint: int,
                        speed: float = 1.0) -> float:
        return self._cost_ms(module, footprint, "ckpt_restore_ms",
                             self.policy.ckpt_restore_ms, speed)

    # -- record lifecycle -----------------------------------------------------

    def save(self, a, now: float, est_full_ms: float,
             speed: float = 1.0, shell: str | None = None,
             extra_overhead_ms: float = 0.0) -> float:
        """Record an evicted assignment's progress; return the priced
        context-save cost the eviction must realize.

        Progress this run = time elapsed since placement minus the
        run's own overheads (restore, save, reconfiguration, plus any
        `extra_overhead_ms` the caller knows about — a fabric passes
        the stolen chunk's transfer cost), as a fraction of the
        full-chunk estimate, on top of whatever prior progress the
        assignment resumed from (`1 - a.frac`).  When the run made no
        new progress (evicted mid-overhead) the prior context is still
        on record but nothing new needs saving, so the returned cost is
        0.0; when there is no progress at all, no record is created.
        """
        prior = max(0.0, 1.0 - a.frac)
        overhead = a.restore_ms + a.save_ms + extra_overhead_ms
        if a.reconfigure:
            overhead += self.policy.reconfig_penalty_ms
        run_ms = max(0.0, (now - a.t_start) - overhead)
        delta = min(a.frac, run_ms / max(est_full_ms, 1e-9))
        progress = min(1.0, prior + delta)
        if progress <= 0.0:
            return 0.0
        self._recs[(a.rid, a.chunk)] = ChunkCheckpoint(
            a.rid, a.chunk, a.module, a.footprint, progress,
            shell=shell, t_saved=now)
        self._rid_progress[a.rid] = \
            self._rid_progress.get(a.rid, 0.0) + progress
        if delta <= 0.0:
            return 0.0                 # prior context already saved
        self.stats["saves"] += 1
        return self.save_cost_ms(a.module, a.footprint, speed)

    def take(self, rid: int, chunk: int) -> ChunkCheckpoint | None:
        """Consume the record at re-issue (the chunk is being resumed)."""
        rec = self._recs.pop((rid, chunk), None)
        if rec is not None:
            self._drop_progress(rid, rec.progress)
            self.stats["restores"] += 1
        return rec

    def _drop_progress(self, rid: int, progress: float) -> None:
        v = self._rid_progress.get(rid, 0.0) - progress
        if v <= 1e-12:
            self._rid_progress.pop(rid, None)
        else:
            self._rid_progress[rid] = v

    def peek(self, rid: int, chunk: int) -> ChunkCheckpoint | None:
        return self._recs.get((rid, chunk))

    def rekey(self, old: tuple[int, int], new: tuple[int, int],
              shell: str | None = None, capable: bool = True) -> bool:
        """Move a record to a stolen chunk's new (rid, chunk) identity.
        A thief shell without context-restore support drops the record
        instead (the chunk re-runs from zero there).  Returns True when
        a record migrated."""
        rec = self._recs.pop(old, None)
        if rec is None:
            return False
        self._drop_progress(old[0], rec.progress)
        if not capable:
            self.stats["dropped"] += 1
            return False
        rec.rid, rec.chunk = new
        rec.shell = shell
        self._recs[new] = rec
        self._rid_progress[new[0]] = \
            self._rid_progress.get(new[0], 0.0) + rec.progress
        self.stats["migrations"] += 1
        return True

    def drop_request(self, rid: int) -> None:
        """Release every record of an aborted request."""
        for key in [k for k in self._recs if k[0] == rid]:
            del self._recs[key]
        self._rid_progress.pop(rid, None)

    def pending_progress(self, rid: int) -> float:
        """Summed progress fractions of a request's checkpointed pending
        chunks — the backlog estimator subtracts this so a shell with
        mostly-done victims looks as short as it really is.  O(1): kept
        in sync with the record map."""
        return self._rid_progress.get(rid, 0.0)
