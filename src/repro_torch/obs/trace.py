"""Structured event tracing for the scheduling fabric.

A :class:`Tracer` is a bounded ring buffer of typed
:class:`TraceEvent` records.  Timestamps are *injected* — sim modules
pass sim-time milliseconds, the daemon passes its own wall-clock
milliseconds — so this module never reads ambient time and stays clean
under schedlint's determinism pass (it is declared a sim module below).

Event kinds form a small closed taxonomy (module constants); the
Chrome-trace exporter in :mod:`repro_torch.obs.export` pairs the
``CHUNK_START``/``CHUNK_COMPLETE``/``PREEMPT`` kinds into duration
lanes and renders everything else as instants.
"""

from __future__ import annotations

import collections
import dataclasses

SCHEDLINT_SIM = True

# -- event taxonomy ----------------------------------------------------
# submit/admission verdict (tenant + verdict/degraded_from in data)
SUBMIT = "submit"
# job placed onto a shell by Fabric._dispatch
DISPATCH = "dispatch"
# assignment handed to an executor (data: frac/restore_ms/reconfigure)
CHUNK_START = "chunk_start"
# assignment finished (data: t_start for span pairing)
CHUNK_COMPLETE = "chunk_complete"
# assignment evicted before completion (data: t_start, saved)
PREEMPT = "preempt"
# steal probe outcomes; a probe is emitted as exactly one hit or miss
# (data: victim/thief, chunks on hit, cached=True for fingerprint skips)
STEAL_HIT = "steal_hit"
STEAL_MISS = "steal_miss"
# checkpoint lifecycle
CKPT_SAVE = "ckpt_save"
CKPT_RESTORE = "ckpt_restore"
CKPT_MIGRATE = "ckpt_migrate"
# shell reconfigured to host a new module (emitted beside chunk_start)
RECONFIG = "reconfig"
# effective reserve changed on a shell (data: slots)
RESERVE = "reserve"
# one Fabric.schedule pass (data: visited shells, n_visited, n_elided)
SCHED_PASS = "sched_pass"
# realized cross-shell transfer reserved link occupancy (data: victim/
# thief, chunks, transfer_ms; only on an active link network)
TRANSFER_START = "transfer_start"
# the transfer queued behind earlier traffic before its first link
# accepted it (data adds wait_ms; emitted beside its transfer_start)
TRANSFER_QUEUED = "transfer_queued"
# the transfer's link occupancy released (sim: "net" heap event;
# daemon: wall-clock advance)
TRANSFER_COMPLETE = "transfer_complete"

KINDS = (
    SUBMIT, DISPATCH, CHUNK_START, CHUNK_COMPLETE, PREEMPT,
    STEAL_HIT, STEAL_MISS, CKPT_SAVE, CKPT_RESTORE, CKPT_MIGRATE,
    RECONFIG, RESERVE, SCHED_PASS,
    TRANSFER_START, TRANSFER_QUEUED, TRANSFER_COMPLETE,
)


@dataclasses.dataclass(slots=True)
class TraceEvent:
    """One typed trace record.

    ``t_ms`` is whatever clock the emitting layer runs on (sim time for
    the simulator, daemon wall clock for live serving); ``data`` is a
    small kind-specific dict or None.
    """

    t_ms: float
    kind: str
    shell: str | None = None
    rid: int | None = None
    chunk: int | None = None
    aid: int | None = None
    tenant: str | None = None
    data: dict | None = None


class Tracer:
    """Bounded ring buffer of :class:`TraceEvent`.

    ``events`` is a ``deque(maxlen=max_events)``: once full, the oldest
    record is evicted and ``dropped`` is incremented, so long live runs
    degrade by forgetting history rather than by growing without bound.
    """

    def __init__(self, max_events: int = 1 << 18):
        if max_events <= 0:
            raise ValueError("max_events must be positive")
        self.events: collections.deque[TraceEvent] = collections.deque(
            maxlen=max_events)
        self.dropped = 0

    def __len__(self) -> int:
        return len(self.events)

    def emit(self, t_ms: float, kind: str, shell: str | None = None,
             rid: int | None = None, chunk: int | None = None,
             aid: int | None = None, tenant: str | None = None,
             data: dict | None = None) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(TraceEvent(
            t_ms, kind, shell=shell, rid=rid, chunk=chunk, aid=aid,
            tenant=tenant, data=data))
