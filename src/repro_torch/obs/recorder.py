"""Flight recorder: counters, sampled gauges, scheduler self-profile.

One :class:`FlightRecorder` attaches to one `Fabric`
(``recorder.attach(fabric)`` sets ``fabric.obs``); the fabric and
simulator then feed it through a handful of duck-typed hooks guarded by
a single ``if self.obs is not None:`` test, so the detached path costs
nothing and stays byte-identical.  Three surfaces:

- **counters** — monotonic event counts (submit verdicts, chunk
  lifecycle, steal probe outcomes) plus per-tenant service-ms, built so
  conservation holds by construction: every probe is exactly one hit or
  miss, every submit exactly one of admitted/degraded/rejected, every
  started chunk completes or is preempted;
- **sampler** — AutoCounter-style periodic gauge reads (occupancy,
  pending chunks, effective reserve, a counters copy) into a bounded
  ring-buffer history, on the caller's clock (sim time under the
  simulator, daemon wall time live);
- **prof** — per-`schedule()`-pass self-profiling of the incremental
  core: shells visited vs. elided, `_backlog_ms` memo hits/misses,
  steal-fail-cache skips, event-heap compactions.

All timestamps are injected by the caller; this module is declared a
schedlint sim module and never reads ambient time or randomness.
"""

from __future__ import annotations

import collections

from repro_torch.obs import trace as tr
from repro_torch.obs.trace import Tracer

SCHEDLINT_SIM = True

# counters a fresh recorder starts from; kept as a tuple literal so the
# conservation identities below are easy to audit:
#   submitted            == admitted + degraded + rejected
#   steal_probes         == steal_hits + steal_misses
#   chunks_started       == chunks_completed + chunks_preempted (at rest)
COUNTER_NAMES = (
    "submitted", "admitted", "degraded", "rejected",
    "jobs_dispatched",
    "chunks_started", "chunks_completed", "chunks_preempted",
    "steal_probes", "steal_hits", "steal_misses", "stolen_chunks",
    "ckpt_saves", "ckpt_migrations",
    "reconfigs", "reserve_resizes",
    # link-network transfers (zero on the uniform scalar shim):
    #   transfers_started    == transfers_completed (at rest)
    #   transfers_queued     <= transfers_started
    "transfers_started", "transfers_completed", "transfers_queued",
)

PROF_KEYS = (
    "passes", "shells_visited", "shells_elided",
    "backlog_hits", "backlog_misses",
    "steal_cache_hits", "heap_compactions",
)


class CounterSampler:
    """Periodic gauge reader with a bounded history.

    ``maybe_sample(now_ms, gauges)`` takes at most one row per
    ``interval_ms`` window; after a quiet stretch the next due time
    jumps past every missed window (integer arithmetic on the gap — no
    catch-up rows, no float drift), so sampling is deterministic in the
    caller's clock.
    """

    def __init__(self, interval_ms: float, history_max: int = 1024):
        if interval_ms <= 0:
            raise ValueError("interval_ms must be positive")
        if history_max <= 0:
            raise ValueError("history_max must be positive")
        self.interval_ms = float(interval_ms)
        self.history: collections.deque[dict] = collections.deque(
            maxlen=history_max)
        self._next_t: float | None = None

    def maybe_sample(self, now_ms: float, gauges_fn) -> bool:
        """``gauges_fn`` is called only when a sample is actually due,
        so the per-pass cost of a quiet sampler is one float compare."""
        if self._next_t is None:
            self._next_t = now_ms
        if now_ms < self._next_t:
            return False
        row = {"t_ms": now_ms}
        row.update(gauges_fn())
        self.history.append(row)
        missed = int((now_ms - self._next_t) // self.interval_ms)
        self._next_t += (missed + 1) * self.interval_ms
        return True


class FlightRecorder:
    """The observability head: tracer + counters + sampler + profiler.

    Construction chooses the surfaces: ``trace=False`` drops the event
    buffer (counters and profiling still run), ``sample_every_ms=None``
    (the default) disables periodic gauge sampling.  Attach with
    :meth:`attach`; read everything back with :meth:`snapshot`, which
    is what lands in ``SimResult.metrics`` / ``Daemon.metrics``.
    """

    def __init__(self, trace: bool = True, max_events: int = 1 << 18,
                 sample_every_ms: float | None = None,
                 history_max: int = 1024):
        self.tracer = Tracer(max_events) if trace else None
        self.sampler = (CounterSampler(sample_every_ms, history_max)
                        if sample_every_ms is not None else None)
        self.counts: dict[str, int] = {k: 0 for k in COUNTER_NAMES}
        self.tenant_service_ms: dict[str, float] = {}
        self.prof: dict[str, int] = {k: 0 for k in (
            "passes", "shells_visited", "shells_elided",
            "heap_compactions")}
        # hottest per-event tallies live as plain attributes, not dict
        # entries: the fabric bumps these inline (one attribute
        # increment, no method call, no hashing) on paths that fire
        # tens of thousands of times per second on saturated fabrics —
        # backlog-memo lookups and fingerprint-cache steal skips.  A
        # cache skip is a probe that missed ("nothing changed since the
        # last failed scan") and is counted as such at snapshot time,
        # but never traced: verbatim events here would dominate the
        # buffer on steal-heavy traces.  snapshot()/gauges() fold all
        # three back into the profile/counter dicts.
        self.backlog_hits = 0
        self.backlog_misses = 0
        self.steal_fp_skips = 0
        self.fabric = None

    # -- wiring --------------------------------------------------------

    def attach(self, fabric) -> "FlightRecorder":
        """Wire this recorder into ``fabric`` (one fabric per recorder).

        Sets ``fabric.obs`` and hooks every shell's ``on_reserve``
        callback so reserve resizes are recorded even when sampling is
        off.  Returns self for chaining.
        """
        if self.fabric is not None:
            raise ValueError("recorder is already attached to a fabric")
        if getattr(fabric, "obs", None) is not None:
            raise ValueError("fabric already has a recorder attached")
        self.fabric = fabric
        fabric.obs = self
        for name, st in fabric.states.items():
            st.on_reserve = (lambda nm: lambda t, r: self.on_reserve(
                nm, t, r))(name)
        return self

    # -- hooks (called by Fabric/simulate; obs is None when detached) --

    def on_submit(self, job, now: float) -> None:
        c = self.counts
        c["submitted"] += 1
        if job.rejected:
            c["rejected"] += 1
        elif job.degraded_from is not None:
            c["degraded"] += 1
        else:
            c["admitted"] += 1
        if self.tracer is not None:
            data = {"module": job.module, "n_chunks": job.n_chunks,
                    "priority": job.priority}
            if job.verdict is not None:
                data["verdict"] = job.verdict.action
            if job.degraded_from is not None:
                data["degraded_from"] = job.degraded_from
            self.tracer.emit(now, tr.SUBMIT, rid=job.gid,
                             tenant=job.tenant, data=data)

    def on_dispatch(self, job, shell: str, now: float) -> None:
        self.counts["jobs_dispatched"] += 1
        if self.tracer is not None:
            self.tracer.emit(now, tr.DISPATCH, shell=shell, rid=job.gid,
                             tenant=job.tenant,
                             data={"module": job.module})

    def on_pass(self, now: float, run, n_shells: int, out) -> None:
        """One completed ``Fabric.schedule`` pass.

        ``run`` is the visited (dirty) shell set, ``out`` the issued
        ``(shell, Assignment)`` list.
        """
        p = self.prof
        p["passes"] += 1
        p["shells_visited"] += len(run)
        p["shells_elided"] += n_shells - len(run)
        c = self.counts
        c["chunks_started"] += len(out)
        tracer = self.tracer
        for shell, a in out:
            if a.reconfigure:
                c["reconfigs"] += 1
            if tracer is None:
                continue
            data = {"module": a.module, "frac": a.frac}
            if a.restore_ms:
                data["restore_ms"] = a.restore_ms
            if a.save_ms:
                data["save_ms"] = a.save_ms
            if a.reconfigure:
                data["reconfigure"] = True
                tracer.emit(now, tr.RECONFIG, shell=shell,
                            data={"module": a.module})
            tracer.emit(now, tr.CHUNK_START, shell=shell, rid=a.rid,
                        chunk=a.chunk, aid=a.aid, data=data)
            if a.frac < 1.0 or a.restore_ms:
                tracer.emit(now, tr.CKPT_RESTORE, shell=shell, rid=a.rid,
                            chunk=a.chunk, aid=a.aid,
                            data={"frac": a.frac})
        if tracer is not None and out:
            # counts only (the visited set itself would be an O(dirty)
            # allocation per pass), and only for passes that issued
            # work — the every-pass visited/elided totals live in the
            # profile, so quiet passes need no event
            tracer.emit(now, tr.SCHED_PASS, data={
                "n_visited": len(run),
                "n_elided": n_shells - len(run), "issued": len(out)})
        if self.sampler is not None:
            self.sampler.maybe_sample(now, self.gauges)

    def on_complete(self, shell: str, a, tenant: str, now: float) -> None:
        self.counts["chunks_completed"] += 1
        # slot-ms: wall duration of the chunk times the slots it held —
        # the fairness currency THEMIS-style accounting needs
        self.tenant_service_ms[tenant] = self.tenant_service_ms.get(
            tenant, 0.0) + (now - a.t_start) * a.rng.size
        if self.tracer is not None:
            self.tracer.emit(now, tr.CHUNK_COMPLETE, shell=shell,
                             rid=a.rid, chunk=a.chunk, aid=a.aid,
                             tenant=tenant, data={"t_start": a.t_start})

    def on_preempted(self, pairs, now: float) -> None:
        """``pairs`` is Fabric.drain_preempted's ``(shell, Assignment)``
        list; checkpoint saves are attributed here because eviction is
        the instant the save cost is modeled."""
        c = self.counts
        fab = self.fabric
        for shell, a in pairs:
            c["chunks_preempted"] += 1
            saved = (fab is not None and fab.ckpt is not None
                     and fab.ckpt_capable.get(shell, False)
                     and not fab.states[shell].requests[a.rid].failed)
            if saved:
                c["ckpt_saves"] += 1
            if self.tracer is not None:
                self.tracer.emit(now, tr.PREEMPT, shell=shell, rid=a.rid,
                                 chunk=a.chunk, aid=a.aid,
                                 data={"t_start": a.t_start,
                                       "saved": saved})
                if saved:
                    self.tracer.emit(now, tr.CKPT_SAVE, shell=shell,
                                     rid=a.rid, chunk=a.chunk, aid=a.aid)

    def on_steal(self, victim: str, thief: str, now: float, hit: bool,
                 chunks: int = 0) -> None:
        c = self.counts
        c["steal_probes"] += 1
        if hit:
            c["steal_hits"] += 1
            c["stolen_chunks"] += chunks
        else:
            c["steal_misses"] += 1
        if self.tracer is not None:
            data = {"victim": victim, "thief": thief}
            if hit:
                data["chunks"] = chunks
            self.tracer.emit(now, tr.STEAL_HIT if hit else tr.STEAL_MISS,
                             shell=thief, data=data)

    def on_ckpt_migrate(self, victim: str, thief: str, rid: int,
                        now: float) -> None:
        self.counts["ckpt_migrations"] += 1
        if self.tracer is not None:
            self.tracer.emit(now, tr.CKPT_MIGRATE, shell=thief, rid=rid,
                             data={"victim": victim, "thief": thief})

    def on_transfer_start(self, victim: str, thief: str, chunks: int,
                          xfer, now: float) -> None:
        """A steal reserved link occupancy (`xfer` is the
        `core.network.Transfer` receipt); only fires on an active link
        network — the uniform shim realizes no transfers."""
        c = self.counts
        c["transfers_started"] += 1
        queued = xfer.wait_ms > 0.0
        if queued:
            c["transfers_queued"] += 1
        if self.tracer is not None:
            if queued:
                self.tracer.emit(now, tr.TRANSFER_QUEUED, shell=thief,
                                 data={"victim": victim, "thief": thief,
                                       "wait_ms": xfer.wait_ms})
            self.tracer.emit(now, tr.TRANSFER_START, shell=thief,
                             data={"victim": victim, "thief": thief,
                                   "chunks": chunks,
                                   "transfer_ms": xfer.total_ms})

    def on_transfer_complete(self, victim: str, thief: str,
                             now: float) -> None:
        self.counts["transfers_completed"] += 1
        if self.tracer is not None:
            self.tracer.emit(now, tr.TRANSFER_COMPLETE, shell=thief,
                             data={"victim": victim, "thief": thief})

    def on_reserve(self, shell: str, now: float, slots: int) -> None:
        self.counts["reserve_resizes"] += 1
        if self.tracer is not None:
            self.tracer.emit(now, tr.RESERVE, shell=shell,
                             data={"slots": slots})

    # -- gauges / snapshot --------------------------------------------

    def _counters(self) -> dict:
        """Counter copy with the fingerprint-cache skips folded in:
        each skip is one probe and one miss, so the conservation
        identity `probes == hits + misses` survives the fold."""
        c = dict(self.counts)
        c["steal_probes"] += self.steal_fp_skips
        c["steal_misses"] += self.steal_fp_skips
        return c

    def gauges(self) -> dict:
        """Instantaneous fabric-wide gauges plus a counters copy
        (firesim AutoCounter reads the counter file the same way: the
        sample is the running total, rates are first differences)."""
        busy = total = pend = reserve = 0
        fab = self.fabric
        if fab is not None:
            for st in fab.states.values():
                busy += len(st.alloc.busy)
                total += st.alloc.n
                pend += st.pending_chunks()
                reserve += st._reserve_last
        row = {"occupancy": busy / total if total else 0.0,
               "pending_chunks": pend,
               "effective_reserve": reserve,
               "counters": self._counters()}
        if fab is not None and fab.network.active:
            # link-utilisation gauges (count-based, no clock needed);
            # keys only exist on link-network runs, so the uniform
            # shim's sample rows are those of a run without a network
            row.update(fab.network.gauges())
        return row

    def snapshot(self) -> dict:
        """JSON-able metrics dict: the `SimResult.metrics` /
        `Daemon.metrics["obs"]` payload."""
        prof = dict(self.prof)
        prof["backlog_hits"] = self.backlog_hits
        prof["backlog_misses"] = self.backlog_misses
        prof["steal_cache_hits"] = self.steal_fp_skips
        seen = prof["shells_visited"] + prof["shells_elided"]
        prof["elision_rate"] = (prof["shells_elided"] / seen
                                if seen else 0.0)
        lookups = prof["backlog_hits"] + prof["backlog_misses"]
        prof["backlog_hit_rate"] = (prof["backlog_hits"] / lookups
                                    if lookups else 0.0)
        counters = self._counters()
        probes = counters["steal_probes"]
        prof["steal_cache_hit_rate"] = (prof["steal_cache_hits"] / probes
                                        if probes else 0.0)
        out = {"counters": counters,
               "tenant_service_ms": dict(self.tenant_service_ms),
               "profile": prof}
        if self.sampler is not None:
            out["samples"] = [dict(row) for row in self.sampler.history]
        if self.tracer is not None:
            out["trace"] = {"events": len(self.tracer.events),
                            "dropped": self.tracer.dropped}
        fab = self.fabric
        if fab is not None:
            if fab.ckpt is not None:
                out["ckpt"] = dict(fab.ckpt.stats)
            if fab.slo is not None:
                out["admission"] = fab.slo.totals()
            if fab.network.active:
                # per-link lifetime stats (transfers, busy_ms,
                # max_queue), keyed "src->dst"; absent on the uniform
                # shim so pre-network snapshots are unchanged
                out["network"] = fab.network.stats()
        return out
