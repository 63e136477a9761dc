"""Discrete-event simulator for the resource-elastic scheduler.

Drives the scheduling policy through the `Fabric` contract with a virtual
clock and the registry's cost model; used by property tests and by the
Fig.-15 benchmark (elastic vs fixed-module scheduling) as well as the
THEMIS-style preemption benchmark (benchmarks/preemption.py) and the
multi-shell stealing benchmark (benchmarks/multi_shell.py).

`simulate` accepts either a bare slot count (the seed single-shell form —
internally a degenerate one-shell fabric, with identical ids, event order
and metrics), a `{shell_name: n_slots}` mapping, or a pre-built `Fabric`
(pass the fabric when the caller wants to inspect its shared cost model or
steal counters afterwards; a fabric is single-use — one per run).  Multi-shell runs lay shells out side by side
on a global slot axis (each shell gets a contiguous offset range), so the
seed timeline format `(t_start, t_end, (slot, size), rid)` is unchanged
and per-shell views are recovered from `SimResult.per_shell`.

Preemption semantics: when the policy evicts an in-flight chunk, the
victim's occupancy is truncated at the eviction instant (it still counts
as slot occupancy, not as goodput), the chunk is requeued, and its
original completion event becomes a stale no-op.  Every submitted chunk
therefore still completes exactly once, even when idle shells steal
pending chunks across the fabric.  Without checkpointing the truncated
partial work is discarded (`SimResult.discarded_ms`); with
`PolicyConfig.ckpt` the compute beyond the run's own overheads is
preserved (`SimResult.reclaimed_ms`), the victims' context-save cost is
realized at the preemptor's start, and the resumed chunk runs only its
remaining fraction plus the restore cost (core/checkpoint.py).

Cost model: the *actual* simulated chunk time comes from the registry
(`ImplAlt.meta["true_chunk_ms"]` when present, else `est_chunk_ms`),
divided by the hosting shell's `speed` (heterogeneous fabrics), so a
mis-estimated module can be modeled; with `PolicyConfig.refine_cost_model`
the fabric's shared `CostModel` EWMA-converges its estimates (used by
placement decisions) onto the observed true times — reconfigured chunks
included, at elapsed minus the modeled penalty.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Iterable

from repro_torch.core.fabric import Fabric
from repro_torch.core.registry import Registry
from repro_torch.core.scheduler import Assignment, PolicyConfig

# stale "done" events are lazily skipped on pop; once more than this
# many are pending AND they outnumber live events 2:1, the heap is
# compacted in one pass.  Module-level so tests can force compaction on
# small traces (the rebuild must be event-order-identical)
COMPACT_MIN_STALE = 64


def p95(latencies: list[float]) -> float:
    """p95 over a list of latencies (nearest-rank); 0.0 when empty."""
    if not latencies:
        return 0.0
    lat = sorted(latencies)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]


@dataclasses.dataclass(frozen=True)
class SimJob:
    t_arrive: float
    tenant: str
    module: str
    n_chunks: int
    priority: int = 0
    deadline_ms: float | None = None
    affinity: str | None = None         # pin dispatch to a fabric shell


@dataclasses.dataclass
class SimResult:
    makespan: float
    utilization: float                  # busy slot-time / (makespan * slots)
    reconfigurations: int
    request_latency: dict[int, float]   # rid -> finish - submit
    timeline: list                      # (t_start, t_end, slot_range, rid)
    preemptions: int = 0
    # truncated spans of evicted chunks: (t_start, t_evict, slot_range, rid)
    preempted_spans: list = dataclasses.field(default_factory=list)
    # slot-time of evicted runs (occupancy that produced no completed
    # chunk); splits into discarded_ms + reclaimed_ms below
    wasted_time: float = 0.0
    # rid -> {"tenant", "priority", "deadline_ms", "n_chunks"}
    request_meta: dict[int, dict] = dataclasses.field(default_factory=dict)
    n_slots: int = 1
    # shell name -> {"offset", "n_slots", "busy_ms", "utilization"}
    per_shell: dict[str, dict] = dataclasses.field(default_factory=dict)
    stolen_chunks: int = 0              # chunks moved by work stealing
    # evicted slot-time lost for good vs preserved by checkpoints
    # (invariant: discarded_ms + reclaimed_ms == wasted_time); with
    # checkpointing off every evicted span is discarded
    discarded_ms: float = 0.0
    reclaimed_ms: float = 0.0
    ckpt_saves: int = 0                 # context-save operations
    ckpt_restores: int = 0              # chunks resumed from a checkpoint
    ckpt_migrations: int = 0            # checkpoints moved across shells
    # shell name -> [(t_ms, effective reserve), ...] recorded on change
    # (adaptive reservation's sizing trace; static mode records its
    # constant once, a zero reservation records nothing)
    reserve_history: dict[str, list] = dataclasses.field(
        default_factory=dict)
    # per-tenant SLO attainment snapshot (core/slo.py): verdict counts,
    # deadline-hit fraction, bounded attainment history.  Empty — and
    # absent from golden serialisations — without registered contracts
    slo: dict = dataclasses.field(default_factory=dict)
    # observability snapshot (repro_torch.obs.FlightRecorder.snapshot):
    # counters, per-tenant service-ms, sampled gauge history, scheduler
    # self-profile.  Empty — and absent from golden serialisations —
    # unless a recorder is attached to the fabric
    metrics: dict = dataclasses.field(default_factory=dict)

    @property
    def mean_latency(self) -> float:
        lat = list(self.request_latency.values())
        return sum(lat) / len(lat) if lat else 0.0

    def latencies(self, priority: int | None = None) -> list[float]:
        return sorted(
            l for rid, l in self.request_latency.items()
            if priority is None
            or self.request_meta[rid]["priority"] == priority)

    def p95_latency(self, priority: int | None = None) -> float:
        return p95(self.latencies(priority))

    def deadline_misses(self) -> int:
        n = 0
        for rid, lat in self.request_latency.items():
            dl = self.request_meta[rid]["deadline_ms"]
            if dl is not None and lat > dl + 1e-9:
                n += 1
        return n

    @property
    def deadline_miss_rate(self) -> float:
        with_dl = sum(1 for m in self.request_meta.values()
                      if m["deadline_ms"] is not None)
        return self.deadline_misses() / with_dl if with_dl else 0.0

    @property
    def useful_utilization(self) -> float:
        """Utilization counting only work that was not later discarded
        (checkpoint-reclaimed partial work still counts as useful)."""
        if self.makespan <= 0 or self.utilization <= 0:
            return 0.0
        return self.utilization - self.discarded_ms / (
            self.makespan * max(1, self.n_slots))


def _true_chunk_ms(registry: Registry, module: str, footprint: int,
                   speed: float) -> float:
    """Full-chunk true compute time on a shell (no penalties)."""
    impl = registry.module(module).impl_for(footprint)
    return impl.meta.get("true_chunk_ms", impl.est_chunk_ms) / speed


def chunk_time_ms(registry: Registry, a: Assignment,
                  policy: PolicyConfig, speed: float = 1.0) -> float:
    """True simulated service time of an assignment (the cost-model
    estimate may diverge; see `ImplAlt.meta["true_chunk_ms"]`).

    `speed` is the hosting shell's relative clock: compute scales by
    1/speed; the reconfiguration penalty does not (the configuration
    port is modeled as generation-independent).  A chunk resumed from a
    checkpoint (`a.frac < 1`) runs only its remaining fraction and pays
    its context-restore cost up front; `a.save_ms` realizes the evicted
    victims' context save at the preemptor's start."""
    t = _true_chunk_ms(registry, a.module, a.footprint, speed)
    if a.frac != 1.0:
        t *= a.frac
    if a.reconfigure:
        t += policy.reconfig_penalty_ms
    return t + a.restore_ms + a.save_ms


def _as_fabric(registry: Registry, spec, policy: PolicyConfig) -> Fabric:
    if isinstance(spec, Fabric):
        return spec
    if isinstance(spec, int):
        return Fabric({"shell0": spec}, registry, policy)
    return Fabric(dict(spec), registry, policy)


def simulate(registry: Registry, fabric_or_n_slots, jobs: Iterable[SimJob],
             policy: PolicyConfig | None = None) -> SimResult:
    """Replay `jobs` through the fabric's scheduling contract.

    `fabric_or_n_slots`: an int (one anonymous shell — the seed form), a
    `{name: n_slots}` mapping, or a `Fabric`.  When a Fabric is passed,
    its own `PolicyConfig` governs; passing a *different* policy too is
    rejected rather than silently ignored.
    """
    if isinstance(fabric_or_n_slots, Fabric):
        if policy is not None and policy is not fabric_or_n_slots.policy:
            raise ValueError(
                "simulate() got both a Fabric and a different "
                "PolicyConfig; the fabric's own policy governs — drop "
                "the policy argument or build the fabric with it")
        if fabric_or_n_slots.jobs:
            raise ValueError(
                "simulate() needs a fresh Fabric: this one already "
                "carries jobs from a previous run, which would pollute "
                "latency/steal metrics — build a new Fabric per run")
    policy = policy or PolicyConfig()
    fabric = _as_fabric(registry, fabric_or_n_slots, policy)
    policy = fabric.policy
    offsets, off = {}, 0
    for name, st in fabric.states.items():
        offsets[name] = off
        off += st.alloc.n
    total_slots = off

    events: list[tuple[float, int, str, object]] = []
    seq = 0
    for j in jobs:
        heapq.heappush(events, (j.t_arrive, seq, "arrive", j))
        seq += 1

    now = 0.0
    busy_time = 0.0
    wasted_time = 0.0
    discarded_ms = 0.0
    reclaimed_ms = 0.0
    reconfs = 0
    timeline = []
    preempted_spans = []
    starts: dict[int, float] = {}       # aid -> dispatch time
    meta: dict[int, dict] = {}
    busy_by_shell: dict[str, float] = {n: 0.0 for n in fabric.states}
    # transfer is paid once per stolen chunk — a preempted rerun of the
    # same chunk does not move the payload again
    paid_chunks: set[tuple[str, int, int]] = set()
    charged: dict[int, float] = {}      # aid -> transfer charged
    # aids evicted before their "done" event fired: the event stays in
    # the heap (lazy deletion) and is skipped on pop; when stale events
    # come to dominate the heap it is compacted in one pass — a high
    # preemption rate must not grow the heap without bound
    stale: set[int] = set()

    def dispatch(t0: float):
        nonlocal seq, busy_time, wasted_time, reconfs
        nonlocal discarded_ms, reclaimed_ms
        new = fabric.schedule(now=t0)
        if fabric.network.active:
            # a steal this pass reserved link occupancy: realize the
            # release as a timed "net" event, so queued thieves
            # re-evaluate (network.version re-dirties every shell) the
            # moment the route frees up — not one event later
            for xfer in fabric.network.drain_releases():
                heapq.heappush(events, (xfer.t_done, seq, "net", None))
                seq += 1
        for ck in fabric.drain_moved():
            # a steal retires the chunk's (shell, rid, chunk) identity:
            # release its transfer-charge record so a transfer-paid
            # chunk that is preempted and then re-stolen leaves no
            # residue (the re-steal is a fresh payload movement and is
            # priced under its new identity)
            paid_chunks.discard(ck)
        for shell, v in fabric.drain_preempted():
            stale.add(v.aid)
            tr = charged.pop(v.aid, 0.0)
            ts = starts.pop(v.aid)
            span = (t0 - ts) * v.rng.size
            busy_time += span
            busy_by_shell[shell] += span
            wasted_time += span
            reclaimed = 0.0
            if fabric.ckpt is not None and fabric.ckpt_capable[shell] \
                    and not fabric.states[shell].requests[v.rid].failed:
                # the run's compute beyond its overheads (restore, save,
                # reconfiguration, transfer) survives in the checkpoint,
                # capped at the work the run still had to do; overheads
                # themselves are gone for good
                over = v.restore_ms + v.save_ms + tr
                if v.reconfigure:
                    over += policy.reconfig_penalty_ms
                remaining = v.frac * _true_chunk_ms(
                    registry, v.module, v.footprint,
                    fabric.speeds[shell])
                reclaimed = min(max(0.0, (t0 - ts) - over),
                                remaining) * v.rng.size
            reclaimed_ms += reclaimed
            discarded_ms += span - reclaimed
            job, _ = fabric.resolve(shell, v)
            preempted_spans.append(
                (ts, t0, (offsets[shell] + v.rng.start, v.rng.size),
                 job.gid))
        if len(stale) > COMPACT_MIN_STALE \
                and 2 * len(stale) > len(events):
            # compact: drop the stale "done" entries and re-heapify.
            # (t, seq) is a unique total order, so rebuild pops the
            # surviving events in exactly the original order
            events[:] = [e for e in events
                         if e[2] != "done" or e[3][1].aid not in stale]
            heapq.heapify(events)
            stale.clear()
            if fabric.obs is not None:
                fabric.obs.prof["heap_compactions"] += 1
        for shell, a in new:
            # stolen chunks also pay the priced cross-shell payload
            # movement — the latency the steal gate reasons about is
            # realized in the simulated world, not just planned for
            tr = fabric.transfer_cost(shell, a.rid)
            if tr > 0.0:
                ck = (shell, a.rid, a.chunk)
                if ck in paid_chunks:
                    tr = 0.0            # rerun: payload already moved
                else:
                    paid_chunks.add(ck)
                    charged[a.aid] = tr
            dt = chunk_time_ms(registry, a, policy,
                               fabric.speeds[shell]) + tr
            if a.reconfigure:
                reconfs += 1
            starts[a.aid] = t0
            heapq.heappush(events, (t0 + dt, seq, "done", (shell, a)))
            seq += 1

    def admit(j: SimJob, t: float) -> None:
        job = fabric.submit(j.tenant, j.module, j.n_chunks,
                            now=t, priority=j.priority,
                            deadline_ms=j.deadline_ms,
                            affinity=j.affinity)
        m = {"tenant": j.tenant,
             "priority": j.priority,
             "deadline_ms": j.deadline_ms,
             "n_chunks": j.n_chunks,
             "t_submit": t}
        if job.verdict is not None:
            # admission-screened: record the structured verdict (keys
            # only exist on contract runs — the no-contract meta dict
            # is unchanged, byte for byte)
            m["verdict"] = job.verdict.action
            if job.degraded_from is not None:
                m["degraded_from"] = job.degraded_from
            if job.verdict.reason:
                m["verdict_reason"] = job.verdict.reason
        meta[job.gid] = m

    while events:
        now, _, kind, obj = heapq.heappop(events)
        if kind == "arrive":
            admit(obj, now)
            # coalesce a same-timestamp arrival storm into one
            # scheduling pass: every job offered at this instant is
            # admitted before placement runs.  Interleaving dispatch
            # between same-t submits (the earlier core's behavior) let the
            # first job claim slots and bias steals before its
            # simultaneous peers even existed — an ordering bug, since
            # no event separates the arrivals.  Arrivals at equal t
            # always pop before "done" events (their seq numbers are
            # assigned first), so completions are unaffected.
            while events and events[0][0] == now \
                    and events[0][2] == "arrive":
                admit(heapq.heappop(events)[3], now)
        elif kind == "net":
            # link-release instant: free the expired occupancy, then
            # fall through to dispatch — backed-off steals re-run now
            for xfer in fabric.network.advance(now):
                if fabric.obs is not None:
                    fabric.obs.on_transfer_complete(xfer.src, xfer.dst,
                                                    now)
        else:
            shell, a = obj
            if a.aid in stale:
                stale.discard(a.aid)
                continue                 # evicted: the executor-side skip
            if not fabric.complete(shell, a, now=now):
                continue                 # stale event for a preempted chunk
            paid_chunks.discard((shell, a.rid, a.chunk))
            ts = starts.pop(a.aid)
            busy_time += (now - ts) * a.rng.size
            busy_by_shell[shell] += (now - ts) * a.rng.size
            job, _ = fabric.resolve(shell, a)
            timeline.append((ts, now,
                             (offsets[shell] + a.rng.start, a.rng.size),
                             job.gid))
            if policy.refine_cost_model:
                # reconfigured chunks are observed too, minus the
                # modeled penalty — a module that always reconfigures
                # must still refine its estimate; likewise the transfer
                # actually charged to this attempt, and the checkpoint
                # restore/save overheads, are not the module's own time.
                # A resumed chunk ran only its remaining fraction, so
                # its elapsed time is scaled back to a full chunk (a
                # zero-length resume observes nothing).
                extra = charged.get(a.aid, 0.0) + a.restore_ms \
                    + a.save_ms
                if a.reconfigure:
                    extra += policy.reconfig_penalty_ms
                elapsed = now - ts
                if extra > 0.0:
                    elapsed = max(1e-3, elapsed - extra)
                if a.frac >= 1e-9:
                    if a.frac != 1.0:
                        elapsed = elapsed / a.frac
                    fabric.cost.observe(a.module, a.footprint, elapsed,
                                        fabric.speeds[shell])
            charged.pop(a.aid, None)
        dispatch(now)

    assert all(j.complete or j.rejected
               for j in fabric.jobs.values()), \
        "simulator finished with incomplete requests"
    for st in fabric.states.values():
        assert not st.alloc.busy, "simulator finished with busy slots"
        assert not st.active, "simulator finished with in-flight chunks"
    assert fabric.ckpt is None or len(fabric.ckpt) == 0, \
        "simulator finished with unconsumed checkpoint records"
    # bookkeeping must drain exactly: every dispatched aid was either
    # completed or preempted (starts/charged), every stale "done" event
    # was skipped or compacted away, and every transfer charge was
    # released by completion or by the retirement of its chunk identity
    # at a re-steal (drain_moved) — the charge map is exact
    assert not starts and not charged and not stale \
        and not paid_chunks, \
        "simulator finished with leaked bookkeeping entries"
    assert fabric.network.inflight == 0, \
        "simulator finished with unreleased link occupancy"
    lat = {j.gid: j.t_finish - j.t_submit
           for j in fabric.jobs.values() if not j.rejected}
    util = busy_time / (now * total_slots) if now > 0 else 0.0
    n_pre = sum(st.n_preemptions for st in fabric.states.values())
    per_shell = {
        name: {"offset": offsets[name], "n_slots": st.alloc.n,
               "busy_ms": busy_by_shell[name],
               "utilization": (busy_by_shell[name] / (now * st.alloc.n)
                               if now > 0 else 0.0)}
        for name, st in fabric.states.items()}
    cstats = fabric.ckpt.stats if fabric.ckpt is not None else {}
    return SimResult(now, util, reconfs, lat, timeline,
                     preemptions=n_pre,
                     preempted_spans=preempted_spans,
                     wasted_time=wasted_time, request_meta=meta,
                     n_slots=total_slots, per_shell=per_shell,
                     stolen_chunks=fabric.stats["stolen_chunks"],
                     discarded_ms=discarded_ms,
                     reclaimed_ms=reclaimed_ms,
                     ckpt_saves=cstats.get("saves", 0),
                     ckpt_restores=cstats.get("restores", 0),
                     ckpt_migrations=cstats.get("migrations", 0),
                     reserve_history={
                         name: list(st.reserve_history)
                         for name, st in fabric.states.items()},
                     slo=(fabric.slo.attainment()
                          if fabric.slo is not None else {}),
                     metrics=(fabric.obs.snapshot()
                              if fabric.obs is not None else {}))
