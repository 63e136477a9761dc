"""Resource-elastic space-time scheduler (paper section 4.4).

Pure policy core, shared by the discrete-event simulator (tests, Fig-15
benchmark) and the live daemon executor:

  - weighted priority scheduling between tenants at acceleration-request
    granularity (equal priorities degrade to least-recently-served
    round robin, the paper's Fig-14 policy);
  - each request carries independent data-parallel *chunks* (work-groups);
  - module REPLICATION: chunks of one request run on many slots;
  - module REPLACEMENT: when adjacent slots are free, a bigger
    implementation alternative is placed on the merged range;
  - REUSE: a range still hosting the right module skips reconfiguration;
  - PREEMPTION (THEMIS-style): a high-priority arrival may evict the
    lowest-priority resident chunk mid-flight; the victim chunk is
    requeued and the preemptor pays the modeled reconfiguration penalty.
  - CHECKPOINTING (PolicyConfig.ckpt, core/checkpoint.py): an evicted
    chunk's progress is snapshotted (priced context save, realized by
    the preemptor) instead of discarded, and the chunk later resumes
    with only its remaining fraction plus the priced restore cost.
  - RESERVATION (PolicyConfig.reserve_slots): the last N slots are held
    back from non-interactive requests so a predicted interactive burst
    finds capacity without evicting anyone.  With
    PolicyConfig.reserve_mode == "adaptive" the count is no longer a
    static knob: an ArrivalEstimator (core/arrivals.py) tracks the
    observed interactive arrival rate and every scheduling pass sizes
    the effective reservation from predicted demand over the next
    reconfiguration+chunk horizon, clamped to [0, reserve_slots_max].
    A request whose *aged* effective priority reaches reserve_priority
    may use reserved slots once its tenant has gone a full starvation
    bound with no service at all (the reservation defers batch work,
    it must not starve it — but a backlogged-and-served tenant never
    pierces the burst headroom), and a reservation a module cannot fit
    under is shrunk to the largest feasible value, never silently
    dropped.

Priority model: each request carries an integer `priority` (higher wins)
and an optional relative `deadline_ms`.  The effective priority ages by
one level per `starvation_bound_ms` of queueing delay, so low-priority
tenants can be delayed at most `(gap + 1) * starvation_bound_ms` behind a
saturating higher-priority stream.  Ties break earliest-deadline-first,
then least-recently-served round robin.  The scheduler clock is in
milliseconds (the simulator's virtual clock; the daemon feeds
`time.perf_counter() * 1e3`).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Optional

from repro_torch.analysis import sanitizer
from repro_torch.core.allocator import BuddyAllocator, Range
from repro_torch.core.arrivals import ArrivalEstimator
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.registry import ModuleDescriptor


@dataclasses.dataclass
class Request:
    rid: int
    tenant: str
    module: str
    n_chunks: int
    payloads: list | None = None          # live mode: per-chunk args
    priority: int = 0                     # higher wins
    deadline_ms: float | None = None      # relative to t_submit
    done: int = 0
    t_submit: float = 0.0
    t_finish: float | None = None
    t_last_served: float | None = None    # last chunk issue (aging anchor)
    preemptions: int = 0                  # chunks evicted mid-flight
    failed: bool = False                  # aborted after a chunk error

    def __post_init__(self):
        # chunk ids not yet issued; preempted chunks return to the front
        self._chunks: deque[int] = deque(range(self.n_chunks))

    def next_chunk(self) -> int:
        return self._chunks.popleft()

    def requeue_chunk(self, chunk: int) -> None:
        self._chunks.appendleft(chunk)
        self.preemptions += 1

    @property
    def pending(self) -> int:
        return 0 if self.failed else len(self._chunks)

    @property
    def issued(self) -> int:
        return self.n_chunks - len(self._chunks)

    @property
    def outstanding(self) -> int:
        return self.issued - self.done

    @property
    def complete(self) -> bool:
        return self.done >= self.n_chunks

    @property
    def finished(self) -> bool:
        """Complete, or aborted with no chunks still in flight."""
        return self.complete or (self.failed and self.outstanding == 0)

    @property
    def deadline_at(self) -> float:
        if self.deadline_ms is None:
            return float("inf")
        return self.t_submit + self.deadline_ms


@dataclasses.dataclass(frozen=True)
class Assignment:
    rid: int
    chunk: int
    module: str
    footprint: int
    rng: Range
    reconfigure: bool                     # False -> reused resident module
    aid: int = -1                         # unique per issued assignment
    # effective priority at placement time: a chunk defends itself at the
    # level it won the slot with (aging resets on service, so a starved
    # request's hard-earned promotion must not evaporate mid-chunk)
    eff: int = 0
    # -- checkpoint/restore (core/checkpoint.py) -------------------------
    t_start: float = 0.0                  # placement instant (progress base)
    frac: float = 1.0                     # fraction of the chunk still to run
    restore_ms: float = 0.0               # context-restore cost, paid up front
    # context-save cost of the victims this assignment evicted, net of the
    # overlap with its own reconfiguration (save readback and configuration
    # use distinct ports, so only the excess delays the preemptor)
    save_ms: float = 0.0


@dataclasses.dataclass
class PolicyConfig:
    # prefer the largest implementation alternative when the system is
    # otherwise idle (paper: "attempts to use the biggest module")
    upsize_when_idle: bool = True
    # estimated reconfiguration cost relative to a chunk (cost model)
    reconfig_penalty_ms: float = 5.0
    elastic: bool = True                  # False -> fixed 1-slot scheduling
    preemptive: bool = False              # allow chunk-granularity eviction
    # aging: each full bound of queueing delay buys one priority level
    starvation_bound_ms: float = 100.0
    # evict only when the preemptor outranks the victim by at least this
    # many effective-priority levels (prevents same-class thrash)
    preempt_margin: int = 1
    # -- fabric-level policy (core/fabric.py) ----------------------------
    # dispatch to the shell already hosting the module resident (dodges
    # the reconfiguration penalty), falling back to least-loaded
    locality: bool = True
    # an idle shell pulls pending chunks queued behind a busy shell's
    # backlog (only meaningful for multi-shell fabrics, elastic mode)
    steal: bool = True
    # EWMA-refine est_chunk_ms per (module, footprint) from observed
    # chunk service times (daemon: wall clock; simulator: true times);
    # reconfigured chunks are observed too, at elapsed - reconfig penalty
    refine_cost_model: bool = False
    refine_alpha: float = 0.3             # weight of the newest observation
    # -- fabric heterogeneity (core/fabric.py) ---------------------------
    # modeled cross-shell payload-movement cost per stolen chunk; a
    # Fabric / FabricDescriptor may override it per (victim, thief)
    # pair, or replace the scalar model wholesale with a link-level
    # FabricNetwork topology (core/network.py)
    transfer_ms: float = 0.0
    # on a link topology, steal/migration/dispatch gates consult
    # queue-aware transfer estimates (current link occupancy, bounded
    # buffers -> inf when full).  False degrades every estimate to the
    # zero-load figure — the scalar model's belief replayed on real
    # links, the baseline benchmarks/network_contention.py gates
    # against.  Inert on the uniform (scalar) shim
    congestion_aware: bool = True
    # inform placement and steal economics with true per-shell speeds;
    # False treats every shell as speed 1.0 for *decisions* (the
    # benchmark's speed-blind baseline — true service times still apply)
    speed_aware: bool = True
    # -- checkpoint/restore (core/checkpoint.py) -------------------------
    # snapshot an evicted chunk's progress instead of discarding it; the
    # chunk later resumes with only its remaining fraction plus the
    # modeled restore cost.  Off by default: the ckpt=False path is
    # byte-identical to the pre-checkpoint contract (property-tested)
    ckpt: bool = False
    # modeled context save/restore costs; per-implementation overrides
    # via ImplAlt.meta["ckpt_save_ms"/"ckpt_restore_ms"].  Both scale
    # with shell speed like chunk times (context moves through the
    # shell's own fabric, unlike the configuration port)
    ckpt_save_ms: float = 1.0
    ckpt_restore_ms: float = 1.0
    # -- steal-aware admission reservation -------------------------------
    # hold back the last N aligned slots of every shell from requests of
    # base priority < reserve_priority, so a predicted interactive burst
    # finds capacity without evicting anyone — the cheap alternative to
    # checkpointed preemption.  A reservation that would leave a module
    # unplaceable forever is shrunk for that request (no wedged jobs)
    reserve_slots: int = 0
    reserve_priority: int = 1
    # -- predictive reservation (core/arrivals.py) -----------------------
    # "static" (default) sizes the reservation from reserve_slots;
    # "adaptive" sizes it every scheduling pass from the observed
    # interactive arrival rate (a Little's-law demand estimate over the
    # next reconfiguration+chunk horizon), clamped to
    # [0, reserve_slots_max] — reserve_slots is ignored in that mode
    reserve_mode: str = "static"
    reserve_slots_max: int = 1
    # EWMA weight of the newest inter-arrival/service observation
    arrival_alpha: float = 0.3
    # -- SLO-aware admission control (core/slo.py) -----------------------
    # EWMA weight of the admission controller's own load estimates
    # (per-contract job slot-ms and the background arrival stream); the
    # controller only exists once a QoSContract is registered, so these
    # knobs are inert on the no-contract path
    admission_alpha: float = 0.3
    # offered utilisation at or above which every finite deadline is
    # predicted infeasible (the Little's-law queue would grow without
    # bound); kept below 1.0 so the model saturates before the fabric
    admission_rho_max: float = 0.95


class CostModel:
    """Per-(module, footprint) chunk-time estimates, refined online.

    Starts from the registry's static `est_chunk_ms` and, when
    `PolicyConfig.refine_cost_model` is on, EWMA-updates from observed
    chunk service times (`observe`).  One instance is shared by every
    SchedulerState in a Fabric so an observation on any shell improves
    placement everywhere.

    Estimates are stored speed-normalised (a speed-1.0 shell's time):
    `est_chunk_ms(..., speed=s)` divides by the querying shell's speed,
    and `observe(..., speed=s)` multiplies the wall time back, so an
    observation on a slow shell still refines placement on a fast one.
    Speed 1.0 is the exact identity — the homogeneous path returns the
    same floats as before.
    """

    def __init__(self, registry, alpha: float = 0.3):
        self.registry = registry
        self.alpha = alpha
        self._est: dict[tuple[str, int], float] = {}
        # bumped on every observation: backlog/ECT caches keyed on it
        # are invalidated fabric-wide the moment an estimate moves
        self.version = 0

    def est_chunk_ms(self, module: str, footprint: int,
                     speed: float = 1.0) -> float:
        v = self._est.get((module, footprint))
        if v is None:
            v = self.registry.module(module).impl_for(
                footprint).est_chunk_ms
        return v / speed

    def observe(self, module: str, footprint: int, ms: float,
                speed: float = 1.0) -> None:
        key = (module, footprint)
        ms = ms * speed
        prev = self._est.get(key)
        self._est[key] = ms if prev is None else \
            self.alpha * ms + (1.0 - self.alpha) * prev
        self.version += 1


# -- schedlint contract (repro_torch.analysis) ------------------------------------
# One source of truth shared by the code and the static checker
# (`python -m repro_torch.analysis`): the incremental fabric core elides
# scheduling passes for shells whose `_version` has not moved, so every
# mutation of the fields below MUST be accompanied by a version bump
# (`_touch` for external entry points — it also fires `on_change`, the
# fabric's dirty-set hook — or `_bump` for scheduling-internal paths) on
# the same execution path.  The mutation checker (analysis/mutation.py)
# proves this per-commit; the runtime sanitizer (REPRO_SANITIZE=1,
# analysis/sanitizer.py) shadow-hashes the same fields and asserts the
# dynamic counterpart between passes.  docs/static_analysis.md derives
# the invariant from docs/simulator.md's dirty-shell fixpoint argument.
TRACKED_FIELDS = (
    "queues", "requests", "active", "resident", "alloc",
    "_pending_n", "_served_at", "_serve_seq",
)
# Method names that mutate a tracked container/object when called on it
# (or on an alias of it).  Python's stdlib mutators plus this repo's
# domain mutators (Request/BuddyAllocator); reads are everything else.
TRACKED_MUTATORS = (
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "remove", "discard", "add", "update", "clear", "setdefault",
    "next_chunk", "requeue_chunk", "alloc", "alloc_at", "free",
    "_mark", "_unmark",
)
# External entry points: any mutating path through these must fire
# `_touch` specifically (a bare `_bump` would move the version without
# dirtying the fabric's incremental set — state and schedule would
# still drift apart).
EXTERNAL_MUTATORS = (
    "submit", "abort", "steal_pending", "steal_front", "complete",
)
# Intentionally untracked mutable attributes, each with the invariant
# that makes skipping the version bump safe.  The checker rejects
# mutations of attributes in neither table, so a new field must be
# classified here or in TRACKED_FIELDS before it lands.
UNTRACKED_FIELDS = {
    "_now": "event-time anchor; the fabric advances it for every shell "
            "on every event, dirty or not",
    "_version": "the version counter itself",
    "reserve_history": "sampled per event by Fabric.schedule "
                       "(sample_reserve); a change re-dirties the shell",
    "_reserve_last": "hysteresis anchor of the per-event reservation "
                     "sample; covered by the steal fingerprint directly",
    "_reserve_now": "pass-transient pin, always reset to None",
    "_save_ms_pending": "pass-transient preemption bookkeeping, "
                        "consumed before the pass ends",
    "_preempted": "executor drain queue; never read by scheduling "
                  "decisions",
    "n_preemptions": "reporting counter; never read by scheduling",
    "_tenant_last_ms": "fabric-shared service map; anchors only move "
                       "forward, so a stale next_wake fires early "
                       "(a no-op pass), never late",
    "_shadow": "sanitizer snapshot (analysis/sanitizer.py)",
    "on_change": "constructor/executor wiring, not scheduling state",
    "on_reserve": "observability wiring (repro_torch.obs); fired on reserve "
                  "changes, never read by scheduling decisions",
    "transfer_of": "constructor wiring (fabric hook)",
    "_rid": "constructor wiring (fabric-shared counter)",
    "_aid": "constructor wiring (fabric-shared counter)",
}


class SchedulerState:
    def __init__(self, n_slots: int, registry,
                 policy: PolicyConfig | None = None,
                 cost: CostModel | None = None, speed: float = 1.0,
                 ckpt: CheckpointManager | None = None,
                 ckpt_capable: bool = True, name: str | None = None,
                 arrivals: ArrivalEstimator | None = None,
                 tenant_last_ms: dict | None = None):
        self.alloc = BuddyAllocator(n_slots)
        self.registry = registry
        self.policy = policy or PolicyConfig()
        # relative clock of the hosting shell: this shell serves a chunk
        # in est_chunk_ms / speed (1.0 = the homogeneous seed behavior)
        self.speed = speed
        self.cost = cost or CostModel(registry, self.policy.refine_alpha)
        # checkpoint/restore: a Fabric shares one manager across shells
        # (like the CostModel); a bare state builds its own when the
        # policy asks for checkpointing.  ckpt_capable=False models a
        # shell without context readback: it evicts lossily even when
        # the policy checkpoints elsewhere.
        self.name = name
        self.ckpt_capable = ckpt_capable
        if ckpt is not None:
            self.ckpt = ckpt
        elif self.policy.ckpt:
            self.ckpt = CheckpointManager(registry, self.policy)
        else:
            self.ckpt = None
        if self.policy.reserve_mode not in ("static", "adaptive"):
            raise ValueError(
                f"reserve_mode must be 'static' or 'adaptive', got "
                f"{self.policy.reserve_mode!r}")
        # predictive reservation: a Fabric shares one ArrivalEstimator
        # across shells and feeds it at job admission (so stolen
        # re-submits are never double-counted); a bare state owns its
        # own and observes its direct submits
        if arrivals is not None:
            self.arrivals = arrivals
            self._observe_arrivals = False
        elif self.policy.reserve_mode == "adaptive":
            self.arrivals = ArrivalEstimator(self.policy.arrival_alpha)
            self._observe_arrivals = True
        else:
            self.arrivals = None
            self._observe_arrivals = False
        # effective-reservation trace [(t_ms, slots), ...], recorded on
        # change; the per-pass cache keeps one sizing decision coherent
        # across every placement/preemption/steal of a schedule() pass
        self.reserve_history: list[tuple[float, int]] = []
        self._reserve_last = 0
        self._reserve_now: int | None = None
        self._save_ms_pending = 0.0       # victims' save cost -> preemptor
        # optional rid -> cross-shell transfer cost hook (a Fabric wires
        # it to the stolen sub-request table): a stolen chunk's transfer
        # is overhead, not compute, when estimating evicted progress
        self.transfer_of = None
        self.queues: dict[str, deque[Request]] = {}
        # least-recently-served round robin: new tenants get priority
        self._served_at: dict[str, int] = {}
        self._serve_seq = 0
        # tenant -> last chunk-issue time (ms): the starvation-waiver
        # signal for reservation access (_tenant_starved).  A Fabric
        # shares one map across shells (like the cost model): a tenant
        # being served *anywhere* is not starved, so a stolen
        # sub-request of a served-elsewhere tenant cannot pierce the
        # thief's reserve
        self._tenant_last_ms: dict[str, float] = \
            {} if tenant_last_ms is None else tenant_last_ms
        self.resident: dict[tuple[int, int], tuple[str, int]] = {}
        #        (start, size) -> (module, footprint) for idle ranges too
        self.requests: dict[int, Request] = {}
        self.active: dict[int, Assignment] = {}       # aid -> in-flight
        self.n_preemptions = 0
        self._preempted: list[Assignment] = []        # drained by executor
        self._rid = itertools.count()
        self._aid = itertools.count()
        self._now = 0.0
        # incrementally maintained unissued-chunk count (pending_chunks
        # is on the fabric's per-event dispatch and steal paths)
        self._pending_n = 0
        # monotonically bumped on any mutation that can move the shell's
        # estimated backlog; the fabric keys its _backlog_ms cache on it
        self._version = 0
        # optional zero-arg callback fired on external mutations
        # (submit/abort/complete/steal): a Fabric wires it to its
        # dirty-shell set so direct state access — the daemon's legacy
        # single-shell path — still invalidates incremental scheduling
        self.on_change = None
        # optional (now_ms, slots) callback fired when sample_reserve
        # records a change — observability wiring (repro_torch.obs), never
        # read by any scheduling decision
        self.on_reserve = None
        # REPRO_SANITIZE shadow snapshot (analysis/sanitizer.py):
        # (version, hash of tracked fields) at the last pass boundary
        self._shadow = None

    # -- incremental bookkeeping ----------------------------------------------

    def _bump(self) -> None:
        """A scheduling-internal mutation changed the backlog."""
        self._version += 1

    def _touch(self) -> None:
        """An external mutation changed the shell's scheduling state."""
        self._version += 1
        if self.on_change is not None:
            self.on_change()

    # -- queue management -----------------------------------------------------

    def submit(self, tenant: str, module: str, n_chunks: int,
               payloads=None, now: float = 0.0, priority: int = 0,
               deadline_ms: float | None = None,
               rid: int | None = None) -> Request:
        # a Fabric pre-draws the id from the shared counter so a job's
        # global id equals its primary sub-request's rid on every shell
        rid = next(self._rid) if rid is None else rid
        req = Request(rid, tenant, module, n_chunks, payloads,
                      priority=priority, deadline_ms=deadline_ms,
                      t_submit=now)
        self.requests[rid] = req
        self._now = max(self._now, now)
        if self._observe_arrivals and self.arrivals is not None:
            # bare-state path: a fabric observes at job admission instead
            fp = min(self.registry.module(module).footprints)
            self.arrivals.observe(
                priority, self._now,
                service_ms=self.cost.est_chunk_ms(module, fp),
                footprint=fp)
        if tenant not in self.queues:
            self.queues[tenant] = deque()
            self._served_at.setdefault(tenant, -1)
        self.queues[tenant].append(req)
        self._pending_n += n_chunks
        self._touch()
        return req

    def abort(self, rid: int) -> None:
        """Drop a request's unissued chunks (called after a chunk error).

        In-flight chunks still drain through `complete`; once none remain
        the request is popped from its tenant queue so the tenant is not
        head-of-line blocked by a dead request.
        """
        req = self.requests.get(rid)
        if req is None or req.failed or req.finished:
            return                        # repeat aborts are no-ops
        self._pending_n -= len(req._chunks)  # failed -> pending reads 0
        req.failed = True
        if self.ckpt is not None:
            self.ckpt.drop_request(rid)   # dead chunks never resume
        self._pop_finished(req)
        self._touch()

    def steal_pending(self, rid: int, k: int) -> list[int]:
        """Remove up to `k` unissued chunks from the *tail* of a request's
        pending queue (the chunks furthest from execution — preemption
        victims requeued at the front are taken last) and shrink the
        request accordingly.  Returns the removed chunk ids — the caller
        (a Fabric) re-submits them elsewhere, so each chunk still runs
        exactly once.  A request drained to completion by the steal is
        popped from its tenant queue.

        Checkpointed chunks are never taken from the tail: moving a
        saved context is only worthwhile when restore + transfer +
        remaining wins, which the fabric's gated resume-steal
        (`steal_front`) prices explicitly.
        """
        req = self.requests[rid]
        if req.failed:
            return []
        take = []
        for _ in range(min(k, len(req._chunks))):
            if self.ckpt is not None \
                    and self.ckpt.peek(rid, req._chunks[-1]) is not None:
                break
            take.append(req._chunks.pop())
        req.n_chunks -= len(take)
        self._pending_n -= len(take)
        self._pop_finished(req)
        # unconditional even on an empty take: _pop_finished may still
        # drop a fully-drained request from its tenant queue (a tracked
        # mutation), and a spurious dirty is a no-op reschedule while a
        # missed one diverges from full_reschedule (schedlint mutation)
        self._touch()
        return take

    def steal_front(self, rid: int, k: int) -> list[int]:
        """`steal_pending` from the *front* of the pending queue — where
        preemption victims are requeued.  A fabric uses this to migrate
        a *checkpointed* chunk to another shell when resuming it there
        (restore + transfer + remaining) beats the victim draining it
        locally; the caller re-keys the checkpoint record."""
        req = self.requests[rid]
        if req.failed:
            return []
        take = []
        for _ in range(min(k, len(req._chunks))):
            take.append(req._chunks.popleft())
        req.n_chunks -= len(take)
        self._pending_n -= len(take)
        self._pop_finished(req)
        self._touch()      # unconditional: see steal_pending
        return take

    def pending_chunks(self) -> int:
        """Unissued chunks across every queued request (backlog metric).
        O(1): maintained at every queue mutation (see _pending_chunks_slow
        for the defining recomputation, cross-checked by the test suite)."""
        return self._pending_n

    def _pending_chunks_slow(self) -> int:
        return sum(r.pending for q in self.queues.values() for r in q)

    def _pop_finished(self, req: Request) -> None:
        """Unblock the tenant queue once a request has fully drained.
        Requests can finish out of FIFO order (priorities), so remove by
        identity, not just at the head."""
        if req.finished:
            q = self.queues.get(req.tenant)
            if q is not None:
                try:
                    q.remove(req)
                except ValueError:
                    pass

    def _eligible(self, req: Request) -> bool:
        if req.pending <= 0:
            return False
        # fixed-module scheduling (paper Fig 15a): one module instance per
        # task, chunks strictly sequential -> no replication
        if not self.policy.elastic and req.outstanding > 0:
            return False
        return True

    def _best_request(self, tenant: str,
                      now: float | None = None) -> Optional[Request]:
        """The tenant request the policy would serve next.

        Elastic mode honors per-request priority/deadline anywhere in the
        tenant's queue (an urgent submit overtakes the same tenant's own
        earlier batch work); fixed mode keeps the paper's strict per-tenant
        FIFO so the Fig-15 baseline semantics are unchanged.
        """
        now = self._now if now is None else now
        q = self.queues.get(tenant)
        if not q:
            return None
        if not self.policy.elastic:
            return q[0] if self._eligible(q[0]) else None
        best, bestk = None, None
        for r in q:
            if not self._eligible(r):
                continue
            k = (-self.effective_priority(r, now), r.deadline_at, r.rid)
            if best is None or k < bestk:
                best, bestk = r, k
        return best

    def _pick(self, now: float) -> tuple[Optional[Request], int]:
        """One pass over the tenant queues: the request to serve next
        (highest effective priority, then earliest deadline, then
        least-recently-served tenant — paper Fig 14 when neither is set)
        and the number of contending tenants (the _choose fairness flag).
        """
        best, best_key, contending = None, None, 0
        for t in self.queues:
            r = self._best_request(t, now)
            if r is None:
                continue
            contending += 1
            k = (-self.effective_priority(r, now), r.deadline_at,
                 self._served_at[t])
            if best_key is None or k < best_key:
                best, best_key = r, k
        return best, contending

    # -- priority model --------------------------------------------------------

    def effective_priority(self, req: Request, now: float | None = None) -> int:
        """Base priority plus starvation aging: one level per bound of
        *queueing* delay — the clock resets whenever the request is served,
        so continuously-served work does not age into out-ranking fresh
        high-priority arrivals."""
        now = self._now if now is None else now
        since = req.t_submit if req.t_last_served is None \
            else max(req.t_submit, req.t_last_served)
        waited = max(0.0, now - since)
        bound = max(self.policy.starvation_bound_ms, 1e-9)
        return req.priority + int(waited // bound)

    def _advance_rr(self, tenant: str) -> None:
        self._served_at[tenant] = self._serve_seq
        self._serve_seq += 1

    # -- placement decision -----------------------------------------------------

    def _n_free_ranges(self, size: int, within: int | None = None) -> int:
        """Number of *disjoint* free aligned windows of `size` slots —
        a maximal non-overlapping packing, i.e. how many chunks could
        actually run concurrently.  Buddy alignment yields disjoint
        windows already; the packing scan keeps the count honest for
        any allocator whose aligned starts overlap (counting every free
        start would overstate `conc` in `_choose`'s rate model and skew
        alternative selection toward over-replication)."""
        within = self.alloc.n if within is None else within
        n = 0
        next_free = 0
        for start in self.alloc.aligned_starts(size):
            if start < next_free:
                continue                  # overlaps a counted window
            if start + size <= within and \
                    self.alloc.window_free(start, size):
                n += 1
                next_free = start + size
        return n

    # adaptive reservation shrinks one level only once predicted demand
    # falls this far below the round-down point: a single long gap in
    # an exponential arrival stream must not flap the reservation off
    # right before the stream's next burst (raising is immediate)
    RESERVE_HYSTERESIS = 0.25

    def effective_reserve(self, now: float | None = None) -> int:
        """Slots currently held back for the interactive class: the
        static `reserve_slots` knob, or — `reserve_mode == "adaptive"` —
        the arrival estimator's predicted interactive demand over the
        blocking-chunk + reconfiguration + service horizon (Little's
        law: rate x wait-window x footprint), rounded with downward
        hysteresis and clamped to `[0, reserve_slots_max]`."""
        p = self.policy
        if p.reserve_mode != "adaptive":
            return p.reserve_slots
        if self.arrivals is None or p.reserve_slots_max <= 0:
            return 0
        now = self._now if now is None else now
        demand = self.arrivals.demand_slots(
            p.reserve_priority, now,
            overhead_ms=p.reconfig_penalty_ms, speed=self.speed)
        target = int(demand + 0.5)
        prev = self._reserve_last
        if target < prev and demand > prev - 0.5 - self.RESERVE_HYSTERESIS:
            target = prev               # inside the band: hold
        return min(target, p.reserve_slots_max)

    def sample_reserve(self, now: float) -> int:
        """Evaluate the effective reservation at `now`, updating the
        hysteresis anchor and recording changes in `reserve_history` —
        exactly what the head of a scheduling pass does.  An incremental
        fabric calls this once per event for *every* shell (scheduled or
        not) so the sizing trace and the hysteresis state stay identical
        to the reschedule-everything core; the call is idempotent at a
        fixed (now, estimator state)."""
        r = self.effective_reserve(now)
        if r != self._reserve_last:
            self.reserve_history.append((now, r))
            self._reserve_last = r
            if self.on_reserve is not None:
                self.on_reserve(now, r)
        return r

    def next_wake(self, now: float) -> float:
        """Earliest future instant at which this shell's scheduling
        outcome can change with *no* state mutation in between: a queued
        request crossing a starvation-aging boundary (its effective
        priority steps, reordering _pick / enabling preemption), or a
        tenant crossing the starvation bound (the reservation waiver
        flips on).  With no pending work nothing time-driven can change
        — completions and arrivals dirty the shell through events.  The
        adaptive reservation is *not* a wake source: the fabric samples
        it every event (`sample_reserve`).  Anchors only move forward,
        so a stale stored wake fires early (a no-op reschedule), never
        late."""
        if self._pending_n <= 0:
            return float("inf")
        bound = max(self.policy.starvation_bound_ms, 1e-9)
        wake = float("inf")
        for q in self.queues.values():
            for r in q:
                if r.pending <= 0:
                    continue
                since = r.t_submit if r.t_last_served is None \
                    else max(r.t_submit, r.t_last_served)
                waited = max(0.0, now - since)
                wake = min(wake, since + (int(waited // bound) + 1) * bound)
                last = self._tenant_last_ms.get(r.tenant)
                anchor = r.t_submit if last is None else last
                if anchor + bound > now:
                    wake = min(wake, anchor + bound)
        return wake

    def _current_reserve(self, now: float | None = None) -> int:
        """The pass-coherent reservation size: schedule() pins one value
        per pass; callers outside a pass (fabric dispatch/steal sizing)
        get a fresh computation at *their* clock — a fabric passes its
        own `now` so staleness decay does not lag on a shell whose
        local clock has not advanced in a while."""
        return self.effective_reserve(now) if self._reserve_now is None \
            else self._reserve_now

    def reserve_for_class(self, priority: int, module: str,
                          now: float | None = None) -> int:
        """Slots at the top of the shell held back from a request of
        effective `priority` targeting `module`: 0 for the interactive
        class (priority >= reserve_priority).  A reservation the module
        cannot fit under is *shrunk* to the largest value that still
        leaves it a feasible window — one big-footprint batch module
        must not silently disable interactive protection on the shell."""
        n = self._current_reserve(now)
        if n <= 0 or priority >= self.policy.reserve_priority:
            return 0
        n = min(n, self.alloc.n)
        desc = self.registry.module(module)
        if min(desc.footprints) > self.alloc.n - n:
            n = max(0, self.alloc.n - min(desc.footprints))
        return n

    def _tenant_starved(self, req: Request) -> bool:
        """Has `req`'s tenant gone a full starvation bound with no
        service at all?  A tenant that is merely *backlogged* — its
        earlier requests are being served continuously, on this shell
        or (fabric-shared map) on any other — is not starved, even
        though its queued requests age from submit."""
        last = self._tenant_last_ms.get(req.tenant)
        anchor = req.t_submit if last is None else last
        return (self._now - anchor) >= \
            max(self.policy.starvation_bound_ms, 1e-9)

    def _reserve_for(self, req: Request) -> int:
        # starvation waiver: a request whose effective priority has
        # *aged* into the interactive class AND whose tenant has gone a
        # full starvation bound without any service may use the reserve
        # — the reservation defers batch work, it must not starve a
        # tenant forever.  A backlogged-but-served tenant's aged queue
        # entries do not pierce the reserve (they are making progress;
        # letting them in would poison the very burst headroom the
        # reservation exists for).
        eff = self.effective_priority(req)
        if eff > req.priority and eff >= self.policy.reserve_priority \
                and self._tenant_starved(req):
            return 0
        return self.reserve_for_class(req.priority, req.module)

    def _choose(self, req: Request,
                multi_tenant: bool = False) -> tuple[int, Range, bool] | None:
        """Cost-model choice of implementation alternative + range.

        Rate model: serving min(pending, n_free_ranges(fp)) chunks
        concurrently, each costing est_chunk_ms (+ reconfig penalty unless a
        free range already hosts this module at that footprint).  Pick the
        max-rate option; ties prefer reuse, then the bigger alternative
        (paper: biggest module assumed Pareto-optimal).  elastic=False
        pins everything to the smallest footprint with no replacement.
        """
        desc = self.registry.module(req.module)
        # admission reservation: the top reserve_slots stay out of reach
        # of non-interactive requests (with an unplaceable-forever waiver)
        within = self.alloc.n - self._reserve_for(req)
        fps = [f for f in desc.footprints if self.alloc.can_alloc(f, within)]
        if not self.policy.elastic:
            fps = [f for f in fps if f == min(desc.footprints)]
        if not fps:
            return None
        if multi_tenant or not self.policy.upsize_when_idle:
            # fairness first: smallest footprint, but still reuse if free
            fps = [min(fps)]

        def free_reuse_range(fp: int) -> Range | None:
            for (start, size), (m, f) in self.resident.items():
                if m == req.module and f == fp and size == fp \
                        and start + size <= within \
                        and self.alloc.window_free(start, size):
                    return Range(start, size)
            return None

        best = None  # (rate, reuse, fp, range, reconfigure)
        for fp in fps:
            est = self.cost.est_chunk_ms(req.module, fp, self.speed)
            reuse = free_reuse_range(fp)
            n_avail = self._n_free_ranges(fp, within)
            conc = max(1, min(req.pending, n_avail))
            if reuse is not None:
                t = est
                cand = (conc / max(t, 1e-9), 1, fp, reuse, False)
            else:
                r = self.alloc.find(fp, within)
                if r is None:
                    continue
                prev = self.resident.get((r.start, r.size))
                reconf = prev != (req.module, fp)
                t = est + (
                    self.policy.reconfig_penalty_ms if reconf else 0.0)
                cand = (conc / max(t, 1e-9), 0, fp, r, reconf)
            if best is None or (cand[0], cand[1], cand[2]) > \
                    (best[0], best[1], best[2]):
                best = cand
        if best is None:
            return None
        return best[2], best[3], best[4]

    # -- preemption -------------------------------------------------------------

    def _preempt_for(self, req: Request, now: float,
                     exclude: set[int] = frozenset()) -> bool:
        """Make room for `req`'s smallest implementation alternative by
        evicting in-flight chunks.  Considers each aligned window the
        allocator could place into and evicts only the victims occupying
        the cheapest feasible window — no assignment loses work unless its
        slots are part of the window the preemptor actually gets.
        """
        desc = self.registry.module(req.module)
        need = min(desc.footprints)
        if need > self.alloc.n:
            return False
        eff = self.effective_priority(req, now)
        # a margin below 1 would let equal-priority requests evict each
        # other endlessly within one schedule() pass; clamp it
        margin = max(1, self.policy.preempt_margin)

        def evictable(a: Assignment) -> bool:
            # `exclude` holds assignments issued in the current schedule()
            # pass: aging resets on service, so without it a request served
            # moments ago could be evicted at the same instant it was
            # placed (zero-time churn, and the executor never saw it).
            # A chunk defends at the effective priority it was placed
            # with — NOT its current aged value, which for an in-flight
            # chunk measures *service* time and would grant long chunks
            # growing immunity to exactly the preemption they should face.
            return (a.rid != req.rid and a.aid not in exclude
                    and a.eff + margin <= eff)

        by_slot: dict[int, Assignment] = {}
        for a in self.active.values():
            for i in a.rng.slots:
                by_slot[i] = a
        # a reservation shields the reserved window from non-interactive
        # preemptors just as it does from their ordinary placements
        within = self.alloc.n - self._reserve_for(req)
        best = None  # ((max victim eff, n victims, -newest aid), victims)
        for start in self.alloc.aligned_starts(need):
            if start + need > within:
                continue
            victims: dict[int, Assignment] = {}
            feasible = True
            for i in range(start, start + need):
                if i not in self.alloc.busy:
                    continue
                a = by_slot.get(i)
                if a is None or not evictable(a):
                    feasible = False
                    break
                victims[a.aid] = a
            if not feasible or not victims:
                continue   # window blocked, or free (then _choose had it)
            cost = (max(a.eff for a in victims.values()),
                    len(victims),
                    -max(victims))     # prefer newest chunks: least sunk work
            if best is None or cost < best[0]:
                best = (cost, list(victims.values()))
        if best is None:
            return False
        save_ms = 0.0
        for a in best[1]:
            del self.active[a.aid]
            self.alloc.free(a.rng)
            victim = self.requests[a.rid]
            victim.requeue_chunk(a.chunk)
            if not victim.failed:         # failed -> pending reads 0
                self._pending_n += 1
            self._bump()
            if self.ckpt is not None and self.ckpt_capable \
                    and not victim.failed:
                # snapshot the victim's progress; distinct windows save
                # through their own context ports concurrently, so the
                # preemptor waits for the slowest save, not the sum.
                # A freshly-stolen chunk (frac 1.0 — resumed reruns paid
                # their transfer on the first attempt) spent its
                # transfer cost moving, not computing
                tr = self.transfer_of(a.rid) \
                    if self.transfer_of is not None and a.frac == 1.0 \
                    else 0.0
                est_full = self.cost.est_chunk_ms(a.module, a.footprint,
                                                  self.speed)
                save_ms = max(save_ms, self.ckpt.save(
                    a, now, est_full, speed=self.speed, shell=self.name,
                    extra_overhead_ms=tr))
            # an aborted request whose last in-flight chunk just got
            # evicted drains here, not via complete()
            self._pop_finished(victim)
            self._preempted.append(a)
            self.n_preemptions += 1
        self._save_ms_pending = save_ms
        return True

    def drain_preempted(self) -> list[Assignment]:
        """Victim assignments since the last drain; the executor must cancel
        them (their ranges are already freed and their chunks requeued)."""
        out, self._preempted = self._preempted, []
        return out

    # -- scheduling -------------------------------------------------------------

    def schedule(self, now: float | None = None,
                 placed: set[int] | None = None) -> list[Assignment]:
        """Fill free slots with chunks; called on every event.  Preemption
        victims (if any) are reported through `drain_preempted()`.

        `placed` collects the aids issued this pass (they are exempt from
        preemption — zero-time churn guard); a Fabric passes one set per
        shell across its main and steal-path schedule calls so the guard
        spans the whole fabric scheduling pass, not just this call.
        """
        now = self._now if now is None else max(self._now, now)
        self._now = now
        if sanitizer.SANITIZE:
            # a hash change since the last pass with no version bump is
            # a mutation the dirty-shell elision would have missed
            sanitizer.check(self)
        # pin one reservation size for the whole pass (adaptive mode
        # recomputes from the arrival estimator; static mode returns the
        # knob) so every placement, preemption and steal decision of
        # this pass sees the same value, and record changes for the
        # reserve_history trace
        self._reserve_now = self.sample_reserve(now)
        try:
            return self._schedule_locked(now, placed)
        finally:
            self._reserve_now = None
            if sanitizer.SANITIZE:
                sanitizer.rearm(self)

    def _schedule_locked(self, now: float,
                         placed: set[int] | None) -> list[Assignment]:
        out = []
        placed = set() if placed is None else placed
        while True:
            req, contending = self._pick(now)
            if req is None:
                break
            multi_tenant = contending > 1
            choice = self._choose(req, multi_tenant)
            if choice is None and self.policy.preemptive \
                    and self._preempt_for(req, now, exclude=placed):
                choice = self._choose(req, multi_tenant)
            if choice is None:
                self._save_ms_pending = 0.0
                break
            fp, rng, reconf = choice
            self.alloc.alloc_at(rng)
            # evict overlapped stale residents, then record the new one
            for key in [k for k in self.resident
                        if not (k[0] + k[1] <= rng.start
                                or rng.start + rng.size <= k[0])]:
                del self.resident[key]
            self.resident[(rng.start, rng.size)] = (req.module, fp)
            chunk = req.next_chunk()
            self._pending_n -= 1
            self._bump()
            frac, restore_ms = 1.0, 0.0
            if self.ckpt is not None:
                rec = self.ckpt.take(req.rid, chunk)
                if rec is not None:
                    # resume from the checkpoint: run only the remaining
                    # fraction, paying the priced restore cost up front
                    frac = rec.remaining
                    restore_ms = self.ckpt.restore_cost_ms(
                        req.module, fp, self.speed)
            save_ms = self._save_ms_pending
            self._save_ms_pending = 0.0
            if save_ms > 0.0 and reconf:
                # the victims' context save overlaps the preemptor's own
                # reconfiguration (readback and configuration ports are
                # distinct); only the excess delays the preemptor
                save_ms = max(0.0, save_ms
                              - self.policy.reconfig_penalty_ms)
            a = Assignment(req.rid, chunk, req.module, fp,
                           rng, reconf, aid=next(self._aid),
                           eff=self.effective_priority(req, now),
                           t_start=now, frac=frac,
                           restore_ms=restore_ms, save_ms=save_ms)
            self.active[a.aid] = a
            out.append(a)
            placed.add(a.aid)
            req.t_last_served = now
            self._tenant_last_ms[req.tenant] = now
            self._advance_rr(req.tenant)
        return out

    def complete(self, a: Assignment, now: float = 0.0) -> bool:
        """Record a finished chunk.  Returns False (a no-op) when the
        assignment was preempted before completion — the executor must then
        discard the result; the chunk re-runs under a fresh assignment."""
        if a.aid not in self.active:
            return False
        del self.active[a.aid]
        self.alloc.free(a.rng)
        self._now = max(self._now, now)
        req = self.requests[a.rid]
        req.done += 1
        if req.complete:
            req.t_finish = now
        self._pop_finished(req)
        self._touch()
        return True
