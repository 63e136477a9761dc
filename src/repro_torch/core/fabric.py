"""Fabric: one scheduling contract over many shells.

A `Fabric` is a named collection of shells, each backed by its own
`SchedulerState`, behind a single submit/schedule/complete contract that
both executors (the discrete-event simulator and the live daemon) drive.
It is the scale-out layer FOS motivates with its standardised abstraction
argument: the space-time policy stays a pure per-shell core, and the
fabric adds the cross-shell arbitration —

  - a **global admission queue**: `submit` records a `FabricJob`;
    dispatch to a concrete shell is deferred to the next `schedule`
    call so placement sees current residency and load;
  - **locality-aware dispatch** (`PolicyConfig.locality`): a job goes to
    the shell already hosting its module resident (dodging the modeled
    reconfiguration penalty), falling back to least-loaded, with an
    optional hard `affinity=` override per job;
  - **cross-shell work stealing** (`PolicyConfig.steal`): a shell with
    free slots and no local backlog pulls unissued chunks queued behind
    the most-backlogged shell; the thief pays the reconfiguration
    penalty through the ordinary cost model, chunks are taken from the
    tail (preemption victims requeued at the front go last), and every
    chunk still runs exactly once;
  - a shared `CostModel` so online `est_chunk_ms` refinement on any
    shell improves placement everywhere;
  - a shared `ArrivalEstimator` (`PolicyConfig.reserve_mode ==
    "adaptive"`, core/arrivals.py): every admitted job is observed once
    at `submit`, and each shell sizes its effective interactive
    reservation from the predicted demand every scheduling pass —
    dispatch ECT and steal sizing treat reserved slots as capacity the
    batch class cannot use;
  - a shared `CheckpointManager` (`PolicyConfig.ckpt`,
    core/checkpoint.py): evicted chunks keep their progress, and
    **checkpointed migration** lets stealing move a checkpointed chunk
    to another shell when restore + transfer + its remaining fraction
    beats the victim draining its own backlog (the record is re-keyed
    to the thief's sub-request; shells with `ShellSpec.ckpt = False`
    neither save nor accept checkpoints);
  - **heterogeneity awareness**: each shell carries a relative `speed`
    (a chunk takes `est_chunk_ms / speed` there) and each (victim,
    thief) pair a cross-shell `transfer_ms` per stolen chunk
    (`PolicyConfig.transfer_ms` default, per-pair overrides from the
    `FabricDescriptor`); no-affinity dispatch ranks shells by estimated
    completion time instead of raw backlog, and a *priced* steal
    (nonzero transfer, or unequal speeds) is skipped when the transfer
    + the thief's (speed-scaled) service time would finish *later* than
    the victim clearing its own backlog.  At all speeds 1.0 + transfer
    0.0 the gate is inert and per-shell scheduling, chunk times and
    stealing are unchanged; the one deliberate homogeneous-path change
    is dispatch ranking, which weighs queues in estimated milliseconds
    (ECT) rather than raw chunk counts.

Identity model: all shells share one rid counter and one aid counter, so
request/assignment ids are unique fabric-wide, and a job's global id
(`FabricJob.gid`) equals the rid of its *primary* sub-request.  The
degenerate one-shell fabric therefore reproduces `SchedulerState`
behavior exactly — same rids, same event order, same floats — which is
how `Daemon(shell, ...)` and `simulate(registry, n_slots, ...)` keep
their seed semantics unchanged.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Iterable, Mapping

from repro_torch.analysis import sanitizer
from repro_torch.core.arrivals import ArrivalEstimator
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.network import FabricNetwork
from repro_torch.core.registry import parse_transfer_pair
from repro_torch.core.scheduler import Assignment, CostModel, PolicyConfig, \
    SchedulerState
from repro_torch.core.slo import AdmissionController, AdmissionVerdict, \
    DEGRADE, QoSContract, REJECT


@dataclasses.dataclass(eq=False)
class FabricJob:
    """One submitted job, tracked fabric-wide across its sub-requests.

    `eq=False`: jobs compare (and hash) by identity.  Membership tests
    against the admission queue must mean "this very job object" — a
    value-based eq would deep-compare payload lists against every queued
    job on each `finished()` poll (O(queue x payload), and wrong in
    principle for two jobs with equal fields).
    """
    gid: int
    tenant: str
    module: str
    n_chunks: int
    payloads: list | None = None
    priority: int = 0
    deadline_ms: float | None = None
    affinity: str | None = None          # pin dispatch to this shell
    t_submit: float = 0.0
    t_finish: float | None = None
    done: int = 0
    failed: bool = False
    # (shell_name, rid) of every sub-request carrying this job's chunks
    subs: list = dataclasses.field(default_factory=list)
    # -- SLO admission (core/slo.py); all None/False without contracts --
    verdict: AdmissionVerdict | None = None
    degraded_from: str | None = None     # offered module a DEGRADE swapped
    rejected: bool = False               # shed at admission: never runs

    @property
    def complete(self) -> bool:
        return self.done >= self.n_chunks

    @property
    def deadline_at(self) -> float:
        if self.deadline_ms is None:
            return float("inf")
        return self.t_submit + self.deadline_ms


# -- schedlint memo contracts (checked by `python -m repro_torch.analysis`) --------
#
# Every memo cache the incremental fabric leans on, with the version
# tokens its key covers.  The memo checker (analysis/memo.py) walks the
# cached computation and flags any read of versioned state the key
# misses; `folded` declares tokens covered indirectly, each with the
# argument for why.  Plain literals on purpose: the checker extracts
# them from the AST without importing this module.
MEMO_CONTRACTS = (
    {"name": "backlog_ms",
     "func": "Fabric._backlog_ms",
     "cache": "_backlog_cache",
     "key": ("state", "cost"),
     "folded": {}},
    {"name": "steal_fingerprint",
     "func": "Fabric._steal_from",
     "cache": "_steal_fail",
     "key": ("state", "cost", "reserve"),
     "folded": {
         "arrivals": "Fabric.schedule resamples every shell's "
                     "reservation from the estimator on every event "
                     "(sample_reserve), so an arrival-model change is "
                     "folded into the thief's _reserve_last — which "
                     "the fingerprint covers directly — before any "
                     "steal gate runs",
         "now": "the clock enters the gate only through the per-event "
                "reservation sample (_reserve_last, covered) and the "
                "demand memo, which keys on `now` itself; the drain/"
                "price comparison reads no absolute time (the "
                "load-aware transfer estimate does read `now`, but "
                "only on an active link network, where the cache is "
                "bypassed — see the `net` entry)",
         "net": "link-state reads (est_transfer_ms: busy_until, "
                "inflight) resolve to construction-time constants on "
                "the degenerate uniform topology, and the fingerprint "
                "cache is consulted only there — _steal bypasses it "
                "entirely whenever `network.active` (link occupancy "
                "moves without any shell/cost version bump, so no "
                "4-tuple fingerprint could stay sound)"}},
)


class Fabric:
    """Named shells behind a single scheduling contract.

    `shells` maps shell name -> slot count (speed 1.0), an
    `(n_slots, speed)` tuple, or anything with an `n_slots` attribute
    and optional `speed`, e.g. a ShellSpec.  All shells share one
    `PolicyConfig` and one `CostModel`.  `transfer` optionally maps
    `(victim, thief)` pairs (or `"victim->thief"` strings) to the
    modeled cross-shell payload-movement cost per stolen chunk,
    overriding `PolicyConfig.transfer_ms` for that direction.

    `network` optionally supplies a link-level `FabricNetwork`
    (core/network.py): transfer costs then come from queue-aware
    store-and-forward estimates over the topology instead of the
    scalar/per-pair model, and realized steals occupy links.  Omitted,
    the scalar knobs become a degenerate uniform topology — the
    byte-identical compatibility shim.  A link topology and per-pair
    `transfer` overrides are mutually exclusive (the topology already
    prices every pair).
    """

    def __init__(self, shells: Mapping[str, Any], registry,
                 policy: PolicyConfig | None = None,
                 cost: CostModel | None = None,
                 transfer: Mapping[Any, float] | None = None,
                 network: FabricNetwork | None = None):
        if not shells:
            raise ValueError("a fabric needs at least one shell")
        self.registry = registry
        self.policy = policy or PolicyConfig()
        self.cost = cost or CostModel(registry, self.policy.refine_alpha)
        self._rid = itertools.count()        # fabric-wide id spaces
        self._aid = itertools.count()
        # one checkpoint manager shared by every shell (like the cost
        # model): records follow chunks across shells when stealing
        # migrates them, and accounting is fabric-wide
        self.ckpt = CheckpointManager(registry, self.policy) \
            if self.policy.ckpt else None
        # predictive reservation: one arrival estimator shared by every
        # shell (like the cost model), fed once per job at admission —
        # a stolen sub-request's re-submit is a placement move, not an
        # arrival, so per-shell submits never observe
        self.arrivals = ArrivalEstimator(self.policy.arrival_alpha) \
            if self.policy.reserve_mode == "adaptive" else None
        # tenant -> last service time, shared by every shell: the
        # reservation's starvation waiver must see fabric-wide service
        # (a stolen sub-request of a tenant served elsewhere is
        # backlogged, not starved)
        self.tenant_service: dict[str, float] = {}
        self.states: dict[str, SchedulerState] = {}
        self.speeds: dict[str, float] = {}   # true relative clocks
        self.ckpt_capable: dict[str, bool] = {}
        for name, n in shells.items():
            if isinstance(n, int):
                n_slots, speed, capable = n, 1.0, True
            elif isinstance(n, tuple):
                (n_slots, speed), capable = n, True
            else:
                n_slots = n.n_slots
                speed = getattr(n, "speed", 1.0)
                # ShellSpec.ckpt = False models a shell without context
                # readback: it evicts lossily, and checkpoints never
                # migrate onto it
                capable = getattr(n, "ckpt", True)
            if speed <= 0:
                raise ValueError(f"shell {name!r} speed must be "
                                 f"positive, got {speed}")
            self.speeds[name] = speed
            self.ckpt_capable[name] = capable
            # a speed-blind policy plans as if every shell ran at the
            # reference clock (true times still apply in the executor)
            st = SchedulerState(
                n_slots, registry, self.policy, cost=self.cost,
                speed=speed if self.policy.speed_aware else 1.0,
                ckpt=self.ckpt, ckpt_capable=capable, name=name,
                arrivals=self.arrivals,
                tenant_last_ms=self.tenant_service)
            st._rid = self._rid
            st._aid = self._aid
            # progress estimation must know a stolen chunk's transfer
            # cost is overhead, not compute (mirrors the simulator's
            # reclaim accounting)
            st.transfer_of = (
                lambda nm: lambda rid: self._sub_transfer.get(
                    (nm, rid), 0.0))(name)
            self.states[name] = st
        self._transfer: dict[tuple[str, str], float] = {}
        for key, ms in (transfer or {}).items():
            pair = parse_transfer_pair(key, self.states)
            self._transfer[pair] = float(ms)
        if network is not None and network.active and self._transfer:
            raise ValueError(
                "per-pair transfer overrides and a link topology are "
                "mutually exclusive: the topology already prices every "
                "shell pair")
        # the interconnect model every transfer estimate reads; absent a
        # topology, the scalar knobs *are* the (uniform) network
        self.network = network if network is not None else \
            FabricNetwork.uniform(self.states, self.policy.transfer_ms,
                                  self._transfer)
        # SLO admission control: constructed lazily by the first
        # register_contract — a fabric with no contract never screens,
        # so the no-contract path stays byte-identical (core/slo.py)
        self.slo: AdmissionController | None = None
        self.jobs: dict[int, FabricJob] = {}
        # (shell_name, rid) -> (job, {local chunk id -> global chunk id})
        self._subs: dict[tuple[str, int], tuple[FabricJob, dict]] = {}
        # (shell_name, rid) -> transfer cost per chunk of a stolen
        # sub-request; the simulator realizes it in the chunk's time
        self._sub_transfer: dict[tuple[str, int], float] = {}
        # (shell, rid, chunk) identities retired by steals since the
        # last drain_moved(): the chunk now lives under a thief
        # sub-request, so executor bookkeeping keyed to the old identity
        # (the simulator's per-chunk transfer charges) must be released
        self._moved: list[tuple[str, int, int]] = []
        self._admission: deque[FabricJob] = deque()
        self._now = 0.0
        self.stats = {"dispatched": 0, "local_dispatch": 0,
                      "steals": 0, "stolen_chunks": 0}
        # -- incremental event-heap core (docs/simulator.md) -------------
        # shells whose scheduling state mutated since their last pass;
        # schedule() reschedules only these (plus time-triggered wakes).
        # External mutations reach it through SchedulerState.on_change,
        # so the daemon's direct-state path invalidates too.
        self._dirty: set[str] = set(self.states)
        for name, st in self.states.items():
            st.on_change = (lambda nm: lambda: self._dirty.add(nm))(name)
        # per-shell earliest instant a time trigger (starvation aging /
        # tenant-starvation waiver) can change a clean shell's outcome
        self._wake: dict[str, float] = {}
        # memoized exact _backlog_ms per shell, keyed by the shell's
        # mutation version and the shared cost model's version — the
        # cached value is the recomputation's own floats, so admission
        # ECT and steal pricing stay bit-identical to a fresh walk
        self._backlog_cache: dict[str, tuple[tuple[int, int], float]] = {}
        # failed steal attempts, keyed (victim, thief) -> the state
        # fingerprint they failed under: a fruitless _steal_from is a
        # pure function of (victim version, thief version, cost version,
        # thief reservation), so until one of those moves the same scan
        # would fail again and is skipped outright
        self._steal_fail: dict[tuple[str, str],
                               tuple[int, int, int, int]] = {}
        self._cost_seen = self.cost.version
        # network occupancy version last folded into the dirty set; on
        # the uniform shim the version never moves and the check below
        # is a single always-equal compare
        self._net_seen = self.network.version
        # reference switch: treat every shell as dirty on every pass
        # (the pre-refactor reschedule-everything core; equivalence
        # property tests and the throughput bench baseline drive it)
        self.full_reschedule = False
        # observability head (repro_torch.obs.FlightRecorder.attach sets it).
        # None means detached: every hook below is a single attribute
        # test, so the default path allocates nothing and stays
        # byte-identical to the pre-recorder fabric
        self.obs = None

    @classmethod
    def from_registry(cls, registry, name: str,
                      policy: PolicyConfig | None = None) -> "Fabric":
        """Build from a registered `FabricDescriptor` (fabrics.json);
        shell speeds come from the ShellSpecs, per-pair transfer costs
        — or the link topology — from the descriptor."""
        desc = registry.fabric(name)
        net = FabricNetwork.from_topology(desc.network, desc.shells) \
            if desc.network else None
        return cls({s: registry.shell(s) for s in desc.shells},
                   registry, policy, transfer=desc.transfer_ms,
                   network=net)

    # -- queries --------------------------------------------------------------

    @property
    def names(self) -> list[str]:
        return list(self.states)

    @property
    def n_slots(self) -> int:
        return sum(st.alloc.n for st in self.states.values())

    def resolve(self, shell: str, a: Assignment) -> tuple[FabricJob, int]:
        """(job, global chunk id) for an assignment of a sub-request."""
        job, cmap = self._subs[(shell, a.rid)]
        return job, cmap[a.chunk]

    def sub(self, shell: str, rid: int):
        """(job, chunk map) for a sub-request, or None if the request was
        created directly on a shell state (legacy single-shell path)."""
        return self._subs.get((shell, rid))

    def transfer_cost(self, shell: str, rid: int) -> float:
        """Cross-shell transfer cost per chunk of a sub-request: the
        priced (victim, thief) cost if the sub-request was stolen onto
        this shell, else 0.0.  The simulator adds it to the stolen
        chunk's service time so the modeled payload movement is
        realized; the live daemon moves payloads in-process by
        reference, so there it remains a planning model."""
        return self._sub_transfer.get((shell, rid), 0.0)

    def finished(self, gid: int) -> bool:
        """Complete, rejected at admission, or failed with no chunk
        still in flight anywhere."""
        job = self.jobs[gid]
        if job.rejected or job.complete:
            return True
        if not job.failed:
            return False
        if job in self._admission:
            return False
        return all(self.states[s].requests[rid].finished
                   for s, rid in job.subs)

    def _pending(self, st: SchedulerState) -> int:
        return st.pending_chunks()

    @staticmethod
    def _hosts(st: SchedulerState, module: str) -> bool:
        """Does any of the shell's ranges host `module` resident?"""
        return any(m == module for m, _ in st.resident.values())

    def _load(self, name: str) -> float:
        """Backlog + occupancy, normalised by the shell's capacity in
        reference-speed slot equivalents (`n_slots * speed`)."""
        st = self.states[name]
        return (self._pending(st) + len(st.alloc.busy)) / (
            st.alloc.n * st.speed)

    def _min_fp(self, module: str) -> int:
        return min(self.registry.module(module).footprints)

    def est_transfer_ms(self, victim: str, thief: str,
                        payload: float = 1.0,
                        now: float | None = None,
                        bounded: bool = True) -> float:
        """Estimated cost of moving `payload` chunks victim->thief at
        `now` — what every steal / migration / dispatch gate consults.

        On the uniform shim this is the scalar per-pair lookup the old
        `_transfer_ms` did, byte-identical.  On a link topology it is
        the network's queue-aware store-and-forward walk — `inf` while
        a bounded buffer on the route is full — unless
        `PolicyConfig.congestion_aware` is off, which degrades to the
        zero-load figure (the scalar model's belief on real links: the
        baseline `benchmarks/network_contention.py` measures against).
        """
        return self.network.est_transfer_ms(
            victim, thief, payload,
            now=self._now if now is None else now,
            loaded=self.policy.congestion_aware, bounded=bounded)

    def _backlog_ms(self, name: str) -> float:
        """Estimated milliseconds of work already committed to a shell:
        queued chunks at the module's smallest footprint plus one chunk
        estimate per in-flight assignment (including its reconfiguration
        penalty, which that chunk is actually paying), at the shell's
        (decision) speed.

        Memoized on (shell mutation version, cost-model version): the
        cache returns the exact floats of the last recomputation, never
        an incrementally folded sum — float addition is not associative,
        and this estimate feeds bit-pinned placement decisions."""
        st = self.states[name]
        key = (st._version, self.cost.version)
        hit = self._backlog_cache.get(name)
        if hit is not None and hit[0] == key:
            if self.obs is not None:
                self.obs.backlog_hits += 1
            return hit[1]
        if self.obs is not None:
            self.obs.backlog_misses += 1
        total = 0.0
        for q in st.queues.values():
            for r in q:
                if r.pending > 0:
                    pend = float(r.pending)
                    if self.ckpt is not None:
                        # checkpointed victims only need their remaining
                        # fraction — a shell full of mostly-done chunks
                        # is a shorter queue than it looks
                        pend = max(0.0, pend
                                   - self.ckpt.pending_progress(r.rid))
                    total += pend * self.cost.est_chunk_ms(
                        r.module, self._min_fp(r.module), st.speed)
        for a in st.active.values():
            t = self.cost.est_chunk_ms(a.module, a.footprint,
                                       st.speed) * a.frac \
                + a.restore_ms + a.save_ms
            if a.reconfigure:
                t += self.policy.reconfig_penalty_ms
            total += t
        self._backlog_cache[name] = (key, total)
        return total

    def _job_ms(self, job: FabricJob, shell: str) -> float:
        """The job's own estimated work on a shell (min footprint)."""
        return job.n_chunks * self.cost.est_chunk_ms(
            job.module, self._min_fp(job.module),
            self.states[shell].speed)

    def _ect(self, name: str, job: FabricJob,
             backlog: Mapping[str, float] | None = None) -> float:
        """Estimated completion time of `job` if dispatched to `name`:
        the shell's committed backlog plus the job's own chunks, spread
        over the shell's slots at its speed.  This is what makes a fast
        shell with a short queue beat an idle slow one.  `backlog` is an
        optional precomputed per-shell `_backlog_ms` cache (one
        admission drain walks every queue once, not once per job)."""
        b = self._backlog_ms(name) if backlog is None else backlog[name]
        st = self.states[name]
        # a reserved slot is not capacity for this job's class: spread
        # the work over the slots its placements may actually use, so
        # dispatch stays consistent with the admission reservation
        # (sized at the fabric's clock — the shell's own may lag)
        slots = max(1, st.alloc.n
                    - st.reserve_for_class(job.priority, job.module,
                                           now=self._now))
        ect = (b + self._job_ms(job, name)) / slots
        if self.network.has_ingress:
            # an explicit "ingress" port prices arrival payload
            # movement: a shell behind a congested link finishes later
            # than its queue alone suggests.  Unbounded walk — dispatch
            # must rank shells even when every buffer is full
            ect += self.network.est_transfer_ms(
                "ingress", name, float(job.n_chunks), now=self._now,
                loaded=self.policy.congestion_aware, bounded=False)
        return ect

    # -- submission -----------------------------------------------------------

    def register_contract(self, contract: QoSContract,
                          now: float | None = None) -> None:
        """Attach (or replace) a tenant's `QoSContract`.  The first
        registration constructs the `AdmissionController`; from then on
        every `submit` is screened against all registered contracts.
        The contract's degraded module name is validated against the
        registry (rich KeyError on unknown names)."""
        if self.slo is None:
            self.slo = AdmissionController(self)
        self.slo.register(contract,
                          now=self._now if now is None else now)

    def submit(self, tenant: str, module: str, chunks,
               now: float = 0.0, priority: int = 0,
               deadline_ms: float | None = None,
               affinity: str | None = None,
               contract: QoSContract | None = None) -> FabricJob:
        """Admit a job.  `chunks` is a payload list (live mode) or a bare
        chunk count (simulation).  Dispatch to a shell happens at the
        next `schedule` call.

        `contract` registers (or refreshes) the tenant's `QoSContract`
        before screening — sugar for `register_contract` at the front
        door.  With any contract registered on the fabric, the
        `AdmissionController` screens the offered job first: a
        ``DEGRADE`` verdict transparently swaps `module` to the
        contract's degraded implementation (the offered name survives in
        `FabricJob.degraded_from`), and a ``REJECT`` verdict returns a
        job with `rejected=True` that never enters the admission queue
        — the caller reads the predicted violation off `job.verdict`.
        """
        self.registry.module(module)         # validates, nice KeyError
        if contract is not None:
            self.register_contract(contract, now=max(self._now, now))
        verdict: AdmissionVerdict | None = None
        degraded_from: str | None = None
        if self.slo is not None:
            t_adm = max(self._now, now)
            n_offered = chunks if isinstance(chunks, int) else len(chunks)
            verdict = self.slo.decide(tenant, module, n_offered, t_adm)
            if verdict.action == DEGRADE:
                # (an unknown affinity falls through to the rich
                # KeyError of the placement validation below)
                fit = self.states[affinity].alloc.n \
                    if affinity in self.states else \
                    max(st.alloc.n for st in self.states.values())
                if self._min_fp(verdict.degraded_to) <= fit:
                    degraded_from, module = module, verdict.degraded_to
                else:
                    # the degraded form can't be placed where this job
                    # must run; the offered form was already infeasible
                    verdict = AdmissionVerdict(
                        REJECT, tenant, violated=verdict.violated,
                        predicted_ms=verdict.predicted_ms,
                        reason=verdict.reason + "; degraded form does "
                        "not fit the target shell — rejected")
            if verdict.action == REJECT:
                self.slo.note_rejected(tenant, t_adm)
                gid = next(self._rid)
                job = FabricJob(gid, tenant, module, n_offered,
                                priority=priority,
                                deadline_ms=deadline_ms,
                                affinity=affinity, t_submit=now,
                                verdict=verdict, rejected=True)
                self.jobs[gid] = job
                self._now = t_adm
                if self.obs is not None:
                    self.obs.on_submit(job, self._now)
                return job
        min_fp = self._min_fp(module)
        if affinity is not None:
            if affinity not in self.states:
                raise KeyError(f"unknown shell {affinity!r} for "
                               f"affinity; fabric shells: "
                               f"{sorted(self.states)}")
            if min_fp > self.states[affinity].alloc.n:
                raise ValueError(
                    f"module {module!r} needs at least {min_fp} slots "
                    f"but shell {affinity!r} has "
                    f"{self.states[affinity].alloc.n}; the job would "
                    f"be unplaceable forever")
        elif min_fp > max(st.alloc.n for st in self.states.values()):
            raise ValueError(
                f"module {module!r} needs at least {min_fp} slots but "
                f"no shell in the fabric has that many; the job would "
                f"be unplaceable forever")
        if isinstance(chunks, int):
            n_chunks, payloads = chunks, None
        else:
            payloads = list(chunks)
            n_chunks = len(payloads)
        if self.arrivals is not None:
            # one observation per admitted job, before dispatch: the
            # predictive reservation reacts to the *offered* arrival
            # stream, independent of where the job lands
            self.arrivals.observe(
                priority, max(self._now, now),
                service_ms=self.cost.est_chunk_ms(module, min_fp),
                footprint=min_fp)
        gid = next(self._rid)
        job = FabricJob(gid, tenant, module, n_chunks, payloads,
                        priority=priority, deadline_ms=deadline_ms,
                        affinity=affinity, t_submit=now)
        self.jobs[gid] = job
        self._now = max(self._now, now)
        self._admission.append(job)
        if verdict is not None:
            job.verdict = verdict
            job.degraded_from = degraded_from
            self.slo.note_admitted(tenant, module, n_chunks, priority,
                                   self._now,
                                   degraded=degraded_from is not None)
        if self.obs is not None:
            self.obs.on_submit(job, self._now)
        return job

    def abort(self, gid: int) -> None:
        """Drop a job's unissued chunks on every shell (chunk error)."""
        job = self.jobs.get(gid)
        if job is None or job.failed:
            return
        job.failed = True
        try:
            self._admission.remove(job)       # not yet dispatched
        except ValueError:
            pass
        for shell, rid in job.subs:
            self.states[shell].abort(rid)

    # -- dispatch -------------------------------------------------------------

    def _pick_shell(self, job: FabricJob,
                    backlog: Mapping[str, float] | None = None) -> str:
        if job.affinity is not None:
            return job.affinity          # feasibility checked at submit
        # never dispatch to a shell the module's smallest footprint can
        # not fit even when empty — the job would queue there forever
        min_fp = self._min_fp(job.module)
        names = [n for n in self.names
                 if min_fp <= self.states[n].alloc.n]
        if self.policy.locality:
            resident = [n for n in names
                        if self._hosts(self.states[n], job.module)]
            if resident:
                names = resident
        order = {n: i for i, n in enumerate(self.names)}
        # estimated completion time, not raw backlog: an idle slow
        # shell loses to a busy fast one when the fast one still
        # finishes the job sooner (ties: load, then declaration order)
        return min(names, key=lambda n: (self._ect(n, job, backlog),
                                         self._load(n), order[n]))

    def _dispatch(self, job: FabricJob,
                  backlog: Mapping[str, float] | None = None) -> str:
        shell = self._pick_shell(job, backlog)
        st = self.states[shell]
        if self.policy.locality and self._hosts(st, job.module):
            self.stats["local_dispatch"] += 1
        st.submit(job.tenant, job.module, job.n_chunks,
                  payloads=job.payloads, now=job.t_submit,
                  priority=job.priority, deadline_ms=job.deadline_ms,
                  rid=job.gid)
        job.subs.append((shell, job.gid))
        self._subs[(shell, job.gid)] = (
            job, {i: i for i in range(job.n_chunks)})
        self.stats["dispatched"] += 1
        if self.obs is not None:
            self.obs.on_dispatch(job, shell, self._now)
        return shell

    # -- work stealing --------------------------------------------------------

    def _steal_from(self, victim: str, thief: str, now: float) -> int:
        """Move tail chunks of the victim shell's most-backlogged request
        onto the thief.  Returns the number of chunks moved.

        When the move has a heterogeneous price — a nonzero transfer
        cost for this pair, or unequal shell speeds — a candidate is
        skipped unless it wins: the transfer cost plus the thief's
        (speed-scaled) service time, plus the reconfiguration penalty if
        it does not already host the module, must beat the victim
        clearing its backlog locally.  With transfer 0 and equal speeds
        there is nothing to price and the gate is inert, so the
        homogeneous stealing contract is exactly the speed-blind one.
        """
        vst, tst = self.states[victim], self.states[thief]
        transfer = self.est_transfer_ms(victim, thief, now=now)
        priced = transfer > 0.0 or tst.speed != vst.speed
        # time for the victim to drain what it already has, per slot
        drain_ms = self._backlog_ms(victim) / vst.alloc.n \
            if priced or self.ckpt is not None else 0.0
        best, best_key = None, None
        # the thief's reservation and free-window count depend only on
        # (interactive-or-not, min footprint); memoize per scan so a
        # deep victim backlog costs a handful of computations, not one
        # per queued request
        win_cache: dict[tuple[bool, int], tuple[int, int]] = {}
        for q in vst.queues.values():
            for r in q:
                if r.pending <= 0:
                    continue
                entry = self._subs.get((victim, r.rid))
                if entry is None:
                    continue              # not fabric-managed: leave it
                min_fp = self._min_fp(r.module)
                if min_fp > tst.alloc.largest_free():
                    continue              # thief can't host this module
                # reserved slots are not steal targets: size the steal
                # to the windows this request's class may actually use
                # on the thief, and skip the candidate outright when
                # only reserved capacity is left over there
                ck = (r.priority >= self.policy.reserve_priority,
                      min_fp)
                if ck in win_cache:
                    reserve, n_win = win_cache[ck]
                else:
                    reserve = tst.reserve_for_class(
                        r.priority, r.module, now=now)
                    n_win = tst._n_free_ranges(
                        min_fp, within=tst.alloc.n - reserve)
                    win_cache[ck] = (reserve, n_win)
                if reserve > 0 and n_win == 0:
                    continue
                reconf_ms = 0.0 if self._hosts(tst, r.module) \
                    else self.policy.reconfig_penalty_ms
                # tail steals take pristine chunks only — checkpointed
                # ones sit at the front and move via the gated resume
                # path below, never at an unpriced tail steal
                pristine = r.pending
                if self.ckpt is not None:
                    pristine = 0
                    for c in reversed(r._chunks):
                        if self.ckpt.peek(r.rid, c) is not None:
                            break
                        pristine += 1
                if priced:
                    thief_ms = transfer + reconf_ms + \
                        self.cost.est_chunk_ms(r.module, min_fp,
                                               tst.speed)
                    tail_ok = thief_ms < drain_ms
                else:
                    tail_ok = True        # unpriced: always-steal contract
                if tail_ok and pristine > 0:
                    key = (-r.pending, r.rid, 0)
                    if best_key is None or key < best_key:
                        best, best_key = \
                            (r, entry, min_fp, "tail", n_win), key
                # checkpointed migration: the request's *front* pending
                # chunk is a preemption victim carrying a checkpoint;
                # move it (always gated, even on a homogeneous pair)
                # when restore + transfer + its remaining fraction beats
                # the victim draining its own backlog
                if self.ckpt is not None and self.ckpt_capable[thief] \
                        and r._chunks:
                    rec = self.ckpt.peek(r.rid, r._chunks[0])
                    if rec is not None:
                        move_ms = transfer + reconf_ms + \
                            self.ckpt.restore_cost_ms(
                                r.module, min_fp, tst.speed) + \
                            rec.remaining * self.cost.est_chunk_ms(
                                r.module, min_fp, tst.speed)
                        if move_ms < drain_ms:
                            key = (-r.pending, r.rid, 1)
                            if best_key is None or key < best_key:
                                best, best_key = \
                                    (r, entry, min_fp, "resume",
                                     n_win), key
        if best is None:
            return 0
        req, (job, cmap), min_fp, mode, n_win = best
        # steal what the thief can place right now: the count of free
        # aligned windows (outside any reservation the stolen class may
        # not enter) at the module's smallest footprint — raw free
        # slots over-count under fragmentation; stealing re-evaluates
        # on every event, so a deep backlog drains incrementally.  A
        # resume-steal moves exactly the one checkpointed front chunk.
        k = 1 if mode == "resume" else min(req.pending, max(1, n_win))
        # the stolen sub-request inherits the victim's aging anchor
        # (time since submit or last service), so starvation-aging
        # credit earned queueing behind the busy shell survives the move
        anchor = req.t_submit if req.t_last_served is None else \
            max(req.t_submit, req.t_last_served)
        taken = vst.steal_front(req.rid, k) if mode == "resume" \
            else vst.steal_pending(req.rid, k)
        if not taken:
            return 0
        # the taken chunks' (shell, rid, chunk) identities are retired
        # on every steal path — tail and resume alike — so executor
        # state keyed to them (per-chunk transfer charges) releases
        # exactly, including a previously-stolen chunk stolen again
        self._moved.extend((victim, req.rid, c) for c in taken)
        global_ids = [cmap[c] for c in taken]
        payloads = None if job.payloads is None else \
            [job.payloads[g] for g in global_ids]
        deadline = None if job.deadline_ms is None else \
            job.deadline_at - anchor
        sub = tst.submit(job.tenant, job.module, len(taken),
                         payloads=payloads, now=anchor,
                         priority=job.priority, deadline_ms=deadline)
        job.subs.append((thief, sub.rid))
        self._subs[(thief, sub.rid)] = (
            job, {i: g for i, g in enumerate(global_ids)})
        if self.network.active:
            # realize the move as timed link occupancy: a k-chunk batch
            # serializes store-and-forward over the route, so the
            # per-chunk realized price is the batch total split evenly
            # — under contention it exceeds the estimate the gate saw,
            # which is exactly the penalty the naive scalar model pays
            xfer = self.network.reserve(victim, thief,
                                        float(len(taken)), now)
            if xfer.total_ms > 0.0:
                self._sub_transfer[(thief, sub.rid)] = \
                    xfer.total_ms / len(taken)
            if self.obs is not None:
                self.obs.on_transfer_start(victim, thief, len(taken),
                                           xfer, now)
        elif transfer > 0.0:
            self._sub_transfer[(thief, sub.rid)] = transfer
        if self.ckpt is not None:
            # a stolen chunk's checkpoint follows it to the thief (its
            # context is part of the priced payload movement); a thief
            # without restore support drops the record instead
            for i, c in enumerate(taken):
                self.ckpt.rekey((req.rid, c), (sub.rid, i), shell=thief,
                                capable=self.ckpt_capable[thief])
        if self.obs is not None and mode == "resume":
            self.obs.on_ckpt_migrate(victim, thief, sub.rid, now)
        self.stats["steals"] += 1
        self.stats["stolen_chunks"] += len(taken)
        return len(taken)

    def _steal(self, now: float,
               placed: dict[str, set]) -> list[tuple[str, Assignment]]:
        out = []
        # victim ranking hoisted out of the thief loop: pendings only
        # change when a steal actually lands (steal_pending + the
        # thief's re-submit + its schedule call), so the ranked list is
        # rebuilt exactly then and the steal order stays byte-identical
        # to ranking from scratch per thief
        ranked: list[str] | None = None
        while True:
            moved = False
            for thief, tst in self.states.items():
                if tst.alloc.largest_free() == 0 or self._pending(tst):
                    continue              # busy, or has its own backlog
                if ranked is None:
                    ranked = sorted(
                        (n for n in self.states
                         if self._pending(self.states[n]) > 0),
                        key=lambda n: (-self._pending(self.states[n]), n))
                for victim in ranked:
                    if victim == thief:
                        continue
                    # a failed scan is pure in this fingerprint: every
                    # input _steal_from reads (victim queues + their
                    # checkpoint records, thief residency/allocation/
                    # reservation, cost estimates; `now` only through
                    # the already-sampled reservation) is covered by it.
                    # On an active link network the transfer estimate
                    # also reads link occupancy and the clock — state no
                    # shell version covers — so the cache is bypassed
                    # there (MEMO_CONTRACTS "net")
                    fp = None
                    if not self.network.active:
                        fp = (self.states[victim]._version, tst._version,
                              self.cost.version, tst._reserve_last)
                        if self._steal_fail.get((victim, thief)) == fp:
                            if self.obs is not None:
                                # counted as a probe+miss at snapshot
                                # time, never traced (see FlightRecorder)
                                self.obs.steal_fp_skips += 1
                            continue
                    taken = self._steal_from(victim, thief, now)
                    if self.obs is not None:
                        self.obs.on_steal(victim, thief, now,
                                          hit=taken > 0, chunks=taken)
                    if taken:
                        out.extend((thief, a) for a in
                                   tst.schedule(now, placed=placed[thief]))
                        moved = True
                        ranked = None
                        break
                    if fp is not None:
                        self._steal_fail[(victim, thief)] = fp
            if not moved:
                return out

    # -- scheduling -----------------------------------------------------------

    def schedule(self, now: float | None = None) \
            -> list[tuple[str, Assignment]]:
        """Dispatch admitted jobs, fill the free slots of every *dirty*
        shell, then let idle shells steal.  Returns (shell_name,
        Assignment) pairs; preemption victims are reported through
        `drain_preempted()`.

        A shell not in the dirty set is at a scheduling fixpoint: its
        last pass ran to "nothing more placeable" and nothing since has
        changed what _pick/_choose/_preempt_for would see.  Skipping it
        is therefore a byte-identical no-op elision, provided every way
        the fixpoint can break re-dirties the shell first: external
        mutations (submit/complete/abort/steal — SchedulerState.on_change),
        admission dispatch, a cost-model estimate moving (version check
        below), the effective reservation changing (sampled here every
        event, which also keeps reserve_history exact), a starvation
        boundary crossing (the wake times), or the same-pass preemption
        guard expiring (placed assignments become evictable at the next
        event).  docs/simulator.md derives the invariant."""
        now = self._now if now is None else max(self._now, now)
        self._now = now
        if sanitizer.SANITIZE:
            # every shell, every event — the *clean* shells are the ones
            # a touch-less mutation would silently corrupt (the elision
            # below would keep treating them as scheduling fixpoints)
            for st in self.states.values():
                sanitizer.check(st)
        run, self._dirty = self._dirty, set()
        if self.full_reschedule:
            run.update(self.states)
        if self.cost.version != self._cost_seen:
            # a refined estimate moves placement and steal economics on
            # every shell at once (the model is shared)
            self._cost_seen = self.cost.version
            run.update(self.states)
        if self.network.version != self._net_seen:
            # link occupancy moved (a reserve or a release): steal
            # economics and ingress-priced dispatch changed on every
            # shell at once, with no shell-local version bump to show
            # for it — the network is shared, like the cost model
            self._net_seen = self.network.version
            run.update(self.states)
        if self._admission:
            # one backlog walk for the whole drain; each dispatched
            # job's own work is folded in incrementally, which is
            # exactly what recomputing _backlog_ms would return
            backlog = {n: self._backlog_ms(n) for n in self.states}
            while self._admission:
                job = self._admission.popleft()
                if not job.failed:
                    shell = self._dispatch(job, backlog)
                    backlog[shell] += self._job_ms(job, shell)
                    run.add(shell)
        for name, st in self.states.items():
            # the reschedule-everything core advanced every shell's
            # clock and sampled its reservation on every pass; both are
            # per-event effects, not per-dirty-shell effects
            st._now = max(st._now, now)
            if name in run:
                continue
            prev = st._reserve_last
            if st.sample_reserve(now) != prev:
                run.add(name)             # reservation moved: re-place
            elif now >= self._wake.get(name, float("-inf")):
                run.add(name)             # aging/starvation boundary
        # one placed-set per shell for the whole pass: an assignment
        # issued here must not be preempted by a later steal-path
        # schedule call at the same instant (same-pass churn guard)
        placed: dict[str, set] = {name: set() for name in self.states}
        out = [(name, a) for name, st in self.states.items()
               if name in run
               for a in st.schedule(now, placed=placed[name])]
        if self.policy.steal and self.policy.elastic \
                and len(self.states) > 1 and run:
            # with no shell rescheduled, nothing a steal gate reads has
            # changed since the last pass ended with "no steal lands"
            out.extend(self._steal(now, placed))
        for name, st in self.states.items():
            if name in run:
                self._wake[name] = st.next_wake(now)
            if placed[name] and self.policy.preemptive \
                    and st.pending_chunks() > 0:
                # assignments issued this pass were preemption-exempt
                # (same-pass churn guard); at the next event they are
                # fair game, so the still-backlogged shell must re-run
                self._dirty.add(name)
        if self.obs is not None:
            self.obs.on_pass(now, run, len(self.states), out)
        return out

    def complete(self, shell: str, a: Assignment,
                 now: float = 0.0) -> bool:
        """Record a finished chunk.  False when the assignment was
        preempted first (stale — the executor discards the result)."""
        st = self.states[shell]
        if not st.complete(a, now=now):
            return False
        self._now = max(self._now, now)
        if self.obs is not None:
            self.obs.on_complete(shell, a, st.requests[a.rid].tenant, now)
        if st.requests[a.rid].finished:
            # a drained stolen sub-request schedules no more chunks;
            # release its transfer-price record (long-daemon hygiene)
            self._sub_transfer.pop((shell, a.rid), None)
        entry = self._subs.get((shell, a.rid))
        if entry is not None:
            job, _ = entry
            job.done += 1
            if job.complete and job.t_finish is None:
                job.t_finish = now
                if self.slo is not None:
                    # score the finished job against its contract's
                    # deadline (attainment accounting; no-op for
                    # non-contract tenants)
                    self.slo.record_completion(
                        job.tenant, now - job.t_submit,
                        job.deadline_ms, now)
        return True

    def drain_moved(self) -> list[tuple[str, int, int]]:
        """Chunk identities retired by steals since the last drain —
        the chunk now lives under a thief sub-request, so executor
        bookkeeping keyed to `(shell, rid, chunk)` must be released."""
        out, self._moved = self._moved, []
        return out

    def drain_preempted(self) -> list[tuple[str, Assignment]]:
        """Victim assignments since the last drain, tagged by shell; the
        executor must cancel them (chunks are already requeued)."""
        out = [(name, a) for name, st in self.states.items()
               for a in st.drain_preempted()]
        if self.obs is not None and out:
            self.obs.on_preempted(out, self._now)
        return out
