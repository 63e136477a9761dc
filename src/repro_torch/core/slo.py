"""SLO-aware admission control: per-tenant QoS contracts.

Under overload the fabric's default contract is "admit everything": the
global admission queue grows without bound and every tenant's deadline
collapses at once — the failure mode THEMIS (Karabulut et al., 2024)
frames for multi-tenant FPGA arbitration, and the one the per-tenant
isolation contract of Mandebi Mbongue et al. (2020) exists to prevent.
This module adds the missing subsystem: tenants may attach a
`QoSContract` (a declared arrival rate, a deadline at a percentile, and
optionally a *degraded mode* naming a cheaper registered module — the
analogue of a smaller / lower-fidelity bitstream tier of the same
accelerator), and every `Fabric.submit` is then screened by an
`AdmissionController` that predicts whether admitting the job keeps
**every registered contract** feasible.  The verdict is structured:

  - ``ADMIT``   — every contract stays feasible with the job included;
  - ``DEGRADE`` — the job as offered would break a contract, but the
    submitting tenant's own degraded mode fits: the job is transparently
    swapped to the cheaper module (`FabricJob.degraded_from` records the
    original);
  - ``REJECT``  — no feasible form exists; the verdict carries the
    predicted violation (which contract, predicted vs target) as the
    reason, so shedding is *predictable* instead of every deadline
    failing at once.

Feasibility model (Little's law over the fabric's committed state; all
quantities are reference-speed milliseconds, `CostModel` units):

  capacity   = sum over shells of n_slots * speed      [slot-ms per ms]
  backlog    = sum over shells of _backlog_ms * speed  [slot-ms]
               (the fabric's memoized per-shell estimate: queued chunks
               plus in-flight work, exactly what dispatch ECT uses)
  rho        = contract load + background load, where each contract
               contributes declared_rate x EWMA job slot-ms (its
               *protected* share, staleness-decayed once the tenant
               stops offering — `ArrivalEstimator.STALE_FACTOR`
               semantics) and the background is an `ArrivalEstimator`
               over non-contract admitted arrivals (one observation per
               admitted job, service = the whole job's slot-ms); a
               background class only counts once it has `MIN_CLASS_OBS`
               arrivals — before that its work is priced through the
               backlog term alone
  wait       = (backlog + candidate work) / capacity / (1 - rho)
               — the queue drain time, inflated by the predicted
               steady-state congestion; rho >= admission_rho_max is
               outright infeasible (the denominator would predict an
               unbounded queue)
  pred(c)    = (wait + reconfig_penalty + service(c)) * tail(percentile)

with `tail(p) = max(1, -ln(1 - p))` — the exponential-tail percentile
inflation (p95 ~ 3x the mean, p99 ~ 4.6x).  A contract is feasible iff
`pred(c) <= c.deadline_ms`.  The check runs against every registered
contract, the submitting tenant's own included, with the candidate
job's work folded into the backlog term — so one tenant's burst is
rejected (or degraded) the moment it would push *anyone's* predicted
percentile past their target, not after the queue has already sunk
every deadline.

Attainment accounting: the controller counts submitted / admitted /
degraded / rejected per tenant, and for contract tenants scores every
completion against its deadline (the job's own `deadline_ms`, defaulted
to the contract's), keeping a bounded attainment history
`[(t_ms, hit_fraction), ...]`.  `SimResult.slo` and `Daemon.slo_stats`
surface the same snapshot.

Everything here is opt-in: a fabric with no registered contract never
constructs a controller, and the no-contract path is byte-identical to
the pre-SLO scheduling contract (pinned by the golden corpus and a
property test in tests/test_slo.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING

from repro_torch.core.arrivals import ArrivalEstimator, STALE_FACTOR

if TYPE_CHECKING:                                  # pragma: no cover
    from repro_torch.core.fabric import Fabric

ADMIT = "ADMIT"
DEGRADE = "DEGRADE"
REJECT = "REJECT"

# "every priority class" sentinel for ArrivalEstimator.demand_slots:
# with no class below it, blocking_ms is 0 and the demand collapses to
# sum(rate * service * footprint) — exactly the background load term
_ALL_CLASSES = -(1 << 30)

# bounded per-tenant attainment history (long-daemon hygiene)
HISTORY_MAX = 512

# a background class needs this many arrivals before its estimated rate
# counts toward the utilisation check: live submits land back to back
# (microsecond gaps), and an EWMA seeded by one such pair would read as
# thousands of jobs per second and veto every tenant until staleness
# decays it.  Work those first arrivals actually offered is still fully
# counted — it sits in the backlog term.
MIN_CLASS_OBS = 4


class AdmissionRejected(RuntimeError):
    """A submit was rejected by admission control; carries the verdict."""

    def __init__(self, verdict: "AdmissionVerdict"):
        super().__init__(verdict.reason)
        self.verdict = verdict


@dataclasses.dataclass(frozen=True)
class QoSContract:
    """One tenant's service-level contract.

    `rate_per_s` is the *declared* arrival rate the fabric protects
    capacity for (jobs per second); `deadline_ms` is the per-job latency
    target at `percentile`.  `degraded` optionally names a cheaper
    registered module — the degraded implementation tier of the
    tenant's accelerator — that ``DEGRADE`` verdicts transparently swap
    the job to; it is validated against the registry when the contract
    is registered (unknown names raise the registry's rich KeyError).
    """
    tenant: str
    rate_per_s: float
    deadline_ms: float
    percentile: float = 0.95
    degraded: str | None = None

    def __post_init__(self):
        if self.rate_per_s <= 0.0:
            raise ValueError(f"contract rate_per_s must be positive, "
                             f"got {self.rate_per_s}")
        if self.deadline_ms <= 0.0:
            raise ValueError(f"contract deadline_ms must be positive, "
                             f"got {self.deadline_ms}")
        if not 0.0 < self.percentile < 1.0:
            raise ValueError(f"contract percentile must be in (0, 1), "
                             f"got {self.percentile}")

    @property
    def ia_ms(self) -> float:
        """Declared inter-arrival in scheduler milliseconds."""
        return 1000.0 / self.rate_per_s

    @property
    def tail_factor(self) -> float:
        """Exponential-tail inflation from mean to `percentile`."""
        return max(1.0, -math.log(1.0 - self.percentile))


@dataclasses.dataclass(frozen=True)
class AdmissionVerdict:
    """Structured outcome of one admission decision."""
    action: str                         # ADMIT | DEGRADE | REJECT
    tenant: str                         # submitting tenant
    reason: str = ""                    # predicted violation (non-ADMIT)
    predicted_ms: float | None = None   # percentile latency that decided
    violated: str | None = None         # contract tenant predicted broken
    degraded_to: str | None = None      # module a DEGRADE swapped to


@dataclasses.dataclass
class _TenantLoad:
    """Per-contract-tenant load state: the declared-rate share is held
    while the tenant keeps offering work and staleness-decays once it
    stops (same STALE_FACTOR contract as the arrival estimator)."""
    last_t: float                       # most recent offered arrival
    slot_ms: float = 0.0                # EWMA slot-ms per admitted job
    serial_ms: float = 0.0              # EWMA serial service ms per job


class AdmissionController:
    """Contract screening at `Fabric.submit` (see module docstring).

    Owns its own estimators — the fabric's adaptive-reservation
    `ArrivalEstimator` (when present) keeps observing every arrival
    exactly as before, so reservation sizing is untouched by admission
    control; mixing the two would double-count contract tenants.
    """

    def __init__(self, fabric: "Fabric"):
        self.fabric = fabric
        self.registry = fabric.registry
        self.policy = fabric.policy
        self.contracts: dict[str, QoSContract] = {}
        self._load: dict[str, _TenantLoad] = {}
        # non-contract admitted arrivals, by priority class; service_ms
        # carries the whole job's slot-ms (footprint folded in), so
        # demand_slots(_ALL_CLASSES) returns the background load directly
        self.bg = ArrivalEstimator(self.policy.admission_alpha)
        self.counts: dict[str, dict[str, int]] = {}
        self.history: dict[str, list[tuple[float, float]]] = {}

    # -- registration ---------------------------------------------------------

    def register(self, contract: QoSContract, now: float = 0.0) -> None:
        """Register (or replace) a tenant's contract.  The degraded
        module name is validated against the registry — unknown names
        raise the registry's rich KeyError, like `Registry.shell()`."""
        if contract.degraded is not None:
            self.registry.module(contract.degraded)
        prev = self._load.get(contract.tenant)
        self.contracts[contract.tenant] = contract
        if prev is None:
            # the share anchors at registration: a contract that never
            # submits decays off within a few declared inter-arrivals
            self._load[contract.tenant] = _TenantLoad(last_t=now)

    # -- load model -----------------------------------------------------------

    def _capacity(self) -> float:
        """Fabric capacity in reference-speed slot-ms per ms, at the
        shells' *decision* speeds (what placement ECT plans with)."""
        return sum(st.alloc.n * st.speed
                   for st in self.fabric.states.values())

    def _backlog_ref(self) -> float:
        """Committed work across the fabric in reference slot-ms —
        the memoized per-shell `_backlog_ms` estimates, de-normalised
        back to reference speed."""
        return sum(self.fabric._backlog_ms(name) * st.speed
                   for name, st in self.fabric.states.items())

    def _contract_rate(self, tenant: str, now: float) -> float:
        """Declared arrival rate [1/ms], staleness-decayed once the
        tenant stops offering: 1 / max(declared ia, gap/STALE_FACTOR)."""
        c = self.contracts[tenant]
        gap = max(0.0, now - self._load[tenant].last_t)
        return 1.0 / max(c.ia_ms, gap / STALE_FACTOR, 1e-6)

    def _rho(self, now: float) -> float:
        """Predicted steady-state utilisation of the offered streams:
        every contract's protected share plus the observed background."""
        cap = self._capacity()
        if cap <= 0.0:
            return float("inf")
        load = self.bg.demand_slots(_ALL_CLASSES, now,
                                    min_obs=MIN_CLASS_OBS)
        for tenant in self.contracts:
            load += self._contract_rate(tenant, now) * \
                self._load[tenant].slot_ms
        return load / cap

    def _job_cost(self, module: str, n_chunks: int) -> tuple[float, float]:
        """(slot-ms of work, serial service ms) of one job of `module`
        at its smallest footprint, reference speed."""
        fp = min(self.registry.module(module).footprints)
        est = self.fabric.cost.est_chunk_ms(module, fp)
        return n_chunks * est * fp, n_chunks * est

    # -- the decision ---------------------------------------------------------

    def _first_violation(self, tenant: str, cand_slot_ms: float,
                         cand_serial_ms: float, now: float) \
            -> tuple[QoSContract, float] | None:
        """The first registered contract whose predicted percentile
        latency exceeds its deadline with the candidate job folded in
        (registration order — deterministic), or None if all hold."""
        rho = self._rho(now)
        if rho >= self.policy.admission_rho_max:
            # the queue would grow without bound: every finite deadline
            # is infeasible, report against the first contract
            c = next(iter(self.contracts.values()))
            return c, float("inf")
        cap = self._capacity()
        wait = (self._backlog_ref() + cand_slot_ms) / cap / (1.0 - rho)
        for c in self.contracts.values():
            if c.tenant != tenant \
                    and self._load[c.tenant].slot_ms == 0.0:
                # no admitted stream yet: there is nothing to protect,
                # and an idle contract (possibly one no fabric could
                # ever meet) must not veto other tenants' admission —
                # its share anchors on its own first admitted job,
                # while its own submits are always screened
                continue
            svc = cand_serial_ms if c.tenant == tenant \
                else self._load[c.tenant].serial_ms
            pred = (wait + self.policy.reconfig_penalty_ms + svc) \
                * c.tail_factor
            if pred > c.deadline_ms:
                return c, pred
        return None

    def decide(self, tenant: str, module: str, n_chunks: int,
               now: float) -> AdmissionVerdict:
        """Screen one offered job.  Does not mutate load state — the
        fabric reports the outcome back through `note_admitted` /
        `note_rejected` so only work that actually enters the system
        shapes future predictions."""
        slot_ms, serial_ms = self._job_cost(module, n_chunks)
        hit = self._first_violation(tenant, slot_ms, serial_ms, now)
        if hit is None:
            return AdmissionVerdict(ADMIT, tenant)
        mine = self.contracts.get(tenant)
        if mine is not None and mine.degraded is not None \
                and mine.degraded != module:
            d_slot, d_serial = self._job_cost(mine.degraded, n_chunks)
            if self._first_violation(tenant, d_slot, d_serial,
                                     now) is None:
                c, pred = hit
                return AdmissionVerdict(
                    DEGRADE, tenant, degraded_to=mine.degraded,
                    predicted_ms=pred, violated=c.tenant,
                    reason=(f"as offered, contract {c.tenant!r} "
                            f"predicts p{c.percentile * 100:g} "
                            f"{pred:.1f} ms > {c.deadline_ms:g} ms; "
                            f"degraded to {mine.degraded!r}"))
        c, pred = hit
        return AdmissionVerdict(
            REJECT, tenant, predicted_ms=pred, violated=c.tenant,
            reason=(f"admitting would break contract {c.tenant!r}: "
                    f"predicted p{c.percentile * 100:g} latency "
                    f"{pred:.1f} ms > deadline {c.deadline_ms:g} ms "
                    f"(offered utilisation "
                    f"{min(self._rho(now), 99.0):.2f})"))

    # -- outcome accounting ---------------------------------------------------

    def _counts(self, tenant: str) -> dict[str, int]:
        c = self.counts.get(tenant)
        if c is None:
            c = self.counts[tenant] = {
                "submitted": 0, "admitted": 0, "degraded": 0,
                "rejected": 0, "completed": 0, "hits": 0, "misses": 0}
        return c

    def note_admitted(self, tenant: str, module: str, n_chunks: int,
                      priority: int, now: float,
                      degraded: bool = False) -> None:
        """An offered job entered the system (possibly degraded)."""
        cnt = self._counts(tenant)
        cnt["submitted"] += 1
        cnt["degraded" if degraded else "admitted"] += 1
        slot_ms, serial_ms = self._job_cost(module, n_chunks)
        load = self._load.get(tenant)
        if load is not None:              # contract tenant
            a = self.policy.admission_alpha
            load.last_t = max(load.last_t, now)
            load.slot_ms = slot_ms if load.slot_ms == 0.0 \
                else a * slot_ms + (1.0 - a) * load.slot_ms
            load.serial_ms = serial_ms if load.serial_ms == 0.0 \
                else a * serial_ms + (1.0 - a) * load.serial_ms
        else:
            self.bg.observe(priority, now, service_ms=slot_ms)

    def note_rejected(self, tenant: str, now: float) -> None:
        """An offered job was shed.  A contract tenant's offered stream
        keeps its protected share alive (that is what the contract
        buys); rejected background work shapes nothing."""
        cnt = self._counts(tenant)
        cnt["submitted"] += 1
        cnt["rejected"] += 1
        load = self._load.get(tenant)
        if load is not None:
            load.last_t = max(load.last_t, now)

    def record_completion(self, tenant: str, latency_ms: float,
                          deadline_ms: float | None, now: float) -> None:
        """Score a finished job of a contract tenant against its
        deadline and extend the attainment history."""
        if tenant not in self.contracts:
            return
        cnt = self._counts(tenant)
        cnt["completed"] += 1
        dl = self.contracts[tenant].deadline_ms \
            if deadline_ms is None else deadline_ms
        if latency_ms <= dl + 1e-9:
            cnt["hits"] += 1
        else:
            cnt["misses"] += 1
        hist = self.history.setdefault(tenant, [])
        hist.append((now, cnt["hits"] / cnt["completed"]))
        if len(hist) > HISTORY_MAX:
            del hist[:len(hist) - HISTORY_MAX]

    # -- reporting ------------------------------------------------------------

    def attainment(self) -> dict[str, dict]:
        """Per-tenant SLO snapshot: verdict counts, deadline-hit
        fraction among completed jobs (contract tenants), and the
        bounded attainment history."""
        out: dict[str, dict] = {}
        for tenant in sorted(set(self.counts) | set(self.contracts)):
            cnt = dict(self._counts(tenant))
            entry: dict = dict(cnt)
            entry["contract"] = tenant in self.contracts
            entry["attainment"] = (cnt["hits"] / cnt["completed"]
                                   if cnt["completed"] else None)
            entry["history"] = [list(h)
                                for h in self.history.get(tenant, [])]
            out[tenant] = entry
        return out

    def totals(self) -> dict[str, int]:
        """Verdict/outcome counters summed across every tenant — the
        flat gauge surface the flight recorder (repro_torch.obs) samples.
        Conservation holds by construction (and is property-tested):
        ``admitted + degraded + rejected == submitted``."""
        out = {"submitted": 0, "admitted": 0, "degraded": 0,
               "rejected": 0, "completed": 0, "hits": 0, "misses": 0}
        for cnt in self.counts.values():
            for k in out:
                out[k] += cnt[k]
        return out
