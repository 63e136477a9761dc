"""Online arrival-rate estimation for predictive reservation.

The steal-aware admission (`PolicyConfig.reserve_slots`) holds back
the last N slots of every shell for the interactive class — but N is a
static knob the operator must guess per trace, and the right value
drifts with the interactive arrival rate: too small and bursts queue
behind batch chunks, too large and reserved capacity idles.  THEMIS
(Karabulut et al., 2024) makes the same point for fair multi-tenant FPGA
scheduling — arbitration parameters must track the observed workload,
not a config file — and Mandebi Mbongue et al. (2020) motivate why
cloud multi-tenancy cannot assume a known tenant mix.

`ArrivalEstimator` is the feedback loop's sensor: an EWMA of
inter-arrival times, expected service and footprint **per priority
class**, observed once per job at admission (`Fabric.submit`; a bare
`SchedulerState` observes its own direct submits).  Stolen sub-request
re-submits are placement moves, not arrivals, and are never observed.

`demand_slots` turns the per-class rates into a Little's-law
concurrency estimate.  The reservation exists to cover interactive
demand over the window during which capacity cannot be created on
demand: without a free slot, an arrival waits for the resident batch
chunk to drain, then pays reconfiguration, then its own service.  So
for every class at or above the reservation priority,

    demand += rate [1/ms]
              x ((blocking_ms + service_ms) / speed + overhead_ms)
              x footprint

where `blocking_ms` is the largest expected chunk time among the
*non*-interactive classes (the capacity-creation latency on a
saturated shell; 0 when no batch work has been observed, leaving only
the burst's own service + reconfiguration in the horizon) and
`overhead_ms` is the caller's reconfiguration penalty.  The scheduler rounds and clamps the
sum to `[0, PolicyConfig.reserve_slots_max]` every scheduling pass
(`SchedulerState.effective_reserve`), replacing the static count when
`PolicyConfig.reserve_mode == "adaptive"`.

Staleness: a rate estimated from an EWMA alone would predict a burst
forever after the burst ends.  Queries therefore degrade the rate once
the gap since the class's last arrival grows well past its EWMA
inter-arrival (`STALE_FACTOR`): the effective inter-arrival is
`max(ewma, gap / STALE_FACTOR)`, so a class that stops arriving decays
to rate 0 — and a shell's adaptive reservation back to 0 — within a
handful of expected inter-arrivals, while ordinary exponential gaps
inside an active stream do not flap the reservation.
"""
from __future__ import annotations

import dataclasses

# a class's rate starts degrading once the gap since its last arrival
# exceeds STALE_FACTOR expected inter-arrivals: large enough that the
# long tail of an exponential arrival process (P[gap > 6*mean] ~ 0.25%)
# practically never flaps an active stream's reservation mid-gap, small
# enough that a stream that stops frees the reserved capacity within a
# few expected inter-arrivals
STALE_FACTOR = 6.0

# schedlint memo contract (analysis/memo.py): the demand memo is keyed
# on the query instant and the observation version (plus the argument
# tuple), so it may read the whole per-class EWMA surface and the clock
# but nothing of any shell's scheduling state.
MEMO_CONTRACTS = (
    {"name": "demand_slots",
     "func": "ArrivalEstimator.demand_slots",
     "cache": "_demand",
     "key": ("arrivals", "now", "args"),
     "folded": {}},
)


@dataclasses.dataclass
class ClassStats:
    """Per-priority-class EWMA state (one arrival seen at minimum)."""
    last_t: float                   # most recent arrival (ms)
    ia_ms: float | None = None      # EWMA inter-arrival; None until 2nd
    service_ms: float = 0.0         # EWMA per-chunk service estimate
    footprint: float = 1.0          # EWMA slots per placement
    n: int = 1                      # arrivals observed


class ArrivalEstimator:
    """EWMA arrival model per priority class, shared fabric-wide.

    `observe` is called once per admitted job; `demand_slots` is the
    predictive-reservation query.  All times are scheduler milliseconds
    (virtual in the simulator, `perf_counter * 1e3` in the daemon).
    """

    def __init__(self, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"arrival_alpha must be in (0, 1], "
                             f"got {alpha}")
        self.alpha = float(alpha)
        self._classes: dict[int, ClassStats] = {}
        # demand_slots memo: the estimate is queried once per shell per
        # event (reservation sampling, dispatch ECT, steal sizing) but
        # only moves when the clock or an observation does
        self._version = 0
        self._demand_at: tuple[float, int] | None = None
        self._demand: dict[tuple[int, float, float, int], float] = {}

    def observe(self, priority: int, now: float,
                service_ms: float = 0.0, footprint: int = 1) -> None:
        """Record one arrival of `priority` class at `now`.

        `service_ms` is the cost model's speed-normalised per-chunk
        estimate for the submitted module at its smallest footprint —
        the reservation predicts slot *occupancy*, so the estimate
        rides along with the arrival clock.
        """
        self._version += 1
        c = self._classes.get(priority)
        if c is None:
            self._classes[priority] = ClassStats(
                last_t=now, service_ms=float(service_ms),
                footprint=float(footprint))
            return
        a = self.alpha
        dt = max(0.0, now - c.last_t)
        c.ia_ms = dt if c.ia_ms is None else a * dt + (1.0 - a) * c.ia_ms
        c.last_t = max(c.last_t, now)
        c.service_ms = a * service_ms + (1.0 - a) * c.service_ms
        c.footprint = a * footprint + (1.0 - a) * c.footprint
        c.n += 1

    # -- queries --------------------------------------------------------------

    def interarrival_ms(self, priority: int) -> float | None:
        """EWMA inter-arrival of one class (None before two arrivals)."""
        c = self._classes.get(priority)
        return None if c is None else c.ia_ms

    def rate_per_ms(self, priority: int, now: float) -> float:
        """Staleness-aware arrival rate of one class (0.0 when unknown)."""
        c = self._classes.get(priority)
        if c is None or c.ia_ms is None:
            return 0.0
        gap = max(0.0, now - c.last_t)
        ia = max(c.ia_ms, gap / STALE_FACTOR, 1e-6)
        return 1.0 / ia

    def blocking_ms(self, min_priority: int) -> float:
        """Largest expected chunk time among classes *below*
        `min_priority` — how long an interactive arrival would wait for
        a saturated shell to free a slot (0.0 when no batch work has
        been observed: only the burst's own service + overhead remain
        in the demand horizon)."""
        return max((c.service_ms for p, c in self._classes.items()
                    if p < min_priority), default=0.0)

    def demand_slots(self, min_priority: int, now: float,
                     overhead_ms: float = 0.0,
                     speed: float = 1.0, min_obs: int = 0) -> float:
        """Little's-law slot concurrency of classes >= `min_priority`:
        sum of rate x ((blocking + service) / speed + overhead) x
        footprint — each predicted arrival occupies provisioned
        capacity for the full window it would otherwise wait through
        (batch residual, then reconfiguration, then its own service).
        The caller passes the shell's reconfiguration penalty as
        `overhead_ms` and its decision speed.

        `min_obs` excludes classes with fewer arrivals: an EWMA seeded
        by one back-to-back pair (wall-clock submits land microseconds
        apart) reads as an absurd sustained rate, and callers whose
        query treats the result as steady-state load (the admission
        controller's utilisation check) need a few inter-arrival
        samples of evidence first.  The reservation path keeps the
        default 0 — over-reserving for one burst is self-correcting,
        turning away tenants is not.

        Memoized per (now, observation version): one computation serves
        every same-instant query (per-shell reservation sampling,
        dispatch ECT, steal sizing), returning the identical floats."""
        if self._demand_at != (now, self._version):
            self._demand_at = (now, self._version)
            self._demand = {}
        key = (min_priority, overhead_ms, speed, min_obs)
        hit = self._demand.get(key)
        if hit is not None:
            return hit
        blocking = self.blocking_ms(min_priority)
        total = 0.0
        for p, c in self._classes.items():
            if p < min_priority or c.n < min_obs:
                continue
            rate = self.rate_per_ms(p, now)
            if rate <= 0.0:
                continue
            total += rate * ((blocking + c.service_ms) / speed
                             + overhead_ms) * c.footprint
        self._demand[key] = total
        return total
