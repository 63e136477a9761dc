"""FOS daemon: multi-tenant acceleration service (paper section 4.4.1).

The paper uses gRPC + shared memory; in this single-host container the
daemon is in-process with a serialisable request boundary (a real RPC
front-end bolts onto `submit` unchanged) and zero-copy array handoff.

Execution model: the daemon is a thin executor over a `Fabric` — a named
collection of shells, each with its own `SchedulerState`, behind one
scheduling contract (core/fabric.py).  A scheduler thread drives
`Fabric.schedule` on every event; each (shell, assignment) runs on its
shell's slots through one shared worker pool (each slot runs on its own
CUDA stream, so distinct slots execute concurrently).  Construct with
a single `Shell` for the seed single-shell behavior, or with a
`{name: Shell}` mapping for multi-shell execution with locality-aware
placement and cross-shell work stealing.

Preemption (PolicyConfig.preemptive): when the policy evicts an in-flight
chunk, the daemon cancels the victim assignment — if its worker has not
started, it is skipped outright; if it is mid-dispatch, its result is
discarded on completion (the FPGA analogue: reconfiguring a PR region
kills the resident accelerator's partial work).  Either way the scheduler
has already requeued the chunk, so it re-runs under a fresh assignment and
the request's future still resolves with every chunk exactly once.

Checkpointing (PolicyConfig.ckpt): the daemon mirrors the scheduling
contract on its wall-clock path — evictions record wall-clock progress
estimates, resumed assignments are priced at their remaining fraction
plus restore, checkpointed chunks migrate across live shells with their
records, and `daemon.ckpt_stats` surfaces the saves/restores/migrations
counters.  The physical analogue stops at the model boundary: an
in-process computation cannot restore partial context, so a resumed
chunk re-runs in full (a real FPGA backend would read back and restore
the PR region state); the scheduler's decisions and accounting are
checkpoint-aware either way.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

from repro_torch.core import bus
from repro_torch.core.fabric import Fabric
from repro_torch.core.module import AccelModule, Placement, run_placement
from repro_torch.core.registry import Registry
from repro_torch.core.scheduler import Assignment, PolicyConfig, SchedulerState
from repro_torch.core.shell import Shell
from repro_torch.core.slo import AdmissionRejected, QoSContract


def _now_ms() -> float:
    """Scheduler clock: milliseconds (matches the cost model's units).

    Every daemon timestamp — `JobHandle.t_submit` included — uses this
    clock, so handle and scheduler times subtract directly.
    """
    return time.perf_counter() * 1e3


@dataclasses.dataclass
class JobHandle:
    rid: int
    future: Future          # resolves to list of chunk outputs
    t_submit: float         # _now_ms() — same clock as the scheduler
    priority: int = 0
    deadline_ms: float | None = None


class Daemon:
    def __init__(self, shell, registry: Registry,
                 policy: PolicyConfig | None = None, max_workers: int = 8,
                 obs=None):
        """`shell`: a `Shell` (single-shell, seed behavior) or an ordered
        `{name: Shell}` mapping (multi-shell fabric).

        `obs`: an optional flight recorder to attach to the fabric
        (duck-typed — the daemon never imports one; the port's `obs`
        package waits for ROADMAP A14).  Its event timestamps then run
        on the daemon's wall clock."""
        if isinstance(shell, dict):
            self.shells: dict[str, Shell] = dict(shell)
        else:
            self.shells = {shell.spec.name: shell}
        self.shell = next(iter(self.shells.values()))
        self.registry = registry
        # the ShellSpec carries the shell's slot count AND its relative
        # speed, so a heterogeneous {name: Shell} fabric gets
        # speed-aware placement for free
        self.fabric = Fabric(
            {name: s.spec for name, s in self.shells.items()},
            registry, policy)
        if obs is not None:
            obs.attach(self.fabric)
        self._modules: dict[str, AccelModule] = {}
        self._placements: dict[tuple[str, int, int], Placement] = {}
        self._events: queue.Queue = queue.Queue()
        # reentrant: `metrics` (and its ckpt_stats/slo_stats/
        # reserve_history aliases) snapshots under this lock, and
        # callers driving the scheduler state directly may already
        # hold it when they read stats
        self._lock = threading.RLock()
        self._results: dict[int, list] = {}
        self._handles: dict[int, JobHandle] = {}
        self._cancelled: set[int] = set()     # aids of preempted assignments
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.stats = {"reconfigurations": 0, "reuses": 0, "chunks": 0,
                      "preemptions": 0, "sched_ns": 0, "sched_calls": 0}
        self._thread.start()

    @property
    def state(self) -> SchedulerState:
        """The first shell's scheduler state (the whole story for the
        degenerate single-shell daemon; one shard of a bigger fabric)."""
        return next(iter(self.fabric.states.values()))

    @property
    def policy(self) -> PolicyConfig:
        return self.fabric.policy

    @property
    def metrics(self) -> dict:
        """The daemon's one metrics surface, snapshotted under the
        scheduler lock so every block is from the same instant:

        - ``daemon``: executor counters (reconfigurations, reuses,
          chunks, preemptions, scheduling-pass timing);
        - ``ckpt``: checkpoint counters when `PolicyConfig.ckpt` is on;
        - ``slo``: per-tenant SLO attainment once any `QoSContract` is
          registered;
        - ``reserve_history``: per-shell effective-reservation trace
          `[(t_ms, slots), ...]` recorded on change;
        - ``obs``: the `FlightRecorder.snapshot()` payload when a
          recorder was passed at construction (absent otherwise).

        `ckpt_stats`/`slo_stats`/`reserve_history` are thin aliases of
        the corresponding blocks."""
        with self._lock:
            fab = self.fabric
            m = {
                "daemon": dict(self.stats),
                "ckpt": (dict(fab.ckpt.stats)
                         if fab.ckpt is not None else {}),
                "slo": (fab.slo.attainment()
                        if fab.slo is not None else {}),
                "reserve_history": {
                    name: list(st.reserve_history)
                    for name, st in fab.states.items()},
            }
            if fab.obs is not None:
                m["obs"] = fab.obs.snapshot()
            return m

    @property
    def ckpt_stats(self) -> dict:
        """Checkpoint counters (saves/restores/migrations/dropped) when
        `PolicyConfig.ckpt` is on; `{}` otherwise.  Thin alias of
        ``metrics["ckpt"]``."""
        return self.metrics["ckpt"]

    @property
    def slo_stats(self) -> dict:
        """Per-tenant SLO attainment snapshot (verdict counts,
        deadline-hit fraction, attainment history) once any
        `QoSContract` is registered; `{}` otherwise.  Thin alias of
        ``metrics["slo"]``."""
        return self.metrics["slo"]

    def register_contract(self, contract: QoSContract) -> None:
        """Attach a tenant's `QoSContract` to the fabric; every
        subsequent `submit` is screened by admission control.  Unknown
        degraded-module names raise the registry's rich KeyError."""
        with self._lock:
            self.fabric.register_contract(contract, now=_now_ms())

    @property
    def reserve_history(self) -> dict[str, list]:
        """Per-shell effective-reservation trace `[(t_ms, slots), ...]`
        recorded on change — the adaptive reservation's sizing decisions
        (`PolicyConfig.reserve_mode == "adaptive"`, fed from the wall
        clock at `submit`); static mode records its constant once.
        Thin alias of ``metrics["reserve_history"]``."""
        return self.metrics["reserve_history"]

    # -- public API (paper Listings 4/5) --------------------------------------

    def run(self, tenant: str, jobs: list[dict]) -> list[JobHandle]:
        """jobs: [{"name": <module>, "chunks": [args...],
                   "priority"?: int, "deadline_ms"?: float,
                   "affinity"?: <shell name>}] -> handles."""
        handles = []
        for j in jobs:
            handles.append(self.submit(tenant, j["name"], j["chunks"],
                                       priority=j.get("priority", 0),
                                       deadline_ms=j.get("deadline_ms"),
                                       affinity=j.get("affinity"),
                                       contract=j.get("contract")))
        return handles

    def submit(self, tenant: str, module: str, chunks: list,
               priority: int = 0, deadline_ms: float | None = None,
               affinity: str | None = None,
               contract: QoSContract | None = None) -> JobHandle:
        """Submit one job.  `contract` registers (or refreshes) the
        tenant's `QoSContract` before admission screening; when the
        fabric carries any contract, a rejected submit still returns a
        handle, but its future fails with `AdmissionRejected` carrying
        the structured verdict (the predicted contract violation)."""
        fut: Future = Future()
        with self._lock:
            now = _now_ms()
            # fabric.submit validates module/affinity (raising before
            # any state is created) and copies the chunk list
            job = self.fabric.submit(tenant, module, chunks,
                                     now=now, priority=priority,
                                     deadline_ms=deadline_ms,
                                     affinity=affinity,
                                     contract=contract)
            h = JobHandle(job.gid, fut, now,
                          priority=priority, deadline_ms=deadline_ms)
            if job.rejected:
                # shed at admission: no chunks, no results buffer, no
                # registered handle — only the failed future remains
                fut.set_exception(AdmissionRejected(job.verdict))
                return h
            self._results[job.gid] = [None] * job.n_chunks
            self._handles[job.gid] = h
        self._events.put(("submit", None))
        return h

    def shutdown(self):
        self._stop.set()
        self._events.put(("stop", None))
        self._thread.join(timeout=10)
        self._pool.shutdown(wait=True)

    # -- module management -----------------------------------------------------

    def _module(self, name: str) -> AccelModule:
        with self._lock:
            mod = self._modules.get(name)
        if mod is None:
            desc = self.registry.module(name)
            builder = desc.load_builder()
            mod = AccelModule(name, builder, desc.footprints)
            with self._lock:
                mod = self._modules.setdefault(name, mod)
        return mod

    def _placement(self, shell_name: str, a: Assignment) -> Placement:
        key = (shell_name, a.rng.start, a.rng.size)
        with self._lock:
            pl = self._placements.get(key)
            if pl is not None and pl.module.name == a.module \
                    and not a.reconfigure:
                self.stats["reuses"] += 1
                return pl
        mod = self._module(a.module)
        shell = self.shells[shell_name]
        slot = (shell.slots[a.rng.start] if a.rng.size == 1 else
                shell.merged_slot(list(a.rng.slots)))
        pl = mod.place(slot, a.footprint)
        with self._lock:
            # a preempted victim mid-dispatch must not clobber the
            # placement its preemptor just installed on the same range
            if a.aid in self.fabric.states[shell_name].active:
                self._placements[key] = pl
                self.stats["reconfigurations"] += 1
        return pl

    # -- event loop -------------------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._events.get(timeout=0.1)
            except queue.Empty:
                continue
            # drain
            try:
                while True:
                    self._events.get_nowait()
            except queue.Empty:
                pass
            with self._lock:
                t0 = time.perf_counter_ns()
                if self.fabric.network.active:
                    # mirror the simulator's "net" release events on
                    # wall clock: expired link occupancy frees before
                    # the pass, so backed-off steal estimates recover
                    now_ms = _now_ms()
                    for xfer in self.fabric.network.advance(now_ms):
                        if self.fabric.obs is not None:
                            self.fabric.obs.on_transfer_complete(
                                xfer.src, xfer.dst, now_ms)
                    self.fabric.network.drain_releases()
                assignments = self.fabric.schedule(now=_now_ms())
                # the daemon keys no per-chunk executor state to stolen
                # identities (payloads move by reference); drain the
                # retirement log so it cannot grow for a long-lived
                # daemon under heavy stealing
                self.fabric.drain_moved()
                self._handle_preempted_locked()
                self.stats["sched_ns"] += time.perf_counter_ns() - t0
                self.stats["sched_calls"] += 1
            for shell_name, a in assignments:
                self._pool.submit(self._run_assignment, shell_name, a)

    def _gid_of_locked(self, shell_name: str, rid: int) -> int:
        """Job id for a sub-request; requests created directly on a shell
        state (the legacy single-shell path) map to their own rid."""
        entry = self.fabric.sub(shell_name, rid)
        return entry[0].gid if entry is not None else rid

    def _handle_preempted_locked(self) -> None:
        for shell_name, v in self.fabric.drain_preempted():
            self._cancelled.add(v.aid)
            self.stats["preemptions"] += 1
            # a failed request whose last in-flight chunk was evicted
            # drains here rather than through complete()
            self._finalize_locked(self._gid_of_locked(shell_name, v.rid))

    def _finalize_locked(self, gid: int) -> None:
        """Release per-job state once a job has fully drained."""
        job = self.fabric.jobs.get(gid)
        if job is not None:
            if not self.fabric.finished(gid):
                return
            self._handles.pop(gid, None)
            self._results.pop(gid, None)
            # keep the job/request records (stats/queries) but release
            # the input arrays — a long-running daemon must not
            # accumulate every tenant's payloads
            job.payloads = None
            for shell_name, rid in job.subs:
                self.fabric.states[shell_name].requests[rid].payloads = None
            return
        # legacy path: the request was created directly on a shell state
        for st in self.fabric.states.values():
            req = st.requests.get(gid)
            if req is not None:
                if req.finished:
                    self._handles.pop(gid, None)
                    self._results.pop(gid, None)
                    req.payloads = None
                return

    def _run_assignment(self, shell_name: str, a: Assignment):
        with self._lock:
            if a.aid in self._cancelled:   # preempted before we started
                self._cancelled.discard(a.aid)
                self._finalize_locked(self._gid_of_locked(shell_name, a.rid))
                self._events.put(("cancelled", None))
                return
        st = self.fabric.states[shell_name]
        try:
            pl = self._placement(shell_name, a)
            req = st.requests[a.rid]
            payload = req.payloads[a.chunk]
            prog = pl.module.program(pl.slot, pl.footprint)
            args, _ = bus.adapt_inputs(
                payload if isinstance(payload, tuple) else (payload,),
                prog.abstract_inputs)
            t_run = _now_ms()
            out = run_placement(pl, *args)
            t_run = _now_ms() - t_run
            err = None
        except Exception as e:  # noqa: BLE001 - propagate to the future
            out, err, t_run = None, e, 0.0
        with self._lock:
            self._cancelled.discard(a.aid)
            entry = self.fabric.sub(shell_name, a.rid)
            if not self.fabric.complete(shell_name, a, now=_now_ms()):
                # preempted mid-dispatch: discard the partial result; the
                # chunk was requeued and re-runs under a fresh assignment
                self._finalize_locked(self._gid_of_locked(shell_name, a.rid))
                self._events.put(("discarded", None))
                return
            self.stats["chunks"] += 1
            if err is None and self.policy.refine_cost_model:
                # reconfigured chunks refine too — an always-
                # reconfiguring module must not keep a stale estimate
                # forever.  t_run wraps run_placement only, so unlike
                # the simulator's elapsed time it never contains the
                # reconfiguration cost (placement/compile happen before
                # the clock starts) and nothing is subtracted here.
                # Resumed chunks (a.frac < 1) re-run in full in-process,
                # so t_run is already a full-chunk observation — no
                # frac scaling either (unlike the simulator).
                self.fabric.cost.observe(a.module, a.footprint,
                                         max(1e-3, t_run),
                                         self.fabric.speeds[shell_name])
            if entry is not None:
                job, cmap = entry
                gid, gchunk = job.gid, cmap[a.chunk]
                complete = job.complete
            else:                           # legacy direct-state request
                job = None
                gid, gchunk = a.rid, a.chunk
                complete = st.requests[a.rid].complete
            h = self._handles.get(gid)
            if err is not None:
                # abort the rest of the job on every shell and surface the
                # error once; drop per-job buffers so a failing chunk
                # leaves no orphaned state behind
                if job is not None:
                    self.fabric.abort(gid)
                else:
                    st.abort(a.rid)
                self._results.pop(gid, None)
                if h is not None and not h.future.done():
                    h.future.set_exception(err)
            else:
                buf = self._results.get(gid)
                if buf is not None:
                    buf[gchunk] = out
                if complete and h is not None and not h.future.done():
                    h.future.set_result(self._results.pop(gid))
            self._finalize_locked(gid)
        self._events.put(("done", None))
