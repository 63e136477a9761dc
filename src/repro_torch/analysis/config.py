"""Repo-layout knowledge for schedlint (the part that is config, not
contract).

The *contracts* — which fields are tracked, which memo caches exist and
what they key on — live in the checked sources themselves as literal
constants (`scheduler.TRACKED_FIELDS`, `fabric.MEMO_CONTRACTS`, ...),
next to the code they constrain.  This module holds what does not
belong there: the coarse receiver-type map the AST engine needs to
resolve `vst.steal_pending(...)` to a `SchedulerState` summary, the
classification of every known attribute into versioned-state tokens,
and the per-module determinism allowlist.  Fixture files under
tests/fixtures/lint/ are self-contained and override all of this via
in-file `SCHEDLINT_*` declarations.
"""
from __future__ import annotations

# -- class layout -------------------------------------------------------------

STATE_CLASS = "SchedulerState"

# fallbacks when no TRACKED_FIELDS declaration is in the project (the
# real run always extracts the declaration from scheduler.py; an empty
# fallback keeps fixture projects explicit)
TRACKED_FALLBACK: tuple = ()
MUTATORS_FALLBACK: tuple = (
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "remove", "discard", "add", "update", "clear", "setdefault",
)

# receiver-class inference: bare local names conventionally holding a
# SchedulerState, and (owner-class, attr) -> class of the attribute
# (for containers: the *element* class, since the typer collapses
# subscripts/.get()/.values() onto the container's mapping)
TYPE_HINTS: dict = {
    "st": "SchedulerState",
    "vst": "SchedulerState",
    "tst": "SchedulerState",
    "state": "SchedulerState",
    ("Fabric", "states"): "SchedulerState",
    ("Fabric", "cost"): "CostModel",
    ("Fabric", "ckpt"): "CheckpointManager",
    ("Fabric", "arrivals"): "ArrivalEstimator",
    ("Fabric", "slo"): "AdmissionController",
    ("Fabric", "jobs"): "FabricJob",
    ("Fabric", "_admission"): "FabricJob",
    ("SchedulerState", "cost"): "CostModel",
    ("SchedulerState", "ckpt"): "CheckpointManager",
    ("SchedulerState", "arrivals"): "ArrivalEstimator",
    ("SchedulerState", "alloc"): "BuddyAllocator",
    ("SchedulerState", "queues"): "Request",
    ("SchedulerState", "requests"): "Request",
    ("SchedulerState", "active"): "Assignment",
    ("ArrivalEstimator", "_classes"): "ClassStats",
    ("AdmissionController", "fabric"): "Fabric",
    ("Fabric", "network"): "FabricNetwork",
    ("FabricNetwork", "_links"): "Link",
    ("FabricNetwork", "_routes"): "Link",
    ("FabricNetwork", "_active"): "Transfer",
    ("FabricNetwork", "_pending"): "Transfer",
    ("Transfer", "route"): "Link",
}

# -- versioned-state tokens (memo checker) ------------------------------------
#
# Every attribute a memoized computation may read is classified into a
# token; a memo cache's declared key must cover every token its
# computation reaches (analysis/memo.py).  Tokens:
#
#   state    — covered by SchedulerState._version (TRACKED_FIELDS plus
#              everything the mutation checker forces bumps for)
#   cost     — CostModel.version
#   arrivals — ArrivalEstimator._version
#   reserve  — the per-event reservation sample (_reserve_last), taken
#              for every shell on every fabric event (sample_reserve)
#   now      — the event clock (a `now` parameter or `_now` read)
#   tenant_service — the fabric-shared service map; moves without any
#              version, so no memo key can cover it: any read inside a
#              cached region is a finding by construction
#   net      — FabricNetwork.version: link occupancy (busy_until,
#              inflight) moved by reserve/advance; constant (version 0)
#              on the degenerate uniform topology
#
# None means "safe": static configuration, admission-time constants,
# or self-invalidating caches.
VERSIONED: dict = {
    # SchedulerState: tracked fields resolve via TRACKED_FIELDS; the
    # rest of its surface:
    ("SchedulerState", "_version"): "state",
    ("SchedulerState", "_reserve_last"): "reserve",
    ("SchedulerState", "_reserve_now"): "reserve",
    ("SchedulerState", "reserve_history"): "reserve",
    ("SchedulerState", "_now"): "now",
    ("SchedulerState", "_tenant_last_ms"): "tenant_service",
    ("SchedulerState", "_save_ms_pending"): "state",
    ("SchedulerState", "n_preemptions"): "state",
    ("SchedulerState", "_preempted"): "state",
    ("SchedulerState", "speed"): None,
    ("SchedulerState", "policy"): None,
    ("SchedulerState", "registry"): None,
    ("SchedulerState", "name"): None,
    ("SchedulerState", "ckpt_capable"): None,
    ("SchedulerState", "_observe_arrivals"): None,
    ("SchedulerState", "transfer_of"): None,
    ("SchedulerState", "on_change"): None,
    # observability callback (repro_torch.obs): fired on reserve changes,
    # never read by scheduling decisions
    ("SchedulerState", "on_reserve"): None,
    ("SchedulerState", "RESERVE_HYSTERESIS"): None,
    ("CostModel", "_est"): "cost",
    ("CostModel", "version"): "cost",
    ("CostModel", "registry"): None,
    ("CostModel", "alpha"): None,
    ("ArrivalEstimator", "_classes"): "arrivals",
    ("ArrivalEstimator", "_version"): "arrivals",
    ("ArrivalEstimator", "alpha"): None,
    # the demand memo is self-invalidating on (now, _version); reads of
    # the cache structure itself are safe
    ("ArrivalEstimator", "_demand"): None,
    ("ArrivalEstimator", "_demand_at"): None,
    ("ClassStats", "last_t"): "arrivals",
    ("ClassStats", "ia_ms"): "arrivals",
    ("ClassStats", "service_ms"): "arrivals",
    ("ClassStats", "footprint"): "arrivals",
    ("ClassStats", "n"): "arrivals",
    # checkpoint records are versioned by the owning shell's _version:
    # every CKPT_MUTATORS call site is forced onto a bumped path by the
    # mutation checker, so "state" in a memo key covers them
    ("CheckpointManager", "_recs"): "state",
    ("CheckpointManager", "_rid_progress"): "state",
    ("CheckpointManager", "registry"): None,
    ("CheckpointManager", "policy"): None,
    ("CheckpointManager", "stats"): None,     # reporting counters
    ("ChunkCheckpoint", "remaining"): "state",
    ("ChunkCheckpoint", "rid"): "state",
    ("ChunkCheckpoint", "chunk"): "state",
    ("ChunkCheckpoint", "shell"): "state",
    ("ChunkCheckpoint", "context_kb"): "state",
    ("BuddyAllocator", "_mask"): "state",
    ("BuddyAllocator", "busy"): "state",
    ("BuddyAllocator", "n"): None,            # fixed at construction
    # largest_free memo: self-invalidating on _mask equality
    ("BuddyAllocator", "_lf_mask"): None,
    ("BuddyAllocator", "_lf_best"): None,
    # fabric surface reachable from the memoized computations
    ("Fabric", "states"): None,               # membership fixed at init
    ("Fabric", "policy"): None,
    ("Fabric", "registry"): None,
    ("Fabric", "speeds"): None,
    ("Fabric", "ckpt_capable"): None,
    ("Fabric", "_transfer"): None,            # static topology costs
    ("Fabric", "full_reschedule"): None,
    # _subs entries are created/removed only alongside a touch of the
    # owning shell (submit in _dispatch/_steal_from, abort): covered by
    # the victim/thief versions in any key containing "state"
    ("Fabric", "_subs"): "state",
    ("Fabric", "_backlog_cache"): None,       # the memo itself
    ("Fabric", "_steal_fail"): None,          # the memo itself
    # stats counters are bumped on the steal *success* path, which the
    # failure fingerprint never caches; plain reporting either way
    ("Fabric", "stats"): None,
    # executor drain queues / per-sub bookkeeping: written on success
    # paths only, never read by a cached computation's decision
    ("Fabric", "_moved"): None,
    ("Fabric", "_sub_transfer"): None,
    ("Fabric", "_now"): "now",
    # flight recorder head (repro_torch.obs): write-only telemetry from the
    # fabric's point of view — hooks observe decisions, never make them
    ("Fabric", "obs"): None,
    # FabricJob fields read on steal/dispatch paths are admission-time
    # constants; the mutable ones (done, subs) are only touched on
    # success paths that also touch the involved shells
    ("FabricJob", "tenant"): None,
    ("FabricJob", "module"): None,
    ("FabricJob", "n_chunks"): None,
    ("FabricJob", "priority"): None,
    ("FabricJob", "deadline_ms"): None,
    ("FabricJob", "deadline_at"): None,
    ("FabricJob", "t_submit"): None,
    ("FabricJob", "payloads"): None,
    ("FabricJob", "gid"): None,
    ("FabricJob", "subs"): "state",
    ("FabricJob", "done"): "state",
    ("FabricJob", "failed"): "state",
    # link-level interconnect (core/network.py): occupancy is "net"
    # versioned state; topology/link parameters are fixed at build
    ("FabricNetwork", "version"): "net",
    ("FabricNetwork", "_active"): "net",
    ("FabricNetwork", "_pending"): "net",
    ("FabricNetwork", "_mode"): None,
    ("FabricNetwork", "_default"): None,
    ("FabricNetwork", "_pairs"): None,
    ("FabricNetwork", "_links"): None,         # membership fixed at build
    ("FabricNetwork", "_routes"): None,
    ("FabricNetwork", "_ports"): None,
    ("FabricNetwork", "active"): None,
    ("FabricNetwork", "has_ingress"): None,
    ("FabricNetwork", "inflight"): "net",
    ("Link", "busy_until"): "net",
    ("Link", "inflight"): "net",
    ("Link", "latency_ms"): None,
    ("Link", "bw_ms"): None,
    ("Link", "buffer"): None,
    ("Link", "src"): None,
    ("Link", "dst"): None,
    ("Link", "name"): None,
    ("Link", "busy_ms"): None,                 # reporting stats
    ("Link", "transfers"): None,
    ("Link", "max_queue"): None,
    ("Transfer", "src"): None,
    ("Transfer", "dst"): None,
    ("Transfer", "payload"): None,
    ("Transfer", "route"): None,
    ("Transfer", "t_start"): "net",
    ("Transfer", "t_done"): "net",
    ("Transfer", "wait_ms"): "net",
    ("Transfer", "total_ms"): "net",
}

# attribute-name fallback for receivers the typer cannot resolve (deque
# elements held in odd locals, dataclass results): Request/Assignment
# surfaces are scheduling state by definition
REQUEST_ATTRS = frozenset({
    "rid", "tenant", "module", "n_chunks", "_chunks", "done", "failed",
    "t_submit", "t_finish", "t_last_served", "priority", "deadline_ms",
    "preemptions", "pending", "outstanding", "complete", "deadline_at",
    "aid", "chunk", "footprint", "rng", "reconfigure", "eff", "t_start",
    "frac", "restore_ms", "save_ms", "start", "size", "slots",
    "remaining",
})

# -- determinism --------------------------------------------------------------

# modules on the simulator path: one nondeterministic read anywhere in
# these breaks golden-trace byte-identity and incremental/full
# equivalence
SIM_MODULES = (
    "scheduler", "fabric", "simulator", "arrivals", "checkpoint",
    "allocator", "slo", "network",
)

# intentional exceptions outside the sim path, (module, rule) -> why.
# Sim-path modules get no entries here on purpose: an exception there
# must sit on the offending line as a pragma, visible in review.
DETERMINISM_ALLOWLIST: dict = {
    ("daemon", "wall-clock"):
        "the daemon IS the wall-clock binding: it feeds "
        "perf_counter-derived times into the same fabric API the "
        "simulator drives with virtual time",
    ("module", "wall-clock"):
        "kernel benchmarking measures real device time by definition "
        "(block_until_ready around the pallas call)",
    ("module", "randomness"):
        "weight init uses jax.random with a fixed seed per module; "
        "numerics never feed back into scheduling decisions",
    ("zoo", "randomness"):
        "module zoo builds test inputs with seeded jax.random keys",
    ("export", "wall-clock"):
        "the Chrome-trace exporter (repro_torch.obs.export) stamps the "
        "capture time into the artifact's otherData for provenance; "
        "it renders already-recorded events and nothing flows back "
        "into scheduling (trace/recorder stay strict sim modules)",
}

# safe attribute reads not worth a VERSIONED entry (dunder/bookkeeping)
SAFE_ATTRS: dict = {}
