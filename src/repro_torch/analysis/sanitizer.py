"""Runtime sanitizer for the scheduler's mutation-tracking contract.

The static mutation checker (analysis/mutation.py) proves that every
*lexical* mutation path through `SchedulerState` bumps the version; this
module catches what the AST cannot see — dynamic mutations through
aliases (`st.requests[rid]._chunks.append(...)` held in a local across
calls), direct `busy`-set pokes that bypass the allocator chokepoint,
or any future executor reaching into scheduling state without firing
`_touch`.  Mechanism:

  - with `REPRO_SANITIZE=1` (or `SANITIZE` toggled at runtime by a
    test), every `SchedulerState` keeps a shadow snapshot
    `(version, hash-of-tracked-fields)` taken at the end of each
    scheduling pass;
  - at the start of the next pass — and, on a fabric, for *every*
    shell on every `Fabric.schedule` event, the clean (elided) shells
    included, since those are exactly the ones a silent mutation would
    corrupt — the shadow is recomputed and compared: a hash change
    with no version bump in between raises `SanitizerError`.

The hash covers exactly the fields the dirty-shell invariant depends on
(`scheduler.TRACKED_FIELDS`); fabric-shared structures (cost model,
arrival estimator, checkpoint manager, tenant service map) carry their
own versions or per-event sampling and are deliberately excluded — a
legitimate mutation by a sibling shell must not trip a clean shell's
check.  All hashing is deterministic (sorted sets, `repr` floats,
`zlib.crc32`), so a sanitized run is byte-identical to an unsanitized
one apart from the checks themselves — the equivalence property tests
run under `REPRO_SANITIZE=1` in CI and double as sanitizer coverage.
"""
from __future__ import annotations

import os
import zlib

# Runtime toggle: environment opt-in, or set `sanitizer.SANITIZE = True`
# from a test.  Read once here so the scheduler's per-call guard is one
# global load, never an environment probe on the hot path.
SANITIZE = os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


class SanitizerError(AssertionError):
    """Tracked scheduling state changed without a version bump."""


def _req_key(req) -> tuple:
    return (req.rid, req.tenant, req.module, req.n_chunks,
            tuple(req._chunks), req.done, req.failed,
            repr(req.t_submit), repr(req.t_finish),
            repr(req.t_last_served), req.priority,
            repr(req.deadline_ms), req.preemptions)


def shadow_hash(st) -> int:
    """Deterministic digest of a `SchedulerState`'s tracked fields.

    Everything order-dependent is canonicalised (dicts by sorted key,
    sets sorted) and floats go through `repr` (exact round-trip), so
    equal scheduling states hash equal across runs and platforms.
    """
    parts: list = ["q"]
    for tenant in sorted(st.queues):
        parts.append(tenant)
        parts.extend(_req_key(r) for r in st.queues[tenant])
    parts.append("r")
    for rid in sorted(st.requests):
        parts.append(_req_key(st.requests[rid]))
    parts.append("a")
    for aid in sorted(st.active):
        a = st.active[aid]
        parts.append((a.rid, a.chunk, a.module, a.footprint,
                      a.rng.start, a.rng.size, a.reconfigure, a.eff,
                      repr(a.t_start), repr(a.frac), repr(a.restore_ms),
                      repr(a.save_ms)))
    parts.append(("res", tuple(sorted(st.resident.items()))))
    parts.append(("alloc", st.alloc.n, st.alloc._mask,
                  tuple(sorted(st.alloc.busy))))
    parts.append(("n", st._pending_n, st._serve_seq,
                  tuple(sorted(st._served_at.items()))))
    return zlib.crc32(repr(parts).encode())


def check(st) -> None:
    """Raise `SanitizerError` if `st`'s tracked fields changed since the
    last `rearm` without a version bump; then re-arm the snapshot."""
    snap = getattr(st, "_shadow", None)
    h = shadow_hash(st)
    if snap is not None and snap[1] != h and snap[0] == st._version:
        raise SanitizerError(
            f"SchedulerState {st.name or '<anon>'}: tracked fields "
            f"(scheduler.TRACKED_FIELDS) mutated with no version bump "
            f"since the last scheduling pass (version still "
            f"{st._version}).  The incremental fabric would keep "
            f"treating this shell as a scheduling fixpoint and never "
            f"reschedule it — a silent divergence from "
            f"full_reschedule.  Route the mutation through a "
            f"SchedulerState method, or fire st._touch() after it.")
    st._shadow = (st._version, h)


def rearm(st) -> None:
    """Snapshot `st` after a pass legitimately mutated it."""
    st._shadow = (st._version, shadow_hash(st))
