"""Spans and counters on the served path, on the host's and the device's
clock.

`repro_torch.launch.serve.generate` and the layers it runs
(`models/stack.py::_sublayer`, `models/moe.py::moe_ep`) open spans and
bump counters through this module.  It is off by default: while no
recorder is active, `span()` returns one shared no-op object and
`count()` returns at once, so a call site costs one module-global test.
It reads no clock, allocates nothing and records nothing.

    from repro_torch.obs import spans
    with spans.recorder(device=True) as records:
        generate(cfg, params, prompt, new)
    records     # {"spans": [...], "counters": {...}, "dropped": n}
    spans.export_chrome_trace(records, "spans.json")

While a recorder is active, each span records its name, an id, its
parent's id, `batch` (the sequence number of the `generate` call, the
identifier every span of one batch of requests shares), `step` (the
decode step, -1 for the prefill), the attributes `b`, `s`, `pos` where
given, and its start and end on the host (`t0`, `t1`: nanoseconds of
`time.perf_counter_ns`, taken inside the span's own bookkeeping).  On
the hot path a closed span is one tuple on a list; `resolve()` turns
each into a dict and one `TraceEvent` of kind `"span"` in a bounded
`obs.trace.Tracer`: a long run forgets its oldest spans and counts them
in `dropped`.  Between two resolves the list holds one `generate`
call's spans.

Device clock: a span opened with `device=True` also records a pair of
CUDA events on the stream that was current at the last anchor (the
served path's), taken from a pool that every recorder of the process
reuses; `generate` calls `reserve()` before its prefill, which creates
the events a batch needs, so its spans create none.  `generate` calls
`anchor(device)` right after the synchronises it already makes before
and after its prefill, and `resolve()` after the one that ends its
decode loop: each event is then read against the latest anchor before
it and put on the host's clock as `d0`, `d1`.  No synchronise is added.
Spans open before the first anchor, or on a device that is not CUDA,
record no events.

Profiler: while torch.profiler runs, each span also opens
`torch.profiler.record_function(name)`, so the program's spans appear in
its trace as `user_annotation` events on the trace's own clock.

Counters: `count(name, n)` adds a host number; `count_device(name, fn,
*args)` keeps device tensors and adds the count `fn(*args)` at
`resolve()`, after the synchronise, so the hot path launches nothing for
it (the kept tensors stay alive until then).  Both are kept per phase
(`"prefill"` or `"decode"`, from the enclosing `serve.prefill` /
`serve.decode_step` span; `"other"` outside them).

`paused()` stops recording for a block (a CUDA graph's capture, whose
work runs only at its replays).

One recorder at a time, driven from one thread (the served path's).
"""
from __future__ import annotations

import contextlib
import json
# schedlint: ok(determinism) spans time the served path for an operator
# or the benchmark; nothing they record flows back into scheduling or
# into what is served
import time

import torch

from repro_torch.obs.trace import Tracer

_PROFILER = torch.autograd.profiler     # `_is_profiler_enabled` while on

SPAN = "span"               # the TraceEvent kind of a closed span
BATCH = "serve.generate"    # the span that opens a batch
PHASES = {"serve.prefill": "prefill", "serve.decode_step": "decode"}
OTHER = "other"             # the phase of counts outside both
_ATTRS = ("b", "s", "pos")


class _Null:
    """The span while no recorder is active: enters and exits, nothing
    else."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()
_REC: "Recorder | None" = None
_POOL: list = []        # created CUDA events not in use, for any recorder


def span(name: str, device: bool = False, step: int | None = None,
         b: int | None = None, s: int | None = None,
         pos: int | None = None):
    """A context manager around one span; `NULL` while no recorder is
    active.  `step` sets the step of this span and its children."""
    if _REC is None:
        return NULL
    return _Span(_REC, name, device, step, (b, s, pos))


def count(name: str, n: int) -> None:
    """Add `n` to the host counter `name` of the current phase."""
    if _REC is not None:
        key = (_REC.phase, name)
        _REC.host_counts[key] = _REC.host_counts.get(key, 0) + n


def count_device(name: str, fn, *args) -> None:
    """Add `fn(*args)`, a 0-d int64 count over device tensors, to the
    device counter `name` of the current phase.  `fn` runs at
    `resolve()`: until then the recorder keeps `args`, which nothing may
    change in place."""
    if _REC is not None:
        _REC.deferred += (_REC.phase, name, fn, len(args), *args)


def recording() -> bool:
    """Whether a recorder is active."""
    return _REC is not None


def anchor(device: torch.device) -> None:
    """After a device synchronise: a CUDA event on `device`'s current
    stream and the host's clock, the pair later events are read
    against."""
    if _REC is not None and _REC.device and device.type == "cuda":
        # the stream is looked up here once, not at every event record
        _REC.stream = torch.cuda.current_stream(device)
        ev = _REC.event()
        ev.record(_REC.stream)
        _REC.anchor = (ev, time.perf_counter_ns())


def resolve() -> None:
    """After a device synchronise: put the spans closed since the last
    call into the ring buffer, each device span's events on the host's
    clock (`d0`, `d1`), and read the device counters."""
    if _REC is not None:
        _REC.resolve()


def reserve(device: torch.device, n: int) -> None:
    """Before a recorded batch: fill the pool to `n` CUDA events on
    `device`, each recorded once on its current stream (CUDA creates an
    event at its first record), so that no span of the batch creates
    one."""
    if _REC is not None and _REC.device and device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        while len(_POOL) < n:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            _POOL.append(ev)


@contextlib.contextmanager
def paused():
    """No span and no count inside the block, while a recorder is active
    around it: a CUDA graph's capture, whose events could not be timed
    and whose work runs only when the graph is replayed."""
    global _REC
    rec, _REC = _REC, None
    try:
        yield
    finally:
        _REC = rec


def activate(device: bool = True, max_events: int = 1 << 18) -> None:
    global _REC
    if _REC is not None:
        raise RuntimeError("a span recorder is already active")
    _REC = Recorder(device, max_events)


@contextlib.contextmanager
def recorder(device: bool = True, max_events: int = 1 << 18):
    """`activate()` for the block; the dict it yields holds what
    `deactivate()` returns once the block has ended."""
    activate(device, max_events)
    records: dict = {}
    try:
        yield records
    finally:
        records.update(deactivate())


def deactivate() -> dict:
    """Stop recording and return the records: `spans` (each a dict, in
    the order they closed), `counters` ({phase: {name: n}}) and
    `dropped` (spans the ring buffer forgot)."""
    global _REC
    rec, _REC = _REC, None
    if rec is None:
        raise RuntimeError("no span recorder is active")
    # what closed since the last resolve(); a synchronise only where
    # events wait to be read (reading a device counter waits for it)
    if rec.events:
        torch.cuda.synchronize()
    rec.resolve()
    counters: dict = {}
    for (phase, name), n in rec.host_counts.items():
        counters.setdefault(phase, {})[name] = n
    for (phase, name), n in rec.dev_totals.items():
        counters.setdefault(phase, {})[name] = n
    return {"spans": [e.data for e in rec.tracer.events],
            "counters": counters, "dropped": rec.tracer.dropped}


class Recorder:
    """What an active recorder holds: the ring of closed spans, the spans
    closed since the last resolve(), the open ones, the current batch,
    step and phase, the counters, and the CUDA events (the anchor and its
    stream).

    Until resolve() a closed span is a tuple of names and numbers on a
    list (one the garbage collector stops walking once it has seen it),
    its events on another list, and a device counter its function and
    tensors on a third: the hot path leaves no new container that holds
    an object behind, which the collector would walk again and again."""

    def __init__(self, device: bool, max_events: int):
        self.device = device and torch.cuda.is_available()
        self.tracer = Tracer(max_events)
        self.next_id = 0
        self.stack: list[int] = []      # the open spans' ids
        self.batch, self.step, self.phase = -1, -1, OTHER
        self.host_counts: dict = {}
        self.dev_totals: dict = {}      # (phase, name) -> n, at resolve()
        # (name, id, parent, batch, step, (b, s, pos), t0, t1, ev, t_a):
        # ev the index in `events` of ev0, ev1 and the anchor's event
        # (None without events), t_a the anchor's host ns
        self.rows: list[tuple] = []
        self.events: list = []
        # phase, name, fn, its number of args, the args; a flat list
        self.deferred: list = []
        self.anchor = self.stream = None

    @staticmethod
    def event():
        if _POOL:
            return _POOL.pop()
        return torch.cuda.Event(enable_timing=True)

    def resolve(self) -> None:
        """Each closed span as a dict, its events on the host's clock, in
        the ring buffer; the device counters read."""
        events = self.events
        for name, sid, parent, batch, step, attrs, t0, t1, ev, t_a \
                in self.rows:
            data = {"name": name, "id": sid, "parent": parent,
                    "batch": batch, "step": step, "t0": t0, "t1": t1}
            for k, v in zip(_ATTRS, attrs):
                if v is not None:
                    data[k] = v
            if ev is not None:
                ev0, ev1, ev_a = events[ev:ev + 3]
                data["d0"] = t_a + round(ev_a.elapsed_time(ev0) * 1e6)
                data["d1"] = t_a + round(ev_a.elapsed_time(ev1) * 1e6)
                _POOL.extend((ev0, ev1))
            self.tracer.emit(t0 * 1e-6, SPAN, data=data)
        self.rows.clear()
        events.clear()
        keys, counts, d, i = [], [], self.deferred, 0
        while i < len(d):
            phase, name, fn, n = d[i:i + 4]
            keys.append((phase, name))
            counts.append(fn(*d[i + 4:i + 4 + n]))
            i += 4 + n
        if counts:
            for key, n in zip(keys, torch.stack(counts).tolist()):
                self.dev_totals[key] = self.dev_totals.get(key, 0) + n
        d.clear()


class _Span:
    """One span of an active recorder."""
    __slots__ = ("rec", "name", "device", "step", "attrs", "open")

    def __init__(self, rec: Recorder, name: str, device: bool,
                 step: int | None, attrs: tuple):
        self.rec, self.name, self.device = rec, name, device
        self.step, self.attrs, self.open = step, attrs, None

    def __enter__(self):
        rec, name = self.rec, self.name
        saved = (rec.step, rec.phase)
        if name == BATCH:
            rec.batch += 1
        phase = PHASES.get(name)
        if phase is not None:
            rec.phase, rec.step = phase, -1
        if self.step is not None:
            rec.step = self.step
        sid = rec.next_id
        rec.next_id = sid + 1
        parent = rec.stack[-1] if rec.stack else None
        rec.stack.append(sid)
        rf = ev0 = None
        if _PROFILER._is_profiler_enabled:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        if self.device and rec.anchor is not None:
            ev0 = rec.event()
            ev0.record(rec.stream)
        self.open = (sid, parent, rec.batch, rec.step, saved, rf, ev0,
                     rec.anchor, time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        sid, parent, batch, step, saved, rf, ev0, anchor, t0 = self.open
        ev = t_a = None
        if ev0 is not None:
            ev1 = rec.event()
            ev1.record(rec.stream)
            ev = len(rec.events)
            rec.events += (ev0, ev1, anchor[0])
            t_a = anchor[1]
        if rf is not None:
            rf.__exit__(None, None, None)
        rec.stack.pop()
        rec.step, rec.phase = saved
        rec.rows.append((self.name, sid, parent, batch, step, self.attrs,
                         t0, t1, ev, t_a))
        return False


def chrome_trace(records: dict) -> dict:
    """The records as a Chrome trace (Perfetto, chrome://tracing): the
    `fos` process of `obs/export.py`, a `host` lane (tid 0) and a `device`
    lane (tid 1), one complete (`X`) event per span on each clock it has,
    microseconds from the first span's start.  The counters and the
    dropped count go into `otherData`."""
    sp = records["spans"]
    base = min((r["t0"] for r in sp), default=0)
    out = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
            "args": {"name": "fos"}},
           {"ph": "M", "name": "thread_name", "pid": 1, "tid": 0,
            "args": {"name": "host"}},
           {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
            "args": {"name": "device"}}]
    for r in sp:
        args = {k: r[k] for k in ("id", "parent", "batch", "step") + _ATTRS
                if k in r}
        for tid, a, z in ((0, "t0", "t1"), (1, "d0", "d1")):
            if a in r:
                out.append({"ph": "X", "name": r["name"], "cat": "span",
                            "pid": 1, "tid": tid,
                            "ts": (r[a] - base) / 1e3,
                            "dur": (r[z] - r[a]) / 1e3, "args": args})
    out.sort(key=lambda ev: (ev["ph"] != "M", ev.get("ts", 0.0),
                            -ev.get("dur", 0.0)))
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"dropped_events": records["dropped"],
                          "counters": records["counters"]}}


def export_chrome_trace(records: dict, path: str) -> dict:
    """`chrome_trace(records)`, written as JSON to `path`."""
    doc = chrome_trace(records)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc
