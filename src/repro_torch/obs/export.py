"""Chrome-trace-event exporter: open the result in Perfetto
(https://ui.perfetto.dev) or chrome://tracing.

The layout is one process ("fos"), one thread lane per shell plus a
``fabric`` lane (tid 0) for fabric-scope events (submits, steal
probes, scheduler passes).  ``chunk_start`` events are paired with
their ``chunk_complete``/``preempt`` partner by assignment id into "X"
(complete) duration events; every other kind renders as a thread
instant.  Trace timestamps are microseconds, so sim-time milliseconds
are multiplied by 1000.

This module does file I/O and stamps the capture time into
``otherData`` — it is *not* a sim module, and its wall-clock read is
allowlisted in `analysis/config.py` (the stamp annotates the artifact;
nothing feeds back into scheduling).
"""

from __future__ import annotations

import json
import time

from repro_torch.obs import trace as tr

# event kinds whose span pairing the exporter understands
_SPAN_OPEN = tr.CHUNK_START
_SPAN_CLOSE = (tr.CHUNK_COMPLETE, tr.PREEMPT)


def chrome_trace(events, shells=None, dropped: int = 0) -> dict:
    """Build the Chrome trace dict from an iterable of TraceEvents.

    ``shells`` optionally fixes the lane order; by default lanes appear
    in first-event order, sorted for determinism.
    """
    events = list(events)
    if shells is None:
        lanes: dict[str, None] = {}
        for e in events:
            if e.shell is not None and e.shell not in lanes:
                lanes[e.shell] = None
        shells = sorted(lanes)
    tid = {"fabric": 0}
    for i, name in enumerate(shells):
        tid[name] = i + 1

    out = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
            "args": {"name": "fos"}},
           {"ph": "M", "name": "thread_name", "pid": 1, "tid": 0,
            "args": {"name": "fabric"}}]
    for name in shells:
        out.append({"ph": "M", "name": "thread_name", "pid": 1,
                    "tid": tid[name], "args": {"name": name}})

    open_by_aid: dict[int, tr.TraceEvent] = {}
    for e in events:
        lane = tid.get(e.shell, 0)
        if e.kind == _SPAN_OPEN:
            open_by_aid[e.aid] = e
            continue
        if e.kind in _SPAN_CLOSE:
            start = open_by_aid.pop(e.aid, None)
            t0 = (start.t_ms if start is not None
                  else (e.data or {}).get("t_start", e.t_ms))
            args = {"rid": e.rid, "chunk": e.chunk, "aid": e.aid}
            if start is not None and start.data:
                args.update(start.data)
            if e.tenant is not None:
                args["tenant"] = e.tenant
            if e.kind == tr.PREEMPT:
                args["preempted"] = True
            name = args.get("module", "chunk")
            out.append({"ph": "X", "name": f"{name} r{e.rid}.c{e.chunk}",
                        "cat": "chunk", "pid": 1, "tid": lane,
                        "ts": t0 * 1000.0,
                        "dur": (e.t_ms - t0) * 1000.0, "args": args})
            continue
        args = {}
        if e.rid is not None:
            args["rid"] = e.rid
        if e.tenant is not None:
            args["tenant"] = e.tenant
        if e.data:
            args.update(e.data)
        out.append({"ph": "i", "s": "t", "name": e.kind, "cat": e.kind,
                    "pid": 1, "tid": lane, "ts": e.t_ms * 1000.0,
                    "args": args})

    # chunks still in flight when the trace was captured (live daemon
    # snapshots): render as open "B" markers so the lane shows them
    for aid, start in open_by_aid.items():
        out.append({"ph": "B", "name": f"r{start.rid}.c{start.chunk}",
                    "cat": "chunk", "pid": 1,
                    "tid": tid.get(start.shell, 0),
                    "ts": start.t_ms * 1000.0,
                    "args": {"rid": start.rid, "chunk": start.chunk,
                             "aid": aid}})

    out.sort(key=lambda ev: (ev["ph"] != "M", ev.get("ts", 0.0)))
    return {"traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": dropped,
                          "captured_unix_s": time.time()}}


def export_chrome_trace(source, path: str | None = None,
                        shells=None) -> dict:
    """Render ``source`` (a Tracer or an iterable of TraceEvents) to a
    Chrome trace dict, writing JSON to ``path`` when given."""
    dropped = getattr(source, "dropped", 0)
    events = getattr(source, "events", source)
    doc = chrome_trace(events, shells=shells, dropped=dropped)
    if path:
        with open(path, "w") as fh:
            json.dump(doc, fh)
    return doc
