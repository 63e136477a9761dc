"""What the harness reads from the program's own spans and counters
(`repro_torch.obs.spans`, the port's served path).

After a traced run's window, `record` runs one batch through `generate`
with the recorder active on the device's clock (`generate` creates the
batch's CUDA events before its prefill); its records are what the span
readers take as `ctx["spans"]`: `{"spans": [{"name", "id",
"parent", "batch", "step", "t0", "t1", "d0", "d1", ...}], "counters":
{phase: {name: n}}, "dropped": n}`, times in nanoseconds of the host's
clock (`d0`, `d1` the device's, mapped onto it).  The profiled batch runs
inside `annotated()`, the recorder active without device events, so the
program's spans land in the profiler's trace as `user_annotation`
events; `idle_by_span(events)` reads the window's device idle time by
the innermost program span the host was in, as the profile's
`idle_by_span`.

On a program without the recorder `record` gives None, `annotated` does
nothing and `idle_by_span` an empty dict, so every span reader reports
nothing there.
"""
from __future__ import annotations

import contextlib
import importlib

from fosbench import tracing

PROGRAM = ("serve.", "layer.", "moe.")  # the program's span names
HOST = "host"           # idle or device time outside every program span
MOE = ("layer.moe", "moe.")             # the MoE layer and its parts


def _recorder():
    try:
        return importlib.import_module("repro_torch.obs.spans")
    except ImportError:
        return None


def record(generate, *args) -> dict | None:
    """`generate(*args)` with the recorder active on the device's clock,
    and its records; None where the program has no recorder."""
    sp = _recorder()
    if sp is None:
        return None
    with sp.recorder(device=True) as records:
        generate(*args)
    return records


@contextlib.contextmanager
def annotated():
    """The recorder active without device events, where the program has
    one: under torch.profiler its spans become trace annotations."""
    sp = _recorder()
    if sp is None:
        yield
        return
    with sp.recorder(device=False):
        yield


# ---------------------------------------------------------------------------
# the recorded batch
# ---------------------------------------------------------------------------


def batch_spans(records: dict | None, name: str) -> list[dict]:
    """The spans `name` of the last recorded batch, by step."""
    if not records or not records.get("spans"):
        return []
    last = max(r["batch"] for r in records["spans"])
    return sorted((r for r in records["spans"]
                   if r["name"] == name and r["batch"] == last),
                  key=lambda r: r["step"])


def device_sum(records: dict | None, name: str, decode: bool) -> float:
    """Summed device seconds of the last batch's spans `name` in the
    decode steps (or the prefill); 0 where none has device times."""
    return sum(r["d1"] - r["d0"] for r in batch_spans(records, name)
               if "d0" in r and (r["step"] >= 0) == decode) * 1e-9


def moe_share(records: dict | None, decode: bool) -> float | None:
    """The MoE layer's share (%) of the device time of the last batch's
    decode steps (or prefill); None without both."""
    whole = device_sum(records, "serve.decode_step" if decode
                       else "serve.prefill", decode)
    moe = device_sum(records, "layer.moe", decode)
    if not whole or not moe:
        return None
    return 100.0 * moe / whole


# ---------------------------------------------------------------------------
# the profiled batch's trace
# ---------------------------------------------------------------------------


def _innermost(spans: list[tuple]) -> list[tuple]:
    """[(a, b, name)]: over each stretch that (start, end, name) spans
    cover, the innermost of them (the latest started of those open)."""
    pts = sorted({t for a, b, _ in spans for t in (a, b)})
    order = sorted(spans, key=lambda x: (x[0], -x[1]))
    out, stack, i = [], [], 0
    for a, b in zip(pts, pts[1:]):
        while i < len(order) and order[i][0] <= a:
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] <= a:
            stack.pop()
        if stack:
            out.append((a, b, stack[-1][2]))
    return out


def _window(events: list[dict]):
    """(w0, w1, X events, program spans) of the trace's window, or None
    where it has no window or no program span."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == tracing.WINDOW
           and e.get("cat") == "user_annotation"]
    prog = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
            if e.get("cat") == "user_annotation"
            and e["name"].startswith(PROGRAM)]
    if not win or not prog:
        return None
    return win[0]["ts"], win[0]["ts"] + win[0]["dur"], xs, prog


def idle_by_span(events: list[dict]) -> dict[str, float]:
    """Seconds of the window with nothing on the device (the complement
    of `summarise`'s kernel, copy and set union), by the innermost
    program span the host was in then (`HOST` outside every one); {}
    where the trace has no window or no program span."""
    got = _window(events)
    if got is None:
        return {}
    w0, w1, xs, prog = got
    busy = tracing._union(
        (max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in xs
        if e.get("cat") in tracing.DEVICE_CATS
        and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    segs = _innermost(prog)
    out: dict[str, float] = {}
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + hi - lo
                covered += hi - lo
            k += 1
        if b - a > covered:
            out[HOST] = out.get(HOST, 0.0) + (b - a - covered)
    return {k: v * 1e-6 for k, v in out.items()}


def moe_idle_share(idle: dict[str, float] | None) -> float | None:
    """The share (%) of `idle_by_span`'s idle time in which the host was
    in the MoE layer or one of its parts; None without program spans."""
    if not idle:
        return None
    total = sum(idle.values())
    if not total:
        return None
    return 100.0 * sum(v for k, v in idle.items()
                       if k == MOE[0] or k.startswith(MOE[1])) / total
