"""A short torch.profiler window and what the harness reads from its trace.

The window is opened and closed behind a device synchronise and marked by
a `fosbench.window` range; every kernel, copy and set on the device inside
it counts as busy.  torch.profiler can drop kernel records, so the reading
says whether it is whole: every kernel launch the host made in the window
(`cudaLaunch*` / `cuLaunch*` runtime calls) has to have its device record
(matched by correlation id), and the port's own kernels are counted
against their wrappers' `.launches` counters by the readers.
"""
from __future__ import annotations

import json
import os

import torch

from fosbench.common import CACHE

WINDOW = "fosbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Window:
    """start() / stop() around some calls; read() parses the trace."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self._range = None

    def start(self):
        torch.cuda.synchronize()
        self.prof.start()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def stop(self):
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> dict:
        path = CACHE / f"trace_{os.getpid()}.json"
        self.prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            path.unlink(missing_ok=True)
        return summarise(events)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarise(events: list[dict]) -> dict:
    """From chrome-trace events: the window (s), busy (s), kernel time and
    count by name, whether every launch has its record, and the longest
    idle gaps named by the host op that ran at their start."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return {"whole": False, "why": "no window range in the trace"}
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _union((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                  for e in dev)
    by_name: dict[str, list] = {}
    for e in dev:
        if e["cat"] == "kernel":
            c = by_name.setdefault(e["name"], [0, 0.0])
            c[0] += 1
            c[1] += e["dur"] * 1e-6
    launches = {e.get("args", {}).get("correlation") for e in xs
                if e.get("cat") == "cuda_runtime"
                and e["name"].startswith(("cudaLaunch", "cuLaunch"))
                and w0 <= e["ts"] <= w1}
    launches.discard(None)
    recorded = {e.get("args", {}).get("correlation") for e in xs
                if e.get("cat") == "kernel"}
    missing = len(launches - recorded)
    host = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") != WINDOW]
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    spans = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2])
                    if b > a), key=lambda g: g[0] - g[1])[:10]
    gaps = []
    for a, b in spans:      # named by the innermost host op at its start
        at = [e for e in host if e["ts"] <= a < e["ts"] + e["dur"]]
        name = min(at, key=lambda e: e["dur"])["name"] if at else "host"
        gaps.append((name, (b - a) * 1e-6))
    return {
        "whole": missing == 0 and bool(dev),
        "why": (f"{missing} of {len(launches)} kernel launches have no "
                f"device record" if missing else
                ("no device activity" if not dev else "")),
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": {k: tuple(v) for k, v in by_name.items()},
        "launches_seen": len(launches),
        "device_ops": [[k, v[1]] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1][1])[:10]],
        "idle_gaps": [[n, s] for n, s in gaps],
    }


def kernel_time(summary: dict, needle: str) -> tuple[int, float]:
    """(records, seconds) of the kernels whose name holds `needle`."""
    n, s = 0, 0.0
    for name, (c, t) in summary.get("kernels", {}).items():
        if needle in name:
            n, s = n + c, s + t
    return n, s
