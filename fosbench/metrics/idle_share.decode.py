"""Share of a decode step with nothing running on the device: one less
the device's busy time a profiled step (the trace of a few decode steps)
over the window's mean decode step (`decode_step_ms`, unprofiled).  The
profiled steps' own wall time is not the denominator: the profiler's
host work stretches them (0.44-0.62 s for eight steps of 35-42 ms).
Nothing where the profile's records fall short."""
import sys


def read(ctx):
    p = ctx.get("profile")
    steps = sum(b["new"] - 1 for b in ctx.get("batches", []))
    if not p or p.get("phase") != "decode" or not steps:
        return None
    if not p.get("whole"):
        print(f"fosbench: idle_share.decode not reported: {p.get('why')}",
              file=sys.stderr)
        return None
    busy = p["busy_s"] / len(p["positions"])
    step = sum(b["decode_s"] for b in ctx["batches"]) / steps
    return 100.0 * (1.0 - busy / step)
