"""Share of the profiled prefill with nothing running on the device: one
less the device's busy time over the window's length (one whole prefill
call, opened and closed behind a device synchronise).  Nothing where the
profile is of another phase or its records fall short."""
import sys


def read(ctx):
    p = ctx.get("profile")
    if not p or p.get("phase") != "prefill":
        return None
    if not p.get("whole"):
        print(f"fosbench: idle_share.prefill not reported: {p.get('why')}",
              file=sys.stderr)
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
