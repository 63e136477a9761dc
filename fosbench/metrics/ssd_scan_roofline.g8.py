"""The SSD scan's share of its roofline over the hybrid configuration's
profiled prefill, its B and C in the configuration's groups (8 for
nemotron-h): the least time a call's bytes and operations allow (fp32
inputs, so the TF32 peak) over the device time of its four kernels.
Nothing where the device records fall short of four a wrapper launch,
or for another family."""
import sys

from fosbench import counts, tracing


def read(ctx):
    p = ctx.get("profile")
    m = ctx["model"]
    if not p or p.get("phase") != "prefill" or "kernels" not in p \
            or m.get("family") != "hybrid":
        return None
    n, secs = tracing.kernel_time(p, "ssd_")
    launched = p["launches"]["ssd_scan"]
    if not launched or n < 4 * launched:
        print(f"fosbench: ssd_scan_roofline.g8 not reported: {n} device "
              f"records of {4 * launched} kernels", file=sys.stderr)
        return None
    bound = launched * counts.bound_seconds(*counts.ssd_work(
        p["b"], p["s"], m["heads"], m["headdim"], m["groups"], m["d_state"],
        m["chunk"]), counts.PEAK_TF32)
    return 100.0 * bound / secs
