"""The windowed flash kernel's share of its roofline over the afmoe
configuration's profiled prefill: the least time its calls' bytes and
operations allow (`afmoe.flash_window_work`: q, k, v and the output once,
each query's min(i + 1, W) keys; fp32 inputs, so the TF32 peak) over the
device time of its `flash_window_kernel` records.  Nothing where those
records fall short of the windowed launches the wrapper counted, or for
another family."""
import sys

from fosbench import afmoe, counts, tracing


def read(ctx):
    p = ctx.get("profile")
    m = ctx["model"]
    if not p or p.get("phase") != "prefill" or "kernels" not in p \
            or m.get("family") != "afmoe":
        return None
    n, secs = tracing.kernel_time(p, "flash_window_kernel")
    launched = p.get("launches", {}).get("flash_window", 0)
    if not launched or n < launched:
        print(f"fosbench: flash_window_roofline not reported: {n} device "
              f"records of {launched} launches", file=sys.stderr)
        return None
    bound = launched * counts.bound_seconds(*afmoe.flash_window_work(
        p["b"], p["s"], m["window"], m["hq"], m["hkv"], m["hd"]),
        counts.PEAK_TF32)
    return 100.0 * bound / secs
