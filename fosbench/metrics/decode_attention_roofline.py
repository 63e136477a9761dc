"""The decode-attention kernel's share of its roofline over the profiled
decode steps: the least time its calls' bytes and operations allow (fp32
inputs, so the TF32 peak) over its device time.  Nothing where its device
records fall short of the wrapper's launch count."""
import sys

from fosbench import counts, tracing


def read(ctx):
    p = ctx.get("profile")
    if not p or p.get("phase") != "decode" or "kernels" not in p:
        return None
    m = ctx["model"]
    n, secs = tracing.kernel_time(p, "decode_kernel")
    launched = p["launches"]["decode_attention"]
    if not launched or n < launched:
        print(f"fosbench: decode_attention_roofline not reported: {n} "
              f"device records of {launched} launches", file=sys.stderr)
        return None
    bound = sum(counts.bound_seconds(*counts.decode_attention_work(
        p["b"], m["hq"], m["hkv"], m["hd"], pos + 1), counts.PEAK_TF32)
        for pos in p["positions"]) * m["layers"]
    return 100.0 * bound / secs
