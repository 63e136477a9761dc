"""The decode-attention kernel's share of its roofline over the hybrid
configuration's profiled decode steps (`ctx["profile_decode"]`; 16 q
heads a kv head for nemotron-h, two CTAs of 8): the least time its calls'
bytes and operations allow (fp32 inputs, so the TF32 peak; K and V read
once) over its device time, in each of the attention blocks.  Nothing
where its device records fall short of the wrapper's launch count, or
for another family."""
import sys

from fosbench import counts, tracing


def read(ctx):
    p = ctx.get("profile_decode")
    m = ctx["model"]
    if not p or p.get("phase") != "decode" or "kernels" not in p \
            or m.get("family") != "hybrid":
        return None
    n, secs = tracing.kernel_time(p, "decode_kernel")
    launched = p["launches"]["decode_attention"]
    if not launched or n < launched:
        print(f"fosbench: decode_attention_roofline.g16 not reported: {n} "
              f"device records of {launched} launches", file=sys.stderr)
        return None
    bound = sum(counts.bound_seconds(*counts.decode_attention_work(
        p["b"], m["hq"], m["hkv"], m["hd"], pos + 1), counts.PEAK_TF32)
        for pos in p["positions"]) * m["attn_layers"]
    return 100.0 * bound / secs
