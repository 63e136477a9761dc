"""Model FLOPs of the window's prefills over their time (as `generate`
returns it), as a share of the card's dense bf16 peak."""
from fosbench import counts


def read(ctx):
    bs = ctx.get("batches", [])
    t = sum(b["prefill_s"] for b in bs)
    if not t:
        return None
    f = sum(counts.prefill_flops(ctx["model"], b["b"], b["s"]) for b in bs)
    return 100.0 * f / t / counts.PEAK_BF16
