"""Model FLOPs of the window's decode steps over their time (as `generate`
returns it), as a share of the card's dense bf16 peak."""
from fosbench import counts


def read(ctx):
    bs = [b for b in ctx.get("batches", []) if b["new"] > 1]
    t = sum(b["decode_s"] for b in bs)
    if not t:
        return None
    f = sum(counts.generate_flops(ctx["model"], b["b"], b["s"], b["new"])[1]
            for b in bs)
    return 100.0 * f / t / counts.PEAK_BF16
