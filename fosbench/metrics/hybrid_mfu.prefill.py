"""Model FLOPs of the window's prefills of the hybrid configuration, by
block kind (`hybrid.block_flops`), over their time (as `generate`
returns it), as a share of the card's dense bf16 peak (`mfu.prefill`'s
yardstick).  Nothing for another family."""
from fosbench import counts, hybrid


def read(ctx):
    m = ctx["model"]
    bs = ctx.get("batches", [])
    t = sum(b["prefill_s"] for b in bs)
    if m.get("family") != "hybrid" or not t:
        return None
    f = sum(hybrid.prefill_flops(m, b["b"], b["s"]) for b in bs)
    return 100.0 * f / t / counts.PEAK_BF16
