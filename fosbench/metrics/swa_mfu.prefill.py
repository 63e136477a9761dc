"""Model FLOPs of the window's prefills of the afmoe configuration, by
part (`afmoe.part_flops`: the window layers' attention over each query's
window, the full layers' over the causal prefix), over their time (as
`generate` returns it), as a share of the card's dense bf16 peak
(`mfu.prefill`'s yardstick).  Nothing for another family."""
from fosbench import afmoe, counts


def read(ctx):
    m = ctx["model"]
    bs = ctx.get("batches", [])
    t = sum(b["prefill_s"] for b in bs)
    if m.get("family") != "afmoe" or not t:
        return None
    f = sum(afmoe.prefill_flops(m, b["b"], b["s"]) for b in bs)
    return 100.0 * f / t / counts.PEAK_BF16
