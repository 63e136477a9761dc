"""The shared expert's share of the MoE layers in the recorded batch's
prefill on the device's clock: summed device time of the `moe.shared`
spans over that of the `layer.moe` spans.  Nothing without both (a
program without the span, or a model without a shared expert)."""
from fosbench import spans


def read(ctx):
    rec = ctx.get("spans")
    moe = spans.device_sum(rec, "layer.moe", decode=False)
    shared = spans.device_sum(rec, "moe.shared", decode=False)
    if not moe or not shared:
        return None
    return 100.0 * shared / moe
