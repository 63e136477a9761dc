"""The MoE layer's share of the recorded batch's prefill on the device's
clock: summed device time of its `layer.moe` spans over that of the
`serve.prefill` span.  Nothing without both."""
from fosbench import spans


def read(ctx):
    return spans.moe_share(ctx.get("spans"), decode=False)
