"""The MoE layer's share of the recorded batch's decode steps on the
device's clock: summed device time of the `layer.moe` spans over that of
the `serve.decode_step` spans.  Nothing without both."""
from fosbench import spans


def read(ctx):
    return spans.moe_share(ctx.get("spans"), decode=True)
