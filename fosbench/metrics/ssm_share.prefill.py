"""The SSM layers' share of the recorded batch's prefill on the device's
clock: summed device time of its `layer.ssm` spans over that of the
`serve.prefill` span.  Nothing without both."""
from fosbench import spans


def read(ctx):
    rec = ctx.get("spans")
    whole = spans.device_sum(rec, "serve.prefill", decode=False)
    ssm = spans.device_sum(rec, "layer.ssm", decode=False)
    if not whole or not ssm:
        return None
    return 100.0 * ssm / whole
