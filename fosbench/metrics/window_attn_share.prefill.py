"""The window layers' attention cores' share of the recorded batch's
prefill on the device's clock: summed device time of its `attn.window`
spans (the windowed flash call of each window layer) over that of the
`serve.prefill` span.  Nothing without both."""
from fosbench import spans


def read(ctx):
    rec = ctx.get("spans")
    whole = spans.device_sum(rec, "serve.prefill", decode=False)
    window = spans.device_sum(rec, "attn.window", decode=False)
    if not whole or not window:
        return None
    return 100.0 * window / whole
