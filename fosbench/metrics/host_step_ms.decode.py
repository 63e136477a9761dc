"""Mean host duration of the recorded batch's `serve.decode_step` spans:
the host's time to issue one decode step.  Nothing without the recorded
batch."""
from fosbench import spans


def read(ctx):
    steps = spans.batch_spans(ctx.get("spans"), "serve.decode_step")
    if not steps:
        return None
    return sum(r["t1"] - r["t0"] for r in steps) / len(steps) * 1e-6
