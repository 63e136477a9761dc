"""Nearest-rank 95th percentile of the gap between tokens over the
recorded batch's decode steps, on the device's clock: the end of step i
less the end of step i - 1, step 0's from the end of the prefill
(`serve.prefill` / `serve.decode_step` spans' `d1`).  Nothing without the
recorded batch's device spans."""
from fosbench import spans
from fosbench.common import p95


def read(ctx):
    recs = ctx.get("spans")
    ends = [r["d1"] for r in spans.batch_spans(recs, "serve.prefill")
            + spans.batch_spans(recs, "serve.decode_step") if "d1" in r]
    if len(ends) < 2:
        return None
    return p95([(b - a) * 1e-6 for a, b in zip(ends, ends[1:])])
