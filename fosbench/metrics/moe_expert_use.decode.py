"""Share of the experts the MoE product reads that a kept pair was routed
to, over the recorded batch's decode steps: the decode phase's
`moe.experts_hit` (device) over `moe.experts_read` (host) counters.
Nothing without them."""


def read(ctx):
    c = ((ctx.get("spans") or {}).get("counters") or {}).get("decode", {})
    if not c.get("moe.experts_read") or "moe.experts_hit" not in c:
        return None
    return 100.0 * c["moe.experts_hit"] / c["moe.experts_read"]
