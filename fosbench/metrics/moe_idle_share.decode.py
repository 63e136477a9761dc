"""Over the profiled decode steps, the share of the device's idle time in
which the host's innermost program span was the MoE layer (`layer.moe`)
or one of its parts (`moe.*`): the profile's `idle_by_span`.  Nothing
where the profile is of another phase or holds no program span."""
from fosbench import spans


def read(ctx):
    p = ctx.get("profile")
    if not p or p.get("phase") != "decode":
        return None
    return spans.moe_idle_share(p.get("idle_by_span"))
