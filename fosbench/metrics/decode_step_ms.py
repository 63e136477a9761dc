"""Mean decode step of the window's batches: their decode time as
`generate` returns it, over their decode steps (new - 1 a batch)."""


def read(ctx):
    steps = sum(b["new"] - 1 for b in ctx.get("batches", []))
    if not steps:
        return None
    return sum(b["decode_s"] for b in ctx["batches"]) / steps * 1e3
