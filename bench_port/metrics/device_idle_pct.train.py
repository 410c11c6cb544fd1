"""Share of the traced training window in which no kernel, copy or set
ran on the card."""


def read(ctx):
    t = ctx.trace_summary
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100 * (1 - t["busy_s"] / t["window_s"])
