"""The served model's share of the card's bf16 peak: required FLOPs of
the prefills and decoded tokens finished in the window over the window's
seconds times the peak."""


def read(ctx):
    c = ctx.counters
    if not ctx.peaks or not c.get("window_flops"):
        return None
    return 100 * c["window_flops"] / (c["window_s"] * ctx.peaks["bf16_flops"])
