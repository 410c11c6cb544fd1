"""The training step's share of the card's bf16 peak: required FLOPs of
the window's steps (bench_port/flops.train_flops) over the window's
seconds times the peak."""


def read(ctx):
    c = ctx.counters
    if not ctx.peaks or not c.get("steps"):
        return None
    return 100 * c["flops"] / (c["window_s"] * ctx.peaks["bf16_flops"])
