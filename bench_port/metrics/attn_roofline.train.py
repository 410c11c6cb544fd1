"""K1-K3's share of their roofline in training: the attention FLOPs the
window's steps require (forward and backward, both towers) at the bf16
peak, over the traced time of the kernels matching PATTERNS (K1's forward
launches, the recomputation's among them, and K2/K3)."""

from bench_port import harness

PATTERNS = ('flash_fwd', 'flash_bwd')


def read(ctx):
    t = ctx.trace_summary
    if t is None or not ctx.peaks:
        return None
    secs = harness.kernel_seconds(t, PATTERNS)
    if secs <= 0:
        return None
    return 100 * ctx.counters["attn_flops"] / ctx.peaks["bf16_flops"] / secs
