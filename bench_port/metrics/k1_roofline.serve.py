"""K1's share of its roofline in serving: the attention FLOPs the
window's prefills require (the ViT's tiles and the LLM's causal prompt) at
the bf16 peak, over the traced time of the kernels matching PATTERNS."""

from bench_port import harness

PATTERNS = ('flash_fwd',)


def read(ctx):
    t = ctx.trace_summary
    if t is None or not ctx.peaks:
        return None
    secs = harness.kernel_seconds(t, PATTERNS)
    if secs <= 0:
        return None
    return (100 * ctx.counters["prefill_attn_flops"]
            / ctx.peaks["bf16_flops"] / secs)
