"""K7's share of its roofline: the bytes the live slots' decode steps
need (bench_port/flops.decode_kv_bytes: the cached kv rows read, the new
row in and out, query and output) at the HBM bandwidth, over the traced
time of the kernels matching PATTERNS."""

from bench_port import harness

PATTERNS = ('paged_decode',)


def read(ctx):
    t = ctx.trace_summary
    if t is None or not ctx.peaks:
        return None
    secs = harness.kernel_seconds(t, PATTERNS)
    if secs <= 0 or not ctx.counters.get("decode_kv_bytes"):
        return None
    return (100 * ctx.counters["decode_kv_bytes"] / ctx.peaks["hbm_bytes"]
            / secs)
