"""Share of the card's busy time in training spent in kernels that are
neither library matrix products (harness.GEMM_MARKERS) nor the port's own
kernels (harness.PORT_MARKERS), copies and sets left out: the casts,
norms, activations and optimizer passes."""

from bench_port import harness

PATTERNS = ('Memcpy', 'Memset')


def read(ctx):
    t = ctx.trace_summary
    if t is None or t["busy_s"] <= 0:
        return None
    other = sum(s for n, s in t["kernel_s"].items()
                if not any(m in n.lower() for m in harness.GEMM_MARKERS)
                and not any(m in n for m in harness.PORT_MARKERS)
                and not any(m in n for m in PATTERNS))
    return 100 * other / t["busy_s"]
