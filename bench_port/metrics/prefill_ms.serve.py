"""Mean host-clock time of one prefill dispatch (ViT, projector and the
LLM over the prompt, ending in a device-to-host read): the batcher's
`prefill_seconds` over its prefill count, in the window."""


def read(ctx):
    s = ctx.counters.get("stats")
    n = s and s["prefill_full"] + s["prefill_resumed"]
    if not n:
        return None
    return 1e3 * s["prefill_seconds"] / n
