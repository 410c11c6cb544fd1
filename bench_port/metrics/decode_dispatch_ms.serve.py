"""Mean host-clock time of one decode dispatch (a chunk of steps over
every slot, ending in a device-to-host read): the batcher's
`decode_seconds` over `decode_dispatches`, in the window."""


def read(ctx):
    s = ctx.counters.get("stats")
    if not s or not s["decode_dispatches"]:
        return None
    return 1e3 * s["decode_seconds"] / s["decode_dispatches"]
