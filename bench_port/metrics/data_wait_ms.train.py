"""Mean time a window's step waited on the program's batch iterator
(prefetch queue over packing, frame reading and tiling): the benchmark's
`data_wait` span around each `next()` it hands `train_steps`."""


def read(ctx):
    c = ctx.counters
    if not c.get("steps"):
        return None
    return 1e3 * c["data_wait_s"] / c["steps"]
