"""Mean host time to turn a request line into the batcher's request
(frame files read and decoded, tiles made, prompt ids built): the
benchmark's `window_prep` span around the command's `to_request`, over
the window's requests."""


def read(ctx):
    c = ctx.counters
    if not c.get("preps"):
        return None
    return 1e3 * c["prep_s"] / c["preps"]
