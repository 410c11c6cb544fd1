"""Mean host time a decode dispatch spends in the device-to-host reads that
end it (waiting for the card to finish the chunk): the program span
`msm.serve.decode_read` (`models/serving.dispatch`) over its count."""

from bench_port.spans import mean_ms


def read(ctx):
    return mean_ms("msm.serve.decode_read", "host_s")
