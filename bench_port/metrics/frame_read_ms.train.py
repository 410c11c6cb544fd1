"""Mean host time to read and decode one frame file in the training window:
the program span `msm.image.read` (`__main__._read_image`, on the feed's
producer thread) over its count."""

from bench_port.spans import mean_ms


def read(ctx):
    return mean_ms("msm.image.read", "host_s")
