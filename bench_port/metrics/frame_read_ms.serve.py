"""Mean host time to read and decode one frame file in the serving window:
the program span `msm.image.read` (`__main__._read_image`) over its
count."""

from bench_port.spans import mean_ms


def read(ctx):
    return mean_ms("msm.image.read", "host_s")
