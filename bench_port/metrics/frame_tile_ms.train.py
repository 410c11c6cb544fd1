"""Mean host time to tile one frame in the training window (INTER_AREA
resizes, crops, normalisation): the program span `msm.image.tile`
(`models/preprocess.tile_image`, on the feed's producer thread) over its
count."""

from bench_port.spans import mean_ms


def read(ctx):
    return mean_ms("msm.image.tile", "host_s")
