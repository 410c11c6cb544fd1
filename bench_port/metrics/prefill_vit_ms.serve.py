"""Mean stream-elapsed time of one ViT pass in serving (ViT, pixel
shuffle, projector over a request's tiles; a vision-cache hit runs none):
the CUDA events of the program span `msm.model.vit`
(`MultiFrameMLLM.encode_tiles`) over its count."""

from bench_port.spans import mean_ms


def read(ctx):
    return mean_ms("msm.model.vit", "device_s")
