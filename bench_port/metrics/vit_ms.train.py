"""Mean stream-elapsed time of a training forward's vision part (ViT,
pixel shuffle, projector; its remat recompute is the backward's): the
CUDA events of the program span `msm.model.vit`
(`MultiFrameMLLM.encode_tiles`) over its count."""

from bench_port.spans import mean_ms


def read(ctx):
    return mean_ms("msm.model.vit", "device_s")
