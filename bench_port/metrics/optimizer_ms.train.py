"""Mean stream-elapsed time of a training step's optimizer update (global
norm, clip, AdamW over every leaf): the CUDA events of the program span
`msm.train.optimizer` (`parallel/train.AdamW.update`) over its count."""

from bench_port.spans import mean_ms


def read(ctx):
    return mean_ms("msm.train.optimizer", "device_s")
