"""Mean stream-elapsed time of a training step's loss (the float32
next-token nll over the logits): the CUDA events of the program span
`msm.train.loss` (`parallel/train.make_train_step`) over its count."""

from bench_port.spans import mean_ms


def read(ctx):
    return mean_ms("msm.train.loss", "device_s")
