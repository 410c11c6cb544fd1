"""Mean stream-elapsed time of a training step's backward, remat recompute
included: the CUDA events of the program span `msm.train.backward`
(`parallel/train.make_train_step`) over its count."""

from bench_port.spans import mean_ms


def read(ctx):
    return mean_ms("msm.train.backward", "device_s")
