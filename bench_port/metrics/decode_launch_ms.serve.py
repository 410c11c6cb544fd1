"""Mean host time a decode dispatch spends enqueueing its chunk of steps
(`models/serving.decode_chunk`: every layer's ops, from Python): the
program span `msm.serve.decode_launch` (`models/serving.dispatch`) over
its count. Measured under the profiler, which adds its own cost to each
op it records."""

from bench_port.spans import mean_ms


def read(ctx):
    return mean_ms("msm.serve.decode_launch", "host_s")
