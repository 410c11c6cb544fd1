"""Mean stream-elapsed time of a training forward's decoder, lm_head
included: the CUDA events of the program span `msm.model.llm`
(`MultiFrameMLLM.forward`) over its count."""

from bench_port.spans import mean_ms


def read(ctx):
    return mean_ms("msm.model.llm", "device_s")
