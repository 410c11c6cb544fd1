"""The program's span store (`multi_spatialmllm_tpu_torch/utils/profiling`),
as the per-layer metrics read it. A span records only while a
torch.profiler session is on, so the store holds a `--trace 1` run's
traced window only. A span's `host_s` is host
seconds; its `device_s` is the stream-elapsed seconds between the CUDA
events recorded at its entry and exit, which include any time the stream
waited on the host inside the span."""


def mean_ms(name: str, field: str):
    """`field` (`"host_s"` or `"device_s"`) of span `name` over its count,
    in ms; None where the span never ran or the program has no store."""
    from multi_spatialmllm_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)   # no store: no spans
    s = snapshot and snapshot().get(name)
    if not s or not s["count"]:
        return None
    return 1e3 * s[field] / s["count"]
