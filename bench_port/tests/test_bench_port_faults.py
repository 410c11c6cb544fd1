"""A run with the timed path broken underneath comes out not correct, and
so does the control; the look for a card is skipped, the rest of the run
is the benchmark's own (the tiny model on the CPU, computing in float32 so
that a sound run reads at round-off: the cells' limits are set for
bfloat16 at full size)."""

import pytest

from bench_port import run

from .tiny import tiny_overrides

SEED = 2 ** 31 + 77


def run_tiny(cell: str, **kw) -> dict:
    return run.run_cell(cell, SEED, 3.0, False, "cpu",
                        overrides=tiny_overrides(cell, "float32", **kw))


@pytest.mark.parametrize("cell", ["internvl2_2b.sft",
                                  "internvl2_8b.spatial_qa"])
def test_a_sound_run_is_correct(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert list(res["checks"])[-1] and list(res)[-1] == "checks"


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    from multi_spatialmllm_tpu_torch.parallel import train as T

    monkeypatch.setattr(T.AdamW, "update",
                        lambda self, grads: self.global_norm(grads))
    res = run_tiny("internvl2_2b.sft")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(monkeypatch):
    from multi_spatialmllm_tpu_torch.parallel import train as T

    real = T.make_train_step

    def halved(model, opt, **kw):
        step = real(model, opt, **kw)

        def run_half(batch):
            n = batch["input_ids"].shape[0] // 2
            return step({k: v[:n] for k, v in batch.items()})
        return run_half

    monkeypatch.setattr(T, "make_train_step", halved)
    assert not run_tiny("internvl2_2b.sft")["correct"]


def test_a_served_token_altered(monkeypatch):
    from multi_spatialmllm_tpu_torch.models import paged_kv as K

    real = K.PagedBatcher.generate_stream

    def altered(self, requests):
        for rid, toks, fin in real(self, requests):
            yield rid, [(t + 1) % 1024 for t in toks], fin

    monkeypatch.setattr(K.PagedBatcher, "generate_stream", altered)
    assert not run_tiny("internvl2_8b.spatial_qa")["correct"]


def test_the_training_control_fails():
    """The reference in bfloat16 (weights, moments, products) in the
    program's place fails one of the cell's numbers."""
    import time

    import torch

    from bench_port import calibrate, harness
    from bench_port.run import Context

    cell = "internvl2_2b.sft"
    spec = harness.load_json(harness.HERE, "workloads", f"{cell}.json")
    ctx = Context(cell, spec, SEED, 1.0, False, torch.device("cpu"),
                  time.perf_counter(), tiny_overrides(cell, "bfloat16"))
    got = calibrate.train_seed(ctx)
    lim = spec["limits"]
    assert any(got["control"][k] > lim[k] for k in lim)
    assert any(got["half_batch"][k] > lim[k] for k in lim)


@pytest.mark.cuda
def test_the_serving_control_fails_at_the_cells_size(cuda):
    """On the card, at the cell's own size: the program's int8 path reads
    past the limit (this is the run `calibrate.py` makes)."""
    import time

    from bench_port import calibrate, harness
    from bench_port.run import Context

    cell = "internvl2_8b.spatial_qa"
    spec = harness.load_json(harness.HERE, "workloads", f"{cell}.json")
    ctx = Context(cell, spec, SEED, 8.0, False, cuda, time.perf_counter())
    got = calibrate.serve_seed(ctx)
    limit = spec["limits"]["mean_logit_gap"]
    for read, correct in (("served", True), ("control", False)):
        check = harness.Check()
        check.at_most("mean_logit_gap", got[read]["mean"], limit)
        assert check.correct is correct, (read, got[read], limit)
