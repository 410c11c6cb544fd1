"""The port's `train` command with `--lora-rank`, `--eval-*`/`--mc-logprob`
and `--async-save` against the JAX CLI, `AsyncRollingSaver` on its own
(the JAX package's tests/test_mixture.py cases), and the flagship LoRA
run's remat.

Both CLIs start from the same float32 weights (`--init-checkpoint`: an
orbax save of Flax-initialised params for JAX, its `models/convert.py`
state dict for the port) and read the same PNG frames, at the tiny config
computing in float32 (each CLI's `tiny` is patched so: bf16 compute rounds
differently in the two implementations) with vocabulary 783, the
tokenizer's own, so eval answers decode on both sides.

Bounds: every logged loss and the summary's first and last loss within
LOSS_REL relative; eval events (step, accuracy, count) and
`eval_accuracy` equal; the same checkpoint layout (step dirs and LATEST),
the saved (merged) params within PARAM_ATOL of JAX's and no optimizer
state for a LoRA run.
"""

import argparse
import dataclasses
import json
import os
import re

import cv2
import jax
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu import __main__ as jcli
from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.parallel.train import (
    restore_checkpoint as j_restore,
)
from multi_spatialmllm_tpu.parallel.train import save_checkpoint as j_save
from multi_spatialmllm_tpu_torch import __main__ as tcli
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)
from multi_spatialmllm_tpu_torch.parallel import train as PT

VOCAB = 783
LOSS_REL = 1e-5
PARAM_ATOL = 1e-5


def _f32(cfg):
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype="float32"),
        llm=dataclasses.replace(cfg.llm, dtype="float32"))


@pytest.fixture(autouse=True)
def tiny_in_float32(monkeypatch):
    monkeypatch.setattr(JM, "tiny_config",
                        lambda f=JM.tiny_config: _f32(f()))
    monkeypatch.setitem(TM.CONFIGS, "tiny",
                        lambda f=TM.CONFIGS["tiny"]: _f32(f()))


def _world(tmp_path):
    """Frames, a one-dataset mixture, an eval JSONL (decoded and
    multiple-choice records), and the initial weights for both CLIs."""
    rng = np.random.default_rng(11)
    (tmp_path / "imgs").mkdir()
    recs, evals = [], []
    for i in range(6):
        name = f"im{i}.png"
        cv2.imwrite(str(tmp_path / "imgs" / name),
                    rng.integers(0, 255, (56, 72, 3), dtype=np.uint8))
        recs.append({"id": f"s{i}", "image": [name], "conversations": [
            {"from": "human", "value": "<image>\nhow far is the chair?"},
            {"from": "gpt", "value": f"{100 + 7 * i} mm"}]})
        evals.append({"id": f"e{i}", "image": [name],
                      "text": "<image>\nhow far is the chair?",
                      "question_type": "depth_estimation_coor",
                      "gt_value": 100 + 7 * i})
    evals.append({"id": "mc", "image": ["im0.png", "im1.png"],
                  "text": "<image>\n<image>\nWhich point corresponds?",
                  "question_type": "visual_correspondence_multiple_choice",
                  "gt_value": "A"})
    (tmp_path / "train.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    (tmp_path / "eval.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in evals))
    (tmp_path / "mix.json").write_text(json.dumps(
        {"spa": {"root": "imgs", "annotation": "train.jsonl",
                 "repeat_time": 1}}))
    cfg = JM.tiny_config()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                           vocab_size=VOCAB))
    model = JM.MultiFrameMLLM(cfg)
    b = JM.make_example_batch(cfg, batch=1, n_tiles=1, seq_len=64)
    params = jax.jit(model.init)(jax.random.key(2), b["input_ids"],
                                 b["tiles"])
    j_save(str(tmp_path / "init_orbax"), params, step=0)
    torch.save(jax_params_to_state_dict(params, cfg), tmp_path / "init.pt")
    return cfg


def _events(err: str, kind: str) -> list[dict]:
    out = []
    for line in err.splitlines():
        m = re.match(rf"\[train\] {kind} (.*)$", line)
        if m:
            out.append(dict(kv.split("=", 1) for kv in m.group(1).split()))
    return out


def _both(tmp_path, monkeypatch, capsys, flags, out=None):
    """Run the JAX CLI, then the port's, with `flags`; returns each
    side's (summary, stderr)."""
    common = ["train", "--meta", str(tmp_path / "mix.json"), "--config",
              "tiny", "--vocab-size", str(VOCAB), "--steps", "4",
              "--batch-size", "2", "--seq-len", "128", "--max-tiles", "1",
              "--tiles-per-image", "1", "--warmup", "1", "--lr", "1e-3",
              "--log-every", "1", "--seed", "3", *flags]
    runs = []
    for side in ("jax", "port"):
        extra = ["--init-checkpoint", str(tmp_path / (
            "init_orbax" if side == "jax" else "init.pt"))]
        if out:
            extra += ["--output", str(tmp_path / f"{out}_{side}")]
        if side == "jax":
            monkeypatch.setattr("sys.argv", ["prog", *common, *extra,
                                             "--data-parallel", "1"])
            jcli.main()
        else:
            tcli.main([*common, *extra, "--device", "cpu"])
        cap = capsys.readouterr()
        summary = json.loads([ln for ln in cap.out.splitlines()
                              if ln.startswith("{")][-1])
        runs.append((summary, cap.err))
    return runs


def _close(a, b):
    return abs(float(a) - float(b)) <= LOSS_REL * abs(float(b))


def _assert_same_losses(j, t):
    (js, jerr), (ts, terr) = j, t
    assert ts["steps"] == js["steps"]
    for key in ("first_loss", "last_loss"):
        assert _close(ts[key], js[key]), (key, ts[key], js[key])
    jsteps, tsteps = _events(jerr, "step"), _events(terr, "step")
    assert [e["step"] for e in tsteps] == [e["step"] for e in jsteps]
    for a, b in zip(tsteps, jsteps):
        assert _close(a["loss"], b["loss"]), (a, b)


def test_lora_train_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """`--lora-rank 4` with rolling saves: the same `lora` event, losses,
    checkpoint layout, and merged params with no optimizer state."""
    cfg = _world(tmp_path)
    j, t = _both(tmp_path, monkeypatch, capsys,
                 ["--lora-rank", "4", "--save-every", "2", "--keep", "2"],
                 out="ck")
    _assert_same_losses(j, t)
    assert _events(t[1], "lora") == _events(j[1], "lora") == [
        # a layer: wq and wo 128x4 + 4x128, wk and wv 128x4 + 4x64
        {"rank": "4", "trainable": str(2 * (2 * 1024 + 2 * 768))}]
    _same_saves(tmp_path, cfg, "ck", lora=True)


def _same_saves(tmp_path, cfg, out, lora):
    jroot, troot = tmp_path / f"{out}_jax", tmp_path / f"{out}_port"
    jdirs = sorted(d for d in os.listdir(jroot) if d.startswith("step_"))
    assert sorted(d for d in os.listdir(troot)
                  if d.startswith("step_")) == jdirs
    assert (troot / "LATEST").read_text() == (jroot / "LATEST").read_text()
    got = PT.restore_checkpoint(str(troot))
    want = j_restore(str(jroot))
    assert got["step"] == int(want["step"])
    assert ("opt_state" in got) == (not lora) == ("opt_state" in want)
    wparams = jax_params_to_state_dict(want["params"], cfg)
    for k, v in wparams.items():
        err = float((got["params"][k] - v).abs().max())
        assert err <= PARAM_ATOL, (k, err)


@pytest.mark.parametrize("mc", [False, True], ids=["decode", "mc_logprob"])
def test_train_eval_matches_the_jax_cli(tmp_path, monkeypatch, capsys, mc):
    """`--eval-jsonl/--eval-every/--eval-images-root/--eval-limit/
    --eval-max-new-tokens` (and `--mc-logprob`) over a LoRA run: the same
    eval events and `eval_accuracy` as the JAX CLI."""
    _world(tmp_path)
    j, t = _both(tmp_path, monkeypatch, capsys, [
        "--lora-rank", "4", "--eval-jsonl", str(tmp_path / "eval.jsonl"),
        "--eval-every", "2", "--eval-images-root", str(tmp_path / "imgs"),
        "--eval-limit", "5", "--eval-max-new-tokens", "6",
        *(["--mc-logprob"] if mc else [])])
    _assert_same_losses(j, t)
    jev, tev = _events(j[1], "eval"), _events(t[1], "eval")
    assert [e["step"] for e in jev] == ["2", "4"]
    assert tev == jev
    assert t[0]["eval_accuracy"] == j[0]["eval_accuracy"]


def test_async_save_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """`--async-save --save-every 1` on a full fine-tune: the JAX CLI's
    checkpoint layout and LATEST, the full state (with optimizer) saved,
    the same params."""
    cfg = _world(tmp_path)
    j, t = _both(tmp_path, monkeypatch, capsys,
                 ["--async-save", "--save-every", "1", "--keep", "2"],
                 out="as")
    _assert_same_losses(j, t)
    assert [e["step"] for e in _events(t[1], "checkpoint")] == \
        [e["step"] for e in _events(j[1], "checkpoint")]
    jroot, troot = tmp_path / "as_jax", tmp_path / "as_port"
    jdirs = sorted(d for d in os.listdir(jroot) if d.startswith("step_"))
    assert sorted(d for d in os.listdir(troot)
                  if d.startswith("step_")) == jdirs
    assert (troot / "LATEST").read_text() == (jroot / "LATEST").read_text()
    got = PT.restore_checkpoint(str(troot))
    assert got["step"] == 4 and "opt_state" in got
    # a full fine-tune's params move by up to lr an element (Adam); they
    # are held as tests/test_torch_training.py holds them
    want = jax_params_to_state_dict(j_restore(str(jroot))["params"], cfg)
    lr_sum = sum(PT.learning_rate(PT.TrainConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=4), i)
        for i in range(4))
    for k, v in want.items():
        assert float((got["params"][k] - v).abs().max()) <= lr_sum, k


def test_async_saver_defers_latest_and_copies_on_save(tmp_path):
    """LATEST commits only after a write is complete (on the next save or
    on wait), pruning keeps `keep`, and each save holds the values at
    save time though the caller's tensors change in place right after."""
    root = str(tmp_path / "ackpts")
    saver = PT.AsyncRollingSaver(root, keep=2)
    w = torch.arange(8.0)
    for step in (1, 2, 3):
        saver.save({"w": w}, step=step)
        if step == 1:
            assert not os.path.exists(os.path.join(root, "LATEST"))
        w.add_(1.0)                       # an in-place update, as AdamW's
    saver.wait()
    dirs = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    assert dirs == ["step_00000002", "step_00000003"]
    assert PT.resolve_checkpoint(root).endswith("step_00000003")
    got = PT.restore_checkpoint(root)
    assert torch.equal(got["params"]["w"], torch.arange(8.0) + 2.0)
    assert got["step"] == 3 and "opt_state" not in got
    got2 = PT.restore_checkpoint(os.path.join(root, "step_00000002"))
    assert torch.equal(got2["params"]["w"], torch.arange(8.0) + 1.0)


def test_prune_ignores_leftovers_and_saver_clears_them(tmp_path):
    """A half-written async directory never takes a `keep` slot, and a
    new saver clears it."""
    root = str(tmp_path / "ckpts")
    params = {"w": torch.arange(4.0)}
    PT.save_checkpoint_rolling(root, params, step=1, keep=1)
    stale = os.path.join(root, "step_00000002.async-tmp")
    os.makedirs(stale)
    PT.save_checkpoint_rolling(root, params, step=3, keep=1)
    dirs = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    assert "step_00000003" in dirs and "step_00000001" not in dirs
    assert PT.resolve_checkpoint(root).endswith("step_00000003")
    PT.AsyncRollingSaver(root, keep=1)
    assert not os.path.exists(stale)


def test_async_saver_surfaces_a_failed_write(tmp_path):
    saver = PT.AsyncRollingSaver(str(tmp_path / "r"), keep=1)
    saver.save({"w": lambda: 0}, step=1)    # torch.save cannot pickle it
    with pytest.raises(Exception):
        saver.wait()
    assert os.listdir(tmp_path / "r") == ["step_00000001.async-tmp"]
    PT.AsyncRollingSaver(str(tmp_path / "r"))
    assert os.listdir(tmp_path / "r") == []


@pytest.mark.parametrize("config,lora_rank,remat", [
    ("flagship", 16, True), ("flagship", 0, False), ("tiny", 4, False),
    ("bench", 16, True)])
def test_train_config_remats_the_flagship_under_lora(config, lora_rank,
                                                     remat):
    """`train --lora-rank` on the flagship recomputes each LLM layer in the
    backward (its whole-depth activations would not fit beside the frozen
    base on one card); every other config keeps its own remat (bench's is
    already on), and nothing else changes."""
    args = argparse.Namespace(config=config, lora_rank=lora_rank,
                              vocab_size=0, moe_experts=0)
    cfg = tcli._train_config(args)
    assert cfg.llm.remat is remat
    base = TM.CONFIGS[config]()
    assert dataclasses.replace(cfg.llm, remat=base.llm.remat) == base.llm
    assert cfg.vit == base.vit


@pytest.mark.parametrize("flags,error,match", [
    (["--model-parallel", "2"], ValueError, r"\(data x 2 model x 1 seq x 1 "
     r"expert\) does not match the 1 process"),
    (["--seq-parallel", "2"], ValueError, r"\(data x 1 model x 2 seq x 1 "
     r"expert\) does not match the 1 process"),
    (["--expert-parallel", "2"], ValueError, r"\(data x 1 model x 1 seq x 2 "
     r"expert\) does not match the 1 process"),
    (["--fsdp", "--model-parallel", "3", "--world", "2"], ValueError,
     "3 model x 1 seq x 1 expert\\) does not match the 2 process"),
    (["--data-parallel", "2"], ValueError,
     r"\(2 x 1 model x 1 seq x 1 expert\) does not match the 1 process"),
    (["--data-parallel", "3", "--world", "2"], ValueError,
     r"\(3 x 1 model x 1 seq x 1 expert\) does not match the 2 process"),
], ids=["model", "seq", "expert", "fsdp", "data-alone", "data-world"])
def test_train_guards_raise_before_device_work(tmp_path, monkeypatch, flags,
                                               error, match):
    """A mesh (`--data-parallel` x `--model-parallel` x `--seq-parallel` x
    `--expert-parallel`, with or without `--fsdp`) that does not fit the
    launched world (alone, or under a launcher's WORLD_SIZE) raises before
    the mixture is read, a model built or a process group started."""
    import torch.distributed as dist

    if "--world" in flags:
        i = flags.index("--world")
        monkeypatch.setenv("WORLD_SIZE", flags[i + 1])
        flags = flags[:i]
    else:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    built = []
    monkeypatch.setattr(TM, "MultiFrameMLLM",
                        lambda *a, **k: built.append(a))
    with pytest.raises(error, match=match):
        tcli.main(["train", "--meta", str(tmp_path / "absent.json"),
                   "--device", "cpu", *flags])
    assert not built and not dist.is_initialized()
