"""The port's `train` command over the mesh: `--model-parallel 2`,
`--seq-parallel 2`, `--expert-parallel 2 --moe-impl einsum` and `--fsdp
--data-parallel 2`, one after another in a world of `python -m
torch.distributed.run --nproc-per-node 2 ... --device cpu` (gloo), against
the JAX CLI on one
device from the same weights and mixture (tests/test_torch_train_cli.py's
fixture, with the vocabulary 784 so that it splits over the model axis);
every logged loss and the summary's first and last within LOSS_REL 1e-5
relative (that file's bound). `--expert-parallel 2 --moe-impl ragged`
raises with the JAX step's message. The world runs beside the JAX CLI runs
(processes of their own, with tests/conftest.py's JAX settings)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_train_cli as TC
from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.parallel.train import save_checkpoint as j_save
from multi_spatialmllm_tpu_torch.dryrun import free_port
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)
from test_torch_data_parallel import REPO, _f32
from test_torch_mesh_training import random_params
from torch_mesh_ranks import SEQUENTIAL_TRAIN, split_runs

# the JAX CLI in a process of its own, its `tiny` computing in float32
JAX_TRAIN = """
import dataclasses
import sys
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")
from multi_spatialmllm_tpu import __main__ as cli
from multi_spatialmllm_tpu.models import mllm as M
tiny = M.tiny_config
M.tiny_config = lambda: dataclasses.replace(
    tiny(), vit=dataclasses.replace(tiny().vit, dtype="float32"),
    llm=dataclasses.replace(tiny().llm, dtype="float32"))
sys.argv = ["prog", *sys.argv[1:]]
cli.main()
"""
# the port's `tiny` computing in float32, as the JAX CLI's
TINY_F32 = """
from multi_spatialmllm_tpu_torch.models import mllm as M
tiny = M.CONFIGS["tiny"]
M.CONFIGS["tiny"] = lambda: M.with_dtype(tiny(), "float32")
"""
VOCAB = 784
LOSS_REL = 1e-5
MOE = ["--moe-experts", "4", "--moe-impl"]
# name: (port flags, init weights, JAX flags of the reference run)
RUNS = {
    "model2": (["--model-parallel", "2"], "dense", []),
    "seq2": (["--seq-parallel", "2"], "dense", []),
    "fsdp_data2": (["--fsdp", "--data-parallel", "2"], "dense", []),
    "expert2_einsum": (["--expert-parallel", "2", *MOE, "einsum"], "moe",
                       [*MOE, "einsum"]),
}


def _common(tmp, steps=3):
    return ["train", "--meta", str(tmp / "mix.json"), "--config", "tiny",
            "--vocab-size", str(VOCAB), "--steps", str(steps),
            "--batch-size", "4", "--seq-len", "128", "--max-tiles", "1",
            "--tiles-per-image", "1", "--warmup", "1", "--lr", "1e-3",
            "--log-every", "1", "--seed", "3"]


def _launch(tmp, runs):
    """One `torch.distributed.run` world of 2 processes running the port's
    `train` for each argv of `runs`, one after another."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port",
         str(free_port()), str(tmp / "port_train.py"), json.dumps(runs)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _losses(err: str) -> list[float]:
    return [float(ln.split("loss=")[1].split()[0])
            for ln in err.splitlines() if "[train] step " in ln]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch's (returncode, summary, losses) and the JAX CLI's
    (summary, losses) for the dense and the MoE weights."""
    tmp = tmp_path_factory.mktemp("mesh_cli")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JM, "tiny_config", lambda f=JM.tiny_config: _f32(f()))
        mp.setattr(TC, "VOCAB", VOCAB)
        TC._world(tmp)                       # frames, mixture, dense init
        (tmp / "init_orbax").rename(tmp / "dense_orbax")
        (tmp / "init.pt").rename(tmp / "dense.pt")
        cfg = JM.tiny_moe_config()
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, vocab_size=VOCAB))
        moe = random_params(cfg, 5)
        j_save(str(tmp / "moe_orbax"), moe, step=0)
        torch.save(jax_params_to_state_dict(moe, cfg), tmp / "moe.pt")
        (tmp / "port_train.py").write_text(TINY_F32 + SEQUENTIAL_TRAIN)
        names = [*RUNS, "ragged"]
        flags = {name: RUNS[name][:2] for name in RUNS}
        flags["ragged"] = (["--expert-parallel", "2", *MOE, "ragged"], "moe")
        world = _launch(tmp, [
            [*_common(tmp), "--init-checkpoint", str(tmp / f"{init}.pt"),
             "--device", "cpu", *f] for f, init in
            (flags[name] for name in names)])
        (tmp / "jax_train.py").write_text(JAX_TRAIN)
        jax_procs = {init: subprocess.Popen(
            [sys.executable, str(tmp / "jax_train.py"), *_common(tmp),
             *flags, "--init-checkpoint", str(tmp / f"{init}_orbax"),
             "--data-parallel", "1"],
            env=dict(os.environ, JAX_PLATFORMS="cpu",
                     PYTHONPATH=REPO + os.pathsep + os.environ.get(
                         "PYTHONPATH", "")), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for init, flags in (("dense", []), ("moe", [*MOE, "einsum"]))}
        ref = {}
        for init, p in jax_procs.items():
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            summary = json.loads([ln for ln in out.splitlines()
                                  if ln.startswith("{")][-1])
            ref[init] = (summary, _losses(err))
        out, err = world.communicate(timeout=300)
        assert world.returncode == 0, out[-2000:] + err[-3000:]
        done = {}
        for name, o, e in zip(names, split_runs(out, len(names)),
                              split_runs(err, len(names))):
            summaries = [json.loads(ln) for ln in o.splitlines()
                         if ln.startswith("{")]
            done[name] = (summaries, _losses(e), o + e)
        return done, ref
    finally:
        mp.undo()


@pytest.mark.parametrize("name", list(RUNS))
def test_train_cli_mesh_matches_jax(runs, name):
    done, ref = runs
    summaries, losses, log = done[name]
    assert len(summaries) == 1, log[-3000:]
    j_sum, j_losses = ref[RUNS[name][1]]
    t_sum = summaries[0]
    assert t_sum["devices"] == 2
    assert len(losses) == len(j_losses) == 3
    for got, want in zip(losses + [t_sum["first_loss"], t_sum["last_loss"]],
                         j_losses + [j_sum["first_loss"],
                                     j_sum["last_loss"]]):
        assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
    mesh = t_sum["mesh"]
    axis = {"model2": "model", "seq2": "seq", "fsdp_data2": "data",
            "expert2_einsum": "expert"}[name]
    assert mesh[axis] == 2 and np.prod(list(mesh.values())) == 2


def test_train_cli_ragged_on_expert_axis_raises(runs):
    summaries, _, log = runs[0]["ragged"]
    assert not summaries
    assert "moe_impl='ragged' is single-chip/data-parallel only" in log
    assert "'expert' mesh axis (size 2)" in log
