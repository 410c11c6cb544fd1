"""Data-parallel training in the port (parallel/train.make_train_step and
parallel/lora.make_lora_train_step over a mesh's data axis, and `train
--data-parallel 2` under the launcher) against the JAX step on one device
over the GLOBAL batch, at the tiny config in float32.

The world of 2 is two gloo processes on the CPU (`dryrun.run_world`), each
taking its rows of every global batch (`parallel/train.local_rows`); the
padded rows carry different token counts (rows of 40 + 7r tokens), so the
ranks' counts differ. Bounds are those of the single-device tests (stated
in tests/test_torch_training.py, test_torch_lora.py and
test_torch_train_cli.py): losses and grad norms within REL 1e-4 relative,
the first step's gradients (Adam's first moment after an update at learning
rate 0) within REL of each tensor's largest magnitude, each parameter's
change over the steps within UPDATE_REL of JAX's change in norm; LoRA losses within STEP_REL 1e-5 and
adapters within ADAPTER_ATOL 1e-5; CLI losses within LOSS_REL 1e-5. What
the world of 2 changes against one device is the order of the sums (each
rank sums its rows, the all-reduce adds the two), which these bounds hold.
The ranks end with bit-identical parameters. At world size 1 (a gloo group
of one in this process) every step equals the single-device step bit for
bit.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from multi_spatialmllm_tpu import __main__ as jcli
from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.parallel import lora as JLo
from multi_spatialmllm_tpu.parallel import train as JT
from multi_spatialmllm_tpu.parallel.mesh import make_mesh as j_make_mesh
from multi_spatialmllm_tpu_torch.dryrun import free_port, run_world
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_lora_to_port,
    jax_params_to_state_dict,
)
from multi_spatialmllm_tpu_torch.parallel import lora as TL
from multi_spatialmllm_tpu_torch.parallel import train as PT
from multi_spatialmllm_tpu_torch.parallel.mesh import make_mesh
from test_torch_train_cli import VOCAB, _world
from test_torch_training import (
    jax_tiny_f32,
    jax_tiny_moe_f32,
    make_batch,
    port_tiny_moe_f32,
    to_torch,
)

REL = 1e-4
STEP_REL = 1e-5
ADAPTER_ATOL = 1e-5
LOSS_REL = 1e-5
LR = 1e-3
# each parameter's change (final minus initial) against JAX's, relative in
# norm: measured <= 8.3e-3 on the ViT's qkv biases (the key part has a zero
# gradient up to rounding, which Adam's normalisation amplifies; as in
# tests/test_torch_flops.py) and <= 8.5e-5 on the rest over the five
# cases; a skipped or wrong update is off by O(1)
UPDATE_REL = 2e-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# case: (moe overrides or None for dense, packed rows, accum, steps)
CASES = {
    "dense-padded-accum1": (None, False, 1, 3),
    "dense-packed-accum2": (None, True, 2, 3),
    "dense-padded-accum2": (None, False, 2, 3),
    "moe_ragged-packed-accum1": (dict(moe_impl="ragged",
                                      moe_kernel="pallas"), True, 1, 2),
    "moe_einsum-padded-accum2": (dict(), False, 2, 2),
}
ROWS = 4
LORA_TARGETS = ("wq", "wk", "wv", "wo")


def _batch(cfg, packed, seed):
    """A global batch of ROWS rows (packing may make one more: cut)."""
    return {k: v[:ROWS] for k, v in make_batch(cfg, packed, seed,
                                               rows=ROWS).items()}


def _tcfg(steps):
    return dict(learning_rate=LR, warmup_steps=1, total_steps=steps)


def _case_inputs():
    """For every case: the JAX model and params, the port's config and
    state dict, and the global numpy batches."""
    out = {}
    for name, (moe, packed, accum, steps) in CASES.items():
        jcfg = jax_tiny_f32() if moe is None else jax_tiny_moe_f32(**moe)
        tcfg = (TM.with_dtype(TM.tiny_config(), "float32") if moe is None
                else port_tiny_moe_f32(**moe))
        jmodel = JM.MultiFrameMLLM(jcfg)
        b0 = _batch(jcfg, packed, 50)
        params = jax.jit(jmodel.init)(jax.random.key(6),
                                      jnp.asarray(b0["input_ids"]),
                                      jnp.asarray(b0["tiles"]))
        batches = [_batch(jcfg, packed, 51 + i) for i in range(steps)]
        out[name] = dict(jmodel=jmodel, params=params, tcfg=tcfg,
                         state=jax_params_to_state_dict(params, jcfg),
                         batches=batches, accum=accum, jcfg=jcfg)
    return out


def _port_run(case, mesh):
    """The port's steps of one case on this process: losses, grad norms,
    Adam's first moment after step 0, and the final state dict."""
    model = TM.MultiFrameMLLM(case["tcfg"], param_dtype=torch.float32)
    model.load_state_dict(case["state"])
    opt = PT.AdamW(list(model.named_parameters()),
                   PT.TrainConfig(**_tcfg(len(case["batches"]))))
    step = PT.make_train_step(model, opt, accum_steps=case["accum"],
                              mesh=mesh)
    losses, norms, mu0 = [], [], None
    for i, b in enumerate(case["batches"]):
        if mesh is not None:
            b = PT.local_rows(b, case["accum"], mesh)
        m = step(to_torch(b))
        losses.append(m["loss"].clone())
        norms.append(m["grad_norm"].clone())
        if i == 0:
            mu0 = {k: v.clone() for k, v in opt.state_dict()["mu"].items()}
    return dict(losses=losses, norms=norms, mu0=mu0,
                params={k: v.clone() for k, v in model.state_dict().items()})


def _lora_run(tcfg, state, jlora_np, batches, mesh):
    model = TM.MultiFrameMLLM(tcfg, param_dtype=torch.float32)
    model.load_state_dict(state)
    tlora = {k: {p: torch.tensor(v) for p, v in ad.items()}
             for k, ad in jlora_np.items()}
    opt = PT.AdamW(TL.lora_named_tensors(tlora),
                   PT.TrainConfig(**_tcfg(len(batches))))
    step = TL.make_lora_train_step(
        model, opt, TL.LoRAConfig(rank=4, targets=LORA_TARGETS), mesh=mesh)
    losses, norms = [], []
    for b in batches:
        if mesh is not None:
            b = PT.local_rows(b, 1, mesh)
        m = step(to_torch(b))
        losses.append(m["loss"].clone())
        norms.append(m["grad_norm"].clone())
    return dict(losses=losses, norms=norms,
                lora={k: {p: t.detach().clone() for p, t in ad.items()}
                      for k, ad in tlora.items()})


def dp_rank(cases: dict, lora_case: dict) -> dict:
    """One rank of the world: every case's steps over the mesh."""
    mesh = make_mesh()
    out = {name: _port_run(c, mesh) for name, c in cases.items()}
    out["lora"] = _lora_run(mesh=mesh, **lora_case)
    return out


def _picklable(case):
    return {k: case[k] for k in ("tcfg", "state", "batches", "accum")}


def _lora_inputs():
    cfg = jax_tiny_f32()
    jmodel = JM.MultiFrameMLLM(cfg)
    b0 = _batch(cfg, True, 60)
    params = jax.jit(jmodel.init)(jax.random.key(7),
                                  jnp.asarray(b0["input_ids"]),
                                  jnp.asarray(b0["tiles"]))
    lc = JLo.LoRAConfig(rank=4, targets=LORA_TARGETS)
    jlora = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                   JLo.init_lora(params, lc,
                                                 jax.random.key(8)))
    batches = [_batch(cfg, False, 61 + i) for i in range(3)]
    port = dict(tcfg=TM.with_dtype(TM.tiny_config(), "float32"),
                state=jax_params_to_state_dict(params, cfg),
                jlora_np={k: {p: t.numpy() for p, t in ad.items()}
                          for k, ad in jax_lora_to_port(jlora).items()},
                batches=batches)
    return jmodel, params, jlora, lc, port


@pytest.fixture(scope="module")
def inputs():
    return _case_inputs(), _lora_inputs()


@pytest.fixture(scope="module")
def world2(inputs):
    cases, (_, _, _, _, lora_port) = inputs
    return run_world(2, "test_torch_data_parallel:dp_rank",
                     ({n: _picklable(c) for n, c in cases.items()},
                      lora_port), device="cpu", timeout=600)


def _jax_steps(case):
    mesh = j_make_mesh(n_data=1, devices=jax.devices()[:1])
    tx = JT.make_optimizer(JT.TrainConfig(**_tcfg(len(case["batches"]))))
    jstep = JT.make_train_step(case["jmodel"], tx, mesh,
                               accum_steps=case["accum"])
    jparams = jax.tree_util.tree_map(jnp.array, case["params"])
    jopt = tx.init(jparams)
    losses, norms, mu0 = [], [], None
    for i, b in enumerate(case["batches"]):
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(jm["loss"]))
        norms.append(float(jm["grad_norm"]))
        if i == 0:
            mu0 = jax_params_to_state_dict(jopt[1][0].mu, case["jcfg"])
    return losses, norms, mu0, jax_params_to_state_dict(jparams,
                                                        case["jcfg"])


@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_step_matches_jax_global_batch(inputs, world2, name):
    """Two ranks, each on its rows, against JAX's one-device step on the
    global batch: losses and grad norms, the first gradients, the
    change of each parameter over the steps; the two ranks bit-identical. The MoE
    cases' load-balance statistic is the global batch's."""
    case = inputs[0][name]
    losses, norms, mu0, p_j = _jax_steps(case)
    r0, r1 = world2[0][name], world2[1][name]
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    for i in range(len(losses)):
        for got, want in ((r0["losses"][i], losses[i]),
                          (r0["norms"][i], norms[i])):
            assert abs(float(got) - want) <= REL * abs(want), (i, got, want)
    for k, m in r0["mu0"].items():
        want = mu0[k].numpy()
        err = np.abs(m.numpy() - want).max()
        assert err <= REL * np.abs(want).max() + 1e-12, (k, err)
    init = case["state"]
    for k, p in r0["params"].items():
        moved, want = p - init[k], p_j[k] - init[k]
        err = ((moved - want).norm() / want.norm()).item()
        assert err <= UPDATE_REL, (k, err)


def test_data_parallel_lora_matches_jax_global_batch(inputs, world2):
    """`make_lora_train_step` over two ranks against JAX's on one device
    over the global batch: only the adapters' gradients are summed."""
    jmodel, params, jlora, lc, port = inputs[1]
    tx = JT.make_optimizer(JT.TrainConfig(**_tcfg(len(port["batches"]))))
    mesh = j_make_mesh(n_data=1, devices=jax.devices()[:1])
    jstep = JLo.make_lora_train_step(jmodel, tx, mesh, lc)
    jopt = tx.init(jlora)
    r0, r1 = world2[0]["lora"], world2[1]["lora"]
    for i, b in enumerate(port["batches"]):
        jlora, jopt, jm = jstep(jlora, jopt, params,
                                {k: jnp.asarray(v) for k, v in b.items()})
        for got, key in ((r0["losses"][i], "loss"),
                         (r0["norms"][i], "grad_norm")):
            want = float(jm[key])
            assert abs(float(got) - want) <= STEP_REL * abs(want), (i, key)
    want = jax_lora_to_port(jlora)
    for k, ad in r0["lora"].items():
        for part in ("a", "b"):
            assert torch.equal(ad[part], r1["lora"][k][part]), (k, part)
            err = float((ad[part] - want[k][part]).abs().max())
            assert err <= ADAPTER_ATOL, (k, part, err)


@pytest.fixture()
def world_of_one():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def test_world_of_one_is_the_single_device_step(inputs, world_of_one):
    """At world size 1 the collectives leave every value as it is: every
    case's losses, norms, moments and parameters, and LoRA's, equal the
    step without a mesh bit for bit."""
    cases, (_, _, _, _, lora_port) = inputs
    for name, case in cases.items():
        a, b = _port_run(case, world_of_one), _port_run(case, None)
        for x, y in zip(a["losses"] + a["norms"], b["losses"] + b["norms"]):
            assert torch.equal(x, y), name
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k]), (name, k)
            assert torch.equal(a["mu0"][k], b["mu0"][k]), (name, k)
    a = _lora_run(mesh=world_of_one, **lora_port)
    b = _lora_run(mesh=None, **lora_port)
    assert all(torch.equal(x, y) for x, y in zip(a["losses"], b["losses"]))
    for k, ad in a["lora"].items():
        for part in ("a", "b"):
            assert torch.equal(ad[part], b["lora"][k][part]), (k, part)


def _f32(cfg):
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype="float32"),
        llm=dataclasses.replace(cfg.llm, dtype="float32"))


PORT_TRAIN = """
import sys
from multi_spatialmllm_tpu_torch import __main__ as cli
from multi_spatialmllm_tpu_torch.models import mllm as M
tiny = M.CONFIGS["tiny"]
M.CONFIGS["tiny"] = lambda: M.with_dtype(tiny(), "float32")
cli.main(sys.argv[1:])
"""


def test_train_cli_data_parallel_matches_jax(tmp_path, monkeypatch, capsys):
    """`python -m torch.distributed.run --nproc-per-node 2 ... train
    --data-parallel 2 --device cpu` (gloo) against the JAX CLI with
    `--data-parallel 1` on one device, from the same weights and mixture:
    every logged loss and the summary's within LOSS_REL; rank 0 alone logs,
    saves (one checkpoint event a save) and prints the summary."""
    monkeypatch.setattr(JM, "tiny_config",
                        lambda f=JM.tiny_config: _f32(f()))
    _world(tmp_path)
    common = ["train", "--meta", str(tmp_path / "mix.json"), "--config",
              "tiny", "--vocab-size", str(VOCAB), "--steps", "3",
              "--batch-size", "4", "--accum", "2", "--seq-len", "128",
              "--max-tiles", "1", "--tiles-per-image", "1", "--warmup", "1",
              "--lr", "1e-3", "--log-every", "1", "--seed", "3",
              "--save-every", "2"]
    monkeypatch.setattr("sys.argv", [
        "prog", *common, "--init-checkpoint", str(tmp_path / "init_orbax"),
        "--output", str(tmp_path / "out_jax"), "--data-parallel", "1"])
    jcli.main()
    cap = capsys.readouterr()
    j_sum = json.loads([ln for ln in cap.out.splitlines()
                        if ln.startswith("{")][-1])
    j_losses = [float(ln.split("loss=")[1].split()[0])
                for ln in cap.err.splitlines() if "[train] step " in ln]

    script = tmp_path / "port_train.py"
    script.write_text(PORT_TRAIN)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port",
         str(free_port()), str(script), *common, "--init-checkpoint",
         str(tmp_path / "init.pt"), "--output", str(tmp_path / "out_port"),
         "--data-parallel", "2", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summaries = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
    assert len(summaries) == 1, proc.stdout
    t_sum = summaries[0]
    assert t_sum["devices"] == 2 and t_sum["mesh"] == {"data": 2,
                                                       "model": 1}
    t_losses = [float(ln.split("loss=")[1].split()[0])
                for ln in proc.stderr.splitlines() if "[train] step " in ln]
    assert len(t_losses) == len(j_losses) == 3
    for got, want in zip(t_losses + [t_sum["first_loss"],
                                     t_sum["last_loss"]],
                         j_losses + [j_sum["first_loss"],
                                     j_sum["last_loss"]]):
        assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
    # saves at steps 2 and 3: one checkpoint event each, from rank 0
    assert proc.stderr.count("[train] checkpoint ") == 2, proc.stderr
    assert (tmp_path / "out_port" / "LATEST").read_text().strip() == \
        "step_00000003"
    saved = PT.restore_checkpoint(str(tmp_path / "out_port"))
    assert saved["step"] == 3 and saved["opt_state"]["count"] == 3
